// Full-L2 per-block minima over interleaved blocks (the fused stage 1 of
// the first blockmin exact search) on the tensor cores (wgmma, 3xTF32).
//
// Replaces the TPU kernel vectordb_retrieval_tpu/ops/pallas_kernels.py
// blockmin_pallas (body _blockmin_kernel). For queries [B, d], database
// [N, d] (f32, row-major) and qn [B] = ||q||^2 it computes
//
//   out[q, t*seg + j] = min_{i < w} (qn[q] + ||x_r||^2 - 2 <x_r, q>),
//   r = t*TILE + i*seg + j,   seg = TILE / w,
//
// with TILE = min(2048, N) and N % TILE == 0 (callers pad with large rows).
// Block j of tile t holds the w rows j, j + seg, ..., j + (w-1)*seg of that
// tile: the TPU kernel's interleaved segments, kept so that its oracle
// applies unchanged. ||x||^2 is summed in f32 from the rows the kernel
// stages; the [B, N] distance matrix never reaches device memory.
//
// Design: the main loop of blockmin_tc.cuh that K1 runs (its L2 mode: the
// same ring, 3xTF32 split and products). A unit is CW columns of one tile
// (CW a power of two, 16 .. 128, at most seg where seg >= 16; columns past
// seg are masked; the widest CW that spreads the units evenly over the
// card) and walks its w members in n-tiles of 128 rows, 128 / CW members an
// n-tile; each thread keeps an elementwise running minimum of its 64
// distances in registers (no atomics, no cross-thread reduction where
// CW = 128), and the members that share an n-tile meet in registers and
// across the quad at the unit's end.
//
// Precision: 3xTF32 products (f32-class, ~2^-21 relative each), at least
// as exact as the TPU kernel's Precision.HIGHEST product.
//
// What bounds it on an H100: three TF32 products, 6 B N d FLOP at 495
// TFLOP/s, against (B + N) d 4 bytes read once; at B = 256 that is 384 FLOP
// per database byte, so it is bound by the tensor cores' TF32 rate. Each
// thread holds two sets of 64 registers (the dots and the running minima),
// and the tf32 stages take one block an SM.
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError().

#include "blockmin_tc.cuh"

// queries [B, d], database [N, d], qn [B] f32; out [B, N / w] f32
extern "C" int vrt_blockmin_f32(const void* queries, const void* database,
                                const void* qn, void* out, int B, int N, int d,
                                int w, int tile, void* stream) {
  namespace btc = vrt::btc;
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w <= 0 || (w & (w - 1)) || tile <= 0 || N % tile != 0 || tile % w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  btc::Params p = {};
  p.q = queries;
  p.x = database;
  p.pen[0] = p.pen[1] = static_cast<const float*>(qn);
  p.out[0] = p.out[1] = static_cast<float*>(out);
  p.B = B;
  p.S = N;
  p.d = d;
  p.w = w;
  p.tile = tile;
  p.seg = tile / w;
  return btc::launch<btc::Mode::L2, 1>(p, stream);
}

extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
