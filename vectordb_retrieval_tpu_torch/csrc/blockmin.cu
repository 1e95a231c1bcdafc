// Full-L2 per-block minima over interleaved blocks (the fused stage 1 of
// the first blockmin exact search).
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
// applies unchanged. ||x||^2 is summed from the rows the kernel loads; the
// [B, N] distance matrix never reaches device memory.
//
// Design: one thread block owns 128 queries and C block columns of one
// tile, C = min(128, seg) rounded down to a power of two (at least 8; the
// columns past seg are masked). It walks the w rows of its columns in FFMA
// tiles of ffma_tile.cuh: each tile stages 128 database rows, the 128 / C
// consecutive members i of C columns, and each thread keeps a running
// minimum of its 8 x 8 distances in registers (no atomics). Where C < 128 the
// members of one column sit in the lanes tx, tx ^ (C/8), ... of a warp and
// meet with shuffles at the end; the lanes of the first member write.
//
// Precision: plain FP32 FFMA, never TF32: at least as exact as the TPU
// kernel's Precision.HIGHEST product.
//
// What bounds it on an H100: 2*B*N*d FLOP against (B + N)*d*4 bytes read
// once; at B = 256 that is 128 FLOP per database byte, far above the FP32
// balance point, so it is bound by FP32 FFMA throughput (67 TFLOP/s). Each
// thread holds two 8 x 8 register tiles (the dots and the running minima),
// so a block takes a whole SM's register file share of one block.
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError().

#include <math.h>

#include "ffma_tile.cuh"

namespace {

using vrt::BM;
using vrt::BN;
using vrt::F32;
using vrt::THREADS;
using vrt::TM;
using vrt::TN;

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
blockmin_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const float* __restrict__ qn, float* __restrict__ out, int B,
                int d, int tile, int seg, int w, int col_chunks) {
  static_assert(C >= TN && C <= BN && (C & (C - 1)) == 0,
                "C must be a power of two in [8, 128]");
  constexpr int P = BN / C;  // members of a column staged per FFMA tile
  __shared__ __align__(16) vrt::TileSmem sm;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // staged rows tx*8 .. tx*8+7
  const int ty = tid / (BN / TN);  // queries ty*8 .. ty*8+7 of the tile
  const int t = blockIdx.x / col_chunks;
  const int c0 = (blockIdx.x % col_chunks) * C;
  const int m0 = blockIdx.y * BM;
  const size_t tile0 = static_cast<size_t>(t) * tile;
  const int G = (gridDim.x / col_chunks) * seg;  // N / w

  const int gq = m0 + vrt::loader_row();
  const bool q_ok = gq < B;
  const float* qrow = q + static_cast<size_t>(q_ok ? gq : 0) * d;

  float qv[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    qv[i] = m < B ? __ldg(qn + m) : 0.f;
  }
  float run[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) run[i][j] = INFINITY;

  // staged row r of a tile is column c0 + r % C, member it*P + r / C
  const int lr = vrt::loader_row();
  const int r0 = tx * TN;  // this thread's first staged row (one member)
  const int col = c0 + r0 % C;
  const int iters = (w + P - 1) / P;
  for (int it = 0; it < iters; ++it) {
    const int lcol = c0 + lr % C;
    const int lmem = it * P + lr / C;
    const bool x_ok = lcol < seg && lmem < w;
    const float* xrow =
        x + (x_ok ? tile0 + static_cast<size_t>(lmem) * seg + lcol : 0) * d;
    float xn[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) xn[j] = 0.f;
    auto sum_xn = [&](const float (&b)[TN]) {
#pragma unroll
      for (int j = 0; j < TN; ++j) xn[j] = fmaf(b[j], b[j], xn[j]);
    };
    float acc[TM][TN];
    vrt::ffma_tile<F32, F32>(sm, qrow, q_ok, xrow, x_ok, d, acc, vrt::NoHook(),
                             sum_xn);
    const bool mem_ok = it * P + r0 / C < w;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const bool ok = mem_ok && col + j < seg;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float v = fmaf(-2.f, acc[i][j], qv[i] + xn[j]);
        run[i][j] = ok ? fminf(run[i][j], v) : run[i][j];
      }
    }
  }

  // the members of one column staged together meet across lanes
#pragma unroll
  for (int off = C / TN; off < BN / TN; off <<= 1)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        run[i][j] = fminf(run[i][j], __shfl_xor_sync(0xffffffffu, run[i][j], off));

  if (r0 >= C) return;  // not the first member's lanes
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (col + j < seg)
        out[static_cast<size_t>(m) * G + static_cast<size_t>(t) * seg + col + j] =
            run[i][j];
  }
}

template <int C>
void launch(const float* q, const float* x, const float* qn, float* out, int B,
            int N, int d, int w, int tile, cudaStream_t stream) {
  const int seg = tile / w;
  const int col_chunks = (seg + C - 1) / C;
  const dim3 grid((N / tile) * col_chunks, (B + BM - 1) / BM);
  blockmin_kernel<C><<<grid, THREADS, 0, stream>>>(q, x, qn, out, B, d, tile,
                                                   seg, w, col_chunks);
}

}  // namespace

// queries [B, d], database [N, d], qn [B] f32; out [B, N / w] f32
extern "C" int vrt_blockmin_f32(const void* queries, const void* database,
                                const void* qn, void* out, int B, int N, int d,
                                int w, int tile, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w <= 0 || (w & (w - 1)) || tile <= 0 || N % tile != 0 ||
      tile % w != 0 || (B + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(queries);
  const float* x = static_cast<const float*>(database);
  const float* n2 = static_cast<const float*>(qn);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int seg = tile / w;
  if (seg >= 128) launch<128>(q, x, n2, o, B, N, d, w, tile, st);
  else if (seg >= 64) launch<64>(q, x, n2, o, B, N, d, w, tile, st);
  else if (seg >= 32) launch<32>(q, x, n2, o, B, N, d, w, tile, st);
  else if (seg >= 16) launch<16>(q, x, n2, o, B, N, d, w, tile, st);
  else launch<8>(q, x, n2, o, B, N, d, w, tile, st);
  return static_cast<int>(cudaGetLastError());
}
