// Fused distance + per-block minimum over f32, bf16 or u8 payloads
// (exact-search stage 1 and the IVF fused probed stream).
//
// Replaces the TPU kernel vectordb_retrieval_tpu/ops/pallas_kernels.py
// dist_blockmin_pallas in all three of its payload modes. Computes
//
//   out[q, g] = min_{j < w} (pen[g*w + j] - 2 * <payload[g*w + j], queries[q]>)
//
// for queries [B, d], payload [S, d], pen [S] (S % w == 0), out [B, S/w],
// all row-major. The [B, S] score matrix never reaches device memory: each
// block keeps its scores in registers and writes only the minima of w
// consecutive payload rows.
//
// Modes (entry points below):
//   f32  - f32 queries, f32 payload (exact search, f32 IVF lists);
//   bf16 - bf16 queries, bf16 payload (IVF-Flat's default lists);
//   u8   - bf16 queries (the SQ8 pre-scaled queries), u8 codes (IVF-SQ8).
// The loader widens every stored value to f32 on its way into shared
// memory: bf16 -> f32 is a 16-bit shift and u8 -> f32 is exact, so each
// product of a bf16 query value with a bf16 or u8 payload value is exact in
// f32 and only the f32 sums round - the TPU modes' semantics (one bf16 dot
// with f32 accumulation).
//
// Design: one thread block owns a 128-query x 128-row tile, computed by the
// shared FFMA tile of ffma_tile.cuh (each of 256 threads accumulates an
// 8 x 8 sub-tile). Every thread owns 8 consecutive payload rows, so a w-group
// (w a power of two up to 128, and 128 % w == 0 keeps every group inside
// one tile) is reduced in registers (w <= 8) or across the w/8 neighbouring
// lanes of a warp with shuffles (w > 8).
//
// Precision: plain FP32 FFMA, never TF32. In f32 mode that is at least as
// accurate as the TPU kernel's 3-pass bf16 hi/lo split (Precision.HIGH
// equivalent), which is what ranks the blocks for the exact rescore that
// follows.
//
// What bounds it on an H100: at B = 256 the kernel does 2*B/4 = 128 FLOP per
// f32 payload byte it reads (256 per bf16 byte, 512 per u8 byte), far above
// the card's ~20 FLOP/byte FP32 balance point, so it is bound by FP32 FFMA
// throughput (67 TFLOP/s), not memory. The bf16 and u8 modes do a bf16
// product, whose ceiling is the tensor cores' 989 TFLOP/s; running them on
// FFMA leaves that gap open. Moving the product onto tensor cores (wgmma;
// a bf16x3 split for f32) is the next step for this kernel.
//
// Edges: rows >= S and queries >= B are masked here (loads read 0, scores
// are +inf, nothing is written), so the caller pads nothing beyond
// S % w == 0. A group whose slots are all dead (pen = +inf) yields +inf.
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry points return cudaGetLastError().

#include <math.h>

#include "ffma_tile.cuh"

namespace {

using vrt::BF16;
using vrt::BM;
using vrt::BN;
using vrt::F32;
using vrt::THREADS;
using vrt::TM;
using vrt::TN;
using vrt::U8;

template <int W, class QT, class XT>
__global__ void __launch_bounds__(THREADS, 2)
dist_blockmin_kernel(const typename QT::T* __restrict__ q,
                     const typename XT::T* __restrict__ x,
                     const float* __restrict__ pen,
                     float* __restrict__ out,
                     int B, int S, int d) {
  static_assert(W >= 1 && W <= 128 && (W & (W - 1)) == 0,
                "w must be a power of two <= 128");
  __shared__ __align__(16) vrt::TileSmem sm;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // payload rows tx*8 .. tx*8+7 of the tile
  const int ty = tid / (BN / TN);  // queries ty*8 .. ty*8+7 of the tile
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  const int gq = m0 + vrt::loader_row();
  const int gx = n0 + vrt::loader_row();
  const bool q_ok = gq < B;
  const bool x_ok = gx < S;
  float acc[TM][TN];
  vrt::ffma_tile<QT, XT>(sm, q + (size_t)(q_ok ? gq : 0) * d, q_ok,
                         x + (size_t)(x_ok ? gx : 0) * d, x_ok, d, acc,
                         [](const float (&)[TM]) {});

  // Epilogue: score = pen - 2 * dot (+inf past S), min over w-groups.
  const int nbase = n0 + tx * TN;
  const int G = S / W;
  float p[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j)
    p[j] = (nbase + j < S) ? __ldg(pen + nbase + j) : INFINITY;

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = fmaf(-2.f, acc[i][j], p[j]);
    if constexpr (W <= TN) {
#pragma unroll
      for (int g = 0; g < TN / W; ++g) {
        float mn = v[g * W];
#pragma unroll
        for (int j = 1; j < W; ++j) mn = fminf(mn, v[g * W + j]);
        const int n = nbase + g * W;
        if (m < B && n < S) out[(size_t)m * G + n / W] = mn;
      }
    } else {
      float mn = v[0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mn = fminf(mn, v[j]);
      // lanes tx .. tx + W/8 - 1 hold one group; lane % 16 == tx, so the
      // xor partners below share this thread's query rows
#pragma unroll
      for (int off = 1; off < W / TN; off <<= 1)
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      if (tx % (W / TN) == 0 && m < B && nbase < S)
        out[(size_t)m * G + nbase / W] = mn;
    }
  }
}

template <int W, class QT, class XT>
void launch(const void* q, const void* x, const float* pen, float* out,
            int B, int S, int d, cudaStream_t stream) {
  const dim3 grid((S + BN - 1) / BN, (B + BM - 1) / BM);
  dist_blockmin_kernel<W, QT, XT><<<grid, THREADS, 0, stream>>>(
      static_cast<const typename QT::T*>(q),
      static_cast<const typename XT::T*>(x), pen, out, B, S, d);
}

template <class QT, class XT>
int dispatch(const void* q, const void* x, const void* pen, void* out, int B,
             int S, int d, int w, void* stream) {
  const float* p = static_cast<const float*>(pen);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w <= 0 || S % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (w) {
    case 1: launch<1, QT, XT>(q, x, p, o, B, S, d, st); break;
    case 2: launch<2, QT, XT>(q, x, p, o, B, S, d, st); break;
    case 4: launch<4, QT, XT>(q, x, p, o, B, S, d, st); break;
    case 8: launch<8, QT, XT>(q, x, p, o, B, S, d, st); break;
    case 16: launch<16, QT, XT>(q, x, p, o, B, S, d, st); break;
    case 32: launch<32, QT, XT>(q, x, p, o, B, S, d, st); break;
    case 64: launch<64, QT, XT>(q, x, p, o, B, S, d, st); break;
    case 128: launch<128, QT, XT>(q, x, p, o, B, S, d, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vrt_dist_blockmin_f32(const void* queries, const void* payload,
                                     const void* pen, void* out, int B, int S,
                                     int d, int w, void* stream) {
  return dispatch<F32, F32>(queries, payload, pen, out, B, S, d, w, stream);
}

// queries: bf16 bits [B, d]; payload: bf16 bits [S, d]
extern "C" int vrt_dist_blockmin_bf16(const void* queries, const void* payload,
                                      const void* pen, void* out, int B, int S,
                                      int d, int w, void* stream) {
  return dispatch<BF16, BF16>(queries, payload, pen, out, B, S, d, w, stream);
}

// queries: bf16 bits [B, d]; payload: u8 codes [S, d]
extern "C" int vrt_dist_blockmin_u8(const void* queries, const void* payload,
                                    const void* pen, void* out, int B, int S,
                                    int d, int w, void* stream) {
  return dispatch<BF16, U8>(queries, payload, pen, out, B, S, d, w, stream);
}
