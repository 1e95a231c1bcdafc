// Nearest-centroid assignment: the k-means assignment step of the IVF build.
//
// Replaces the TPU kernel vectordb_retrieval_tpu/ops/pallas_kernels.py
// assign_pallas (body _assign_kernel). For points [N, d], centroids [K, d]
// and cn [K] = ||c||^2, all f32 and row-major, it computes
//
//   dist[n, c] = ||p_n||^2 + cn[c] - 2 * <p_n, c>
//   assign[n]  = argmin_c dist[n, c]      (int64; lowest c among equals)
//   mind[n]    = min_c dist[n, c]
//
// with the same expansion as the TPU kernel. The [N, K] distance matrix
// never reaches device memory: it is a GEMM whose epilogue keeps a running
// (min, argmin) per point in registers.
//
// Design: one thread block owns 128 points and walks the centroids in tiles
// of 128 (any K; the last tile is masked). Each tile is the FFMA tile of
// ffma_tile.cuh that dist_blockmin.cu also runs, each of 256 threads
// accumulating an 8 x 8 sub-tile (8 points x 8 consecutive centroids);
// only the epilogue is this kernel's own. ||p||^2 is summed from the
// staged point values during the first centroid tile. After every tile a
// thread folds its 8 x 8 distances into its per-point (min, argmin), with a
// strict < over ascending centroid ids, so the lowest id wins a tie. At the
// end the 16 lanes of a warp that share the same 8 points reduce with
// shuffles on the lexicographic order of (distance, id): equal distances
// resolve to the lowest centroid id, as jnp.argmin does.
//
// Precision: plain FP32 FFMA, never TF32, as the JAX package's f32 path.
//
// What bounds it on an H100: 2*N*K*d FLOP against (N + K)*d*4 bytes read
// once; at K = 1024 that is ~500 FLOP per byte, far above the FP32 balance
// point, so it is bound by FP32 FFMA throughput (67 TFLOP/s). The points'
// tile is re-read from L2 once per centroid tile, not from device memory.
// Moving the product onto tensor cores is a later step.
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

__global__ void __launch_bounds__(THREADS, 2)
assign_kernel(const float* __restrict__ pts, const float* __restrict__ cents,
              const float* __restrict__ cn, int64_t* __restrict__ assign,
              float* __restrict__ mind, int N, int K, int d) {
  __shared__ __align__(16) vrt::TileSmem sm;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // centroids tx*8 .. tx*8+7 of a tile
  const int ty = tid / (BN / TN);  // points ty*8 .. ty*8+7 of the block
  const int m0 = blockIdx.x * BM;

  const int gp = m0 + vrt::loader_row();
  const bool p_ok = gp < N;
  const float* prow = pts + (size_t)(p_ok ? gp : 0) * d;

  float best_d[TM], pn[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_d[i] = INFINITY;
    best_i[i] = 0;
    pn[i] = 0.f;
  }

  for (int c0 = 0; c0 < K; c0 += BN) {
    const bool first = c0 == 0;
    const int gc = c0 + vrt::loader_row();
    const bool c_ok = gc < K;
    // ||p||^2 from the staged point values, during the first centroid tile
    auto sum_pn = [&](const float (&a)[TM]) {
      if (first) {
#pragma unroll
        for (int i = 0; i < TM; ++i) pn[i] = fmaf(a[i], a[i], pn[i]);
      }
    };
    float acc[TM][TN];
    vrt::ffma_tile<F32, F32>(sm, prow, p_ok, cents + (size_t)(c_ok ? gc : 0) * d,
                             c_ok, d, acc, sum_pn);

    // epilogue: (||p||^2 + ||c||^2) - 2 p.c, folded into the running min;
    // centroids past K get +inf and never win a strict <
    const int cbase = c0 + tx * TN;
    float c2[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      c2[j] = (cbase + j < K) ? __ldg(cn + cbase + j) : INFINITY;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float dist = fmaf(-2.f, acc[i][j], pn[i] + c2[j]);
        if (dist < best_d[i]) {
          best_d[i] = dist;
          best_i[i] = cbase + j;
        }
      }
    }
  }

  // the 16 lanes with this thread's ty (lane % 16 == tx) hold the same
  // points: lexicographic (distance, id) min across them
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float bd = best_d[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 1; off < BN / TN; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int m = m0 + ty * TM + i;
    if (tx == 0 && m < N) {
      assign[m] = bi;
      mind[m] = bd;
    }
  }
}

}  // namespace

extern "C" int vrt_assign_f32(const void* points, const void* centroids,
                              const void* cnorms, void* assign, void* mind,
                              int N, int K, int d, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BM - 1) / BM);
  assign_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(centroids),
      static_cast<const float*>(cnorms), static_cast<int64_t*>(assign),
      static_cast<float*>(mind), N, K, d);
  return static_cast<int>(cudaGetLastError());
}
