// Nearest-centroid assignment: the k-means assignment step of the IVF and
// graph builds (K3), on the tensor cores (wgmma, 3xTF32).
//
// Replaces the TPU kernel vectordb_retrieval_tpu/ops/pallas_kernels.py
// assign_pallas (body _assign_kernel). For points [N, d], centroids [K, d]
// and cn [K] = ||c||^2, all f32 and row-major, it computes
//
//   dist[n, c] = ||p_n||^2 + cn[c] - 2 * <p_n, c>
//   assign[n]  = argmin_c dist[n, c]      (int64; lowest c among equals)
//   mind[n]    = min_c dist[n, c]
//
// with the same expansion as the TPU kernel (fmaf(-2, dot, pn + cn)). The
// [N, K] distance matrix never reaches device memory: it is a GEMM whose
// epilogue keeps a running (min, argmin) per point in registers.
//
// Design: the ASSIGN mode of the persistent kernel in blockmin_tc.cuh (the
// main loop of K1 f32 and K4). A block holds 128 points as its query tile
// and walks all ceil(K/128) centroid n-tiles; every block walks such units
// of points (7,813 at N = 1M), so the points come from device memory once
// and the centroids (512 KB at K = 1024, d = 128) from L2. At d = 128 the
// four 32-deep chunks of the point tile stay in shared memory across the
// unit's n-tiles. ||p||^2 is summed in f32 from the staged raw point values
// while they are split. After each n-tile a thread folds its 32 centroid
// columns of its two points into a running (min, id) with a strict < over
// ascending ids; at the unit's end the four lanes of a quad meet on the
// lexicographic order of (distance, id), so equal distances resolve to the
// lowest centroid id, as jnp.argmin does. No atomics, no second pass,
// deterministic.
//
// Precision: 3xTF32 (each staged value split into tf32 big + small, three
// products of 8-deep slices), each stage's products in a fresh accumulator
// added into a running f32 sum: f32-class products, at least as fine as
// the reference's f32 dot. Never plain TF32, never bf16: assignments feed
// every list the IVF and graph builds make.
//
// What bounds it on an H100: three TF32 products, 6 N K d FLOP at 495
// TFLOP/s (1.589 ms at 1M x 1024 x 128; all operations at the FP32 rate,
// 67 TFLOP/s, would take 3.913), against (N + K) d 4 bytes read once (0.157
// ms): bound by the tensor cores' TF32 rate. One block an SM (the tf32
// stages and the resident point tile take 227 KB).
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError().

#include "blockmin_tc.cuh"

extern "C" int vrt_assign_f32(const void* points, const void* centroids,
                              const void* cnorms, void* assign, void* mind,
                              int N, int K, int d, void* stream) {
  namespace btc = vrt::btc;
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  btc::Params p = {};
  p.q = points;
  p.x = centroids;
  p.pen[0] = p.pen[1] = static_cast<const float*>(cnorms);
  p.out[0] = p.out[1] = static_cast<float*>(mind);
  p.ids = static_cast<int64_t*>(assign);
  p.B = N;
  p.S = K;
  p.d = d;
  p.w = 1;
  p.n_units = (N + btc::BM - 1) / btc::BM;
  p.per_unit = (K + btc::BN - 1) / btc::BN;
  return btc::launch<btc::Mode::ASSIGN, 1>(p, stream);
}

extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
