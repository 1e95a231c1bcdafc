// The FP32 FFMA tile of the port's CUDA kernels that do not run on the
// tensor cores: assign.cu adds its epilogue to it; slab_dots.cu uses only the
// element loaders and the error-string entry point.
//
// One thread block computes the 128 x 128 dot products of 128 rows of an
// operand A against 128 rows of an operand B, both row-major [rows, d]. The
// d loop stages 16-deep slices of both operands in shared memory
// (double-buffered: the next slice is prefetched into registers while the
// current one is consumed). Loader: thread tid stages 8 consecutive k of
// row tid / 2 (loader_row()) of each operand, at k offset (tid % 2) * 8,
// widened to f32 by the operand's element type; a row the caller marks
// invalid and k >= d read 0. Each of the 256 threads accumulates an 8 x 8
// sub-tile, A rows ty*8 .. ty*8+7 against B rows tx*8 .. tx*8+7
// (tx = tid % 16, ty = tid / 16), with plain FP32 FFMA, never TF32.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace vrt {

constexpr int BM = 128;  // A rows per tile
constexpr int BN = 128;  // B rows per tile
constexpr int BK = 16;   // depth of one shared-memory stage
constexpr int TM = 8;    // A rows per thread
constexpr int TN = 8;    // consecutive B rows per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

static_assert(THREADS == 256, "loader mapping assumes 256 threads");
static_assert(BM == 128 && BN == 128 && BK == 16,
              "loader mapping: 2 threads x 8 values per row and stage");

// Stored element types and their exact widening to f32.
struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(const T* p) { return __ldg(p); }
};
struct BF16 {  // the 16 raw bits of a bfloat16
  using T = uint16_t;
  static __device__ __forceinline__ float load(const T* p) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
  }
};

// The two double-buffered stages of both operands, k-major.
struct TileSmem {
  float a[2][BK][BM];
  float b[2][BK][BN];
};

// The row of each operand's tile that this thread loads.
__device__ __forceinline__ int loader_row() { return threadIdx.x >> 1; }

// acc[i][j] = <A row ty*8+i, B row tx*8+j> of the tile whose loader rows
// are a_row / b_row (read only where a_ok / b_ok). on_a(a) sees this
// thread's 8 A values of every k step (for sums over A such as ||p||^2).
// Ends with a barrier after its last shared-memory read, so the caller may
// call it again at once for the next tile.
template <class AT, class BT, class OnA>
__device__ __forceinline__ void ffma_tile(TileSmem& sm,
                                          const typename AT::T* a_row, bool a_ok,
                                          const typename BT::T* b_row, bool b_ok,
                                          int d, float (&acc)[TM][TN], OnA on_a) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int lr = loader_row();
  const int lk = (tid & 1) * 8;

  float ra[8], rb[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + lk + j;
      ra[j] = (a_ok && k < d) ? AT::load(a_row + k) : 0.f;
      rb[j] = (b_ok && k < d) ? BT::load(b_row + k) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sm.a[buf][lk + j][lr] = ra[j];
      sm.b[buf][lk + j][lr] = rb[j];
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (d + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[cur][kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[cur][kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[cur][kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[cur][kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      on_a(a);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // buffer cur ^ 1 was last read in step t - 1, before that step's barrier
    if (t + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

}  // namespace vrt

// Each shared library built from a source that includes this header exports
// its own copy (one library per source, loaded with ctypes).
extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
