// Hopper (sm_90a) building blocks for warp-specialised kernels of the port:
// the Tensor Memory Accelerator (TMA: 2D tiled copies from device memory
// into shared memory, alone or multicast to every CTA of a cluster), the
// shared-memory barriers (mbarrier) that count its bytes and the threads'
// arrivals, the cluster's special registers and barrier, and the register
// hand-over between warpgroups (setmaxnreg). On the host: the encoding of a
// 2D f32 tensor map, reached through the runtime's driver entry point (the
// kernels link no libcuda). matmul_floor.cu (K5) uses them.
//
// Barriers: an mbarrier completes a phase when its pending arrivals reach 0
// and the bytes it expects (expect_tx) have all landed (complete_tx from
// TMA); mbar_wait(bar, parity) returns once the phase of that parity has
// completed, so a fresh barrier passes a wait on parity 1 at once (the
// producer's first pass over an empty ring). A barrier that never completes
// traps after WAIT_TRAP_CYCLES clock cycles (~10 s at the H100's clock)
// instead of hanging the card: the launch then fails with an error.
//
// Tiles: a box of 32 f32 (128 bytes) x R rows lands with the 128-byte
// swizzle (CU_TENSOR_MAP_SWIZZLE_128B), the layout of wgmma.cuh
// (sw128_offset, sw128_desc), on a 1024-byte aligned shared address.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma.cuh"

namespace vrt {

constexpr long long WAIT_TRAP_CYCLES = 1LL << 34;

// ---- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the cluster (and to TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and bytes more for the phase to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// One arrival on the barrier at the same offset in the shared memory of the
// cluster's CTA of rank cta (this CTA's own included). Its release is at the
// CTA's scope: a release at the cluster's would fence every earlier memory
// operation of the thread (its global stores too) at each arrival, and the
// reads it orders (of this CTA's own shared memory) are done by then.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" :: "r"(remote) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_TRAP_CYCLES) __trap();
}

// ---- TMA ---------------------------------------------------------------------

// The box at (c0 inner, c1 outer) of the tensor map -> shared dst; its bytes
// complete_tx on bar. Elements outside the tensor read 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same box into dst of every CTA of the cluster in cta_mask (the same
// offset in each), complete_tx on the barrier at bar's offset in each.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      int c0, int c1, uint32_t bar,
                                                      uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
         "h"(cta_mask)
      : "memory");
}

// ---- clusters and warpgroups -------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster meets here.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The warpgroup's registers a thread drop to / rise to N (every warp of the
// warpgroup executes it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- host: tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2D f32 tensor map over rows x cols (row-major, ld floats a row; base and
// ld * 4 multiples of 16 bytes), box of box_cols x box_rows (box_cols * 4 <=
// 128 bytes, the swizzle span), 128-byte swizzle, elements outside read 0.
inline cudaError_t encode_f32_2d(CUtensorMap* map, const void* base, uint64_t rows,
                                 uint64_t cols, uint64_t ld, uint32_t box_rows,
                                 uint32_t box_cols) {
  memset(map, 0, sizeof(*map));
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * sizeof(float)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace vrt
