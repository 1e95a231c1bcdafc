// Hopper (sm_90a) building blocks for tensor-core kernels of the port:
// 16-byte asynchronous copies into shared memory (cp.async), 16-byte
// shared-memory loads and stores, the tf32 rounding of the 3xTF32 split, the
// 128-byte swizzled K-major operand layout that wgmma reads, its
// shared-memory matrix descriptor, the wgmma fences, and the m64n128
// products with f32 accumulators: bf16 operands (k16) and tf32 operands (k8),
// and m64n64 over tf32 with A from registers. blockmin_tc.cuh and
// matmul_floor.cu use them.
//
// Operand tiles: R rows of 128 bytes each (64 bf16 or 32 f32/tf32 values,
// the k-extent of one pipeline stage), stored as 8-row atoms of 1024 bytes.
// The 16-byte chunk c of row r sits at byte r * 128 + ((c ^ (r % 8)) * 16)
// of the tile (sw128_offset), the layout that CU_TENSOR_MAP_SWIZZLE_128B
// writes and that a descriptor with layout type 1 (128B swizzle) names.
// Tiles start on 1024-byte boundaries. One wgmma consumes 32 bytes of k (16
// bf16 or 8 tf32); the k-th such slice of a tile is addressed by adding
// 2 * k (32 bytes in 16-byte units) to the descriptor.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vrt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies ----------------------------------------------------

// Copies src_bytes (0 or 16) from global src to shared dst and zero-fills
// the rest of the 16 bytes; with src_bytes == 0 nothing is read.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The same for 4 bytes (src_bytes 0 or 4), through L1.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Orders this thread's earlier shared-memory writes (stores, cp.async)
// before later reads by the async proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- shared memory and the tf32 split ---------------------------------------

__device__ __forceinline__ void st_shared_16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// v rounded to tf32 (cvt.rna.tf32.f32: the low 13 bits zero, ties away from
// zero), as f32 bits
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// ---- the 128B-swizzled K-major layout ---------------------------------------

__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// Descriptor of a K-major, 128B-swizzled operand tile at shared address
// addr (1024-byte aligned): start address >> 4 in bits 0-13, leading byte
// offset 1 (not used by a swizzled K-major tile), stride byte offset 1024 >> 4
// between 8-row atoms in bits 32-45, layout type 1 (128B swizzle) in bits
// 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  desc |= static_cast<uint64_t>(1) << 16;
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;
  desc |= static_cast<uint64_t>(1) << 62;
  return desc;
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// this point (wgmma writes them asynchronously, between its issue and
// wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define VRT_ACC64(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),        \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),        \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),        \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define VRT_ACC64_REGS                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}, "

// d = A (64 x 16, K-major in shared memory) * B (128 x 16, K-major in
// shared memory)^T + (accumulate ? d : 0) for one warpgroup, bf16 operands,
// f32 accumulators.
// Thread t of the warpgroup holds d[4i + 2h + j] = D[16 (t / 32) + (t % 32) / 4
// + 8h][8i + 2 (t % 4) + j] for i < 16, h, j in {0, 1}.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b,
                                                      bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VRT_ACC64_REGS
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VRT_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(static_cast<int>(accumulate)));
}

// The same product over 8 k of tf32 operands (f32 words whose low 13 bits
// the tensor core ignores; both operands K-major, so the instruction takes
// no transpose immediates). The accumulator layout is the bf16 product's.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b,
                                                     bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VRT_ACC64_REGS
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : VRT_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(static_cast<int>(accumulate)));
}

#define VRT_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d = A (64 x 8 tf32, from registers) * B (64 x 8, K-major in shared
// memory)^T + (accumulate ? d : 0), f32 accumulators: thread t of the
// warpgroup holds a = {A[r][c], A[r + 8][c], A[r][c + 4], A[r + 8][c + 4]}
// for r = 16 (t / 32) + (t % 32) / 4, c = t % 4, and d[4i + 2h + j] =
// D[r + 8h][8i + 2c + j] for i < 8. The registers of a are read while the
// product runs: they must not change before wgmma_wait.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : VRT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(static_cast<int>(accumulate)));
}

#undef VRT_ACC32
#undef VRT_ACC64_REGS
#undef VRT_ACC64

}  // namespace vrt
