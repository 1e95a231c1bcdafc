// Block-slab dot products: the graph beam's wave probe (K2).
//
// Replaces the TPU kernels vectordb_retrieval_tpu/ops/pallas_kernels.py
// slab_dots_manual (manual-DMA ring) and slab_dots_pallas (per-spec
// pipeline), which share one contract. For queries [B, d] f32, member slabs
// list_vecs [Nb, L, d] (f32, or the raw 16 bits of bf16) and the popped
// block ids sel [B, W] int32, it computes
//
//   dots[b, w, l] = <list_vecs[sel[b, w], l, :], queries[b, :]>
//
// into dots [B, W, L] f32, all row-major.
//
// Precision: every stored value is widened to f32 exactly (bf16 by a 16-bit
// shift, as ffma_tile.cuh's loader does) and multiplied by the f32 query
// with plain FP32 FFMA, summed in f32. That is the f32 query against the
// stored values, at least as exact as both TPU routes (HIGHEST for f32
// slabs, a split q_hi + q_lo query in two exact bf16 passes for bf16).
//
// Design: a batched GEMV over gathered contiguous slabs. One thread block
// (256 threads) owns one query and a run of its W popped slabs; the query
// sits in shared memory. Each row of a slab is read by a group of LPR
// lanes (a power of two, at most 32, about one 16-byte load per lane and
// row) with 16-byte vector loads along d where the layout allows it
// (d * itemsize % 16 == 0 and an aligned base) and scalar loads otherwise,
// then summed with warp shuffles inside the group. Any B, W, L and d works;
// duplicate ids in a row are read twice.
//
// What bounds it on an H100: 2 FLOP per stored element read, so it is bound
// by bytes. Each (query, slab) pair reads its slab once, from L2 or device
// memory: nothing here shares a slab read between the queries that popped
// the same block. The least bytes are the DISTINCT selected slabs plus
// queries and output; regrouping queries by block (one slab read serving
// many queries, as a tensor-core product) and staging slabs through
// cp.async/TMA are the later steps.
//
// Edges: an id outside [0, Nb) is not read; its L outputs are NaN, so a
// caller that forgot to clamp sees it at once.
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry points return cudaGetLastError().

#include <math.h>

#include "ffma_tile.cuh"

namespace {

using vrt::BF16;
using vrt::F32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_BLOCK = 1024;  // slabs per thread block ~ this / L

// VEC stored elements per 16-byte load, widened to f32.
template <class XT, int VEC>
struct Vec;

template <>
struct Vec<F32, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};

template <>
struct Vec<BF16, 8> {
  static __device__ __forceinline__ void load(const uint16_t* p, float (&v)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little endian: element 2i in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// VEC > 1: 16-byte loads (caller guarantees d % VEC == 0 and alignment);
// VEC == 1: one element per load.
template <class XT, int VEC>
__global__ void __launch_bounds__(THREADS)
slab_dots_kernel(const float* __restrict__ q, const typename XT::T* __restrict__ x,
                 const int* __restrict__ sel, float* __restrict__ out, int W,
                 int L, int d, int Nb, int slabs_per_block, int lpr) {
  extern __shared__ __align__(16) float qs[];
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += THREADS) qs[k] = q[(size_t)b * d + k];
  __syncthreads();

  const int w0 = blockIdx.y * slabs_per_block;
  const int w1 = min(W, w0 + slabs_per_block);
  const int rows = (w1 - w0) * L;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rpw = 32 / lpr;          // rows a warp reads at once
  const int sub = lane / lpr;        // this lane's row among them
  const int li = lane % lpr;         // this lane's place in its row group

  for (int r0 = warp * rpw; r0 < rows; r0 += WARPS * rpw) {
    const int r = r0 + sub;
    float acc = 0.f;
    int w = 0, l = 0;
    bool ok = r < rows;
    if (ok) {
      const int wl = r / L;
      l = r - wl * L;
      w = w0 + wl;
      const int slab = __ldg(sel + (size_t)b * W + w);
      if (slab < 0 || slab >= Nb) {
        acc = __int_as_float(0x7fc00000);  // NaN: the id was not clamped
      } else {
        const typename XT::T* row = x + ((size_t)slab * L + l) * (size_t)d;
        if constexpr (VEC > 1) {
          for (int k = li * VEC; k < d; k += lpr * VEC) {
            float v[VEC];
            Vec<XT, VEC>::load(row + k, v);
            const float4* qv = reinterpret_cast<const float4*>(qs + k);
#pragma unroll
            for (int j = 0; j < VEC / 4; ++j) {
              const float4 qq = qv[j];
              acc = fmaf(v[4 * j], qq.x, acc);
              acc = fmaf(v[4 * j + 1], qq.y, acc);
              acc = fmaf(v[4 * j + 2], qq.z, acc);
              acc = fmaf(v[4 * j + 3], qq.w, acc);
            }
          }
        } else {
          for (int k = li; k < d; k += lpr) acc = fmaf(XT::load(row + k), qs[k], acc);
        }
      }
    }
    // every lane of the warp reaches the shuffles; xor partners below lpr
    // stay inside this lane's row group
    for (int off = lpr / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (ok && li == 0) out[((size_t)b * W + w) * L + l] = acc;
  }
}

int lanes_per_row(int loads_per_row) {
  int lpr = 1;
  while (lpr < 32 && lpr < loads_per_row) lpr <<= 1;
  return lpr;
}

template <class XT, int VEC>
int launch(const void* q, const void* x, const void* sel, void* out, int B,
           int W, int L, int d, int Nb, void* stream) {
  if (B <= 0 || W <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || Nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int spb = ROWS_PER_BLOCK / L;
  spb = spb < 1 ? 1 : (spb > W ? W : spb);
  const int groups = (W + spb - 1) / spb;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int lpr = lanes_per_row((d + VEC - 1) / VEC);
  const dim3 grid(B, groups);
  slab_dots_kernel<XT, VEC><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const typename XT::T*>(x),
      static_cast<const int*>(sel), static_cast<float*>(out), W, L, d, Nb, spb,
      lpr);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// list_vecs: f32 [Nb, L, d]
extern "C" int vrt_slab_dots_f32(const void* queries, const void* list_vecs,
                                 const void* sel, void* out, int B, int W,
                                 int L, int d, int Nb, void* stream) {
  if (d % 4 == 0 && aligned16(list_vecs))
    return launch<F32, 4>(queries, list_vecs, sel, out, B, W, L, d, Nb, stream);
  return launch<F32, 1>(queries, list_vecs, sel, out, B, W, L, d, Nb, stream);
}

// list_vecs: bf16 bits [Nb, L, d]
extern "C" int vrt_slab_dots_bf16(const void* queries, const void* list_vecs,
                                  const void* sel, void* out, int B, int W,
                                  int L, int d, int Nb, void* stream) {
  if (d % 8 == 0 && aligned16(list_vecs))
    return launch<BF16, 8>(queries, list_vecs, sel, out, B, W, L, d, Nb, stream);
  return launch<BF16, 1>(queries, list_vecs, sel, out, B, W, L, d, Nb, stream);
}
