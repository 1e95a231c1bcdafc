// Fused distance + per-block minimum over bf16 or u8 payloads on the tensor
// cores (wgmma): the IVF-Flat / IVF-SQ8 fused probed stream and the cover
// tree's block walk.
//
// Replaces the TPU kernel vectordb_retrieval_tpu/ops/pallas_kernels.py
// dist_blockmin_pallas in its bf16 and u8 modes (the f32 mode is
// dist_blockmin.cu). Computes, for one or two pens,
//
//   out[q, g] = min_{j < w} (pen[g*w + j] - 2 * <payload[g*w + j], queries[q]>)
//
// for queries [B, d] bf16, payload [S, d] bf16 or u8, pen [S] f32 (S % w ==
// 0, w a power of two <= 128), out [B, S/w] f32, all row-major. The [B, S]
// score matrix never reaches device memory. The pair entry points apply two
// pens to one product and write two outputs (the cover tree's pens of all
// and of real nodes over one slab), so the slab is read and multiplied once.
//
// Numerics: the queries arrive rounded to bf16; bf16 payload values and u8
// codes 0-255 are exact in bf16, so every product is exact and the sums are
// f32 (wgmma's f32 accumulation, in its own order) - the TPU modes'
// semantics (one bf16 dot with f32 accumulation). pen - 2 * dot rounds once
// (fmaf). A group whose pens are all +inf gives +inf.
//
// What bounds it on an H100: the product is bf16, 2 B S d FLOP against
// S d (bf16: 2 S d) payload bytes, so at B = 256 it does 256 FLOP per bf16
// byte and 512 per u8 byte - near the card's 295 FLOP/byte balance of 989
// TFLOP/s over 3.35 TB/s. The bf16 IVF stream is bound by its bytes, the u8
// stream and the cover tree (B = 512, d = 384) by the tensor cores.
//
// Design: persistent blocks, two per SM, each holding one tile of 128
// queries and walking payload tiles of 128 rows (query tile fastest across
// blocks, so the 2-4 query tiles of one payload tile run side by side and
// the payload comes from HBM about once a launch). Two warpgroups each run
// the wgmma m64n128k16 product of their 64 queries with the 128 rows,
// accumulating in 64 f32 registers a thread. d advances in stages of 64
// (one 128-byte row of the 128B-swizzled K-major layout of wgmma.cuh)
// through a ring of NS stages in shared memory, filled by 16-byte cp.async
// copies that every thread issues NS - 1 stages ahead, across tile
// boundaries (no thread holds staged values in registers); for d <= 256 the
// query tile stays in shared memory and only the payload streams. u8 codes
// are copied raw into the stage and converted to bf16 into the swizzled
// operand tile in shared memory before the product (route (a): one product
// shape and one epilogue for both modes; the conversion is a byte permute
// and an exact f32 subtract per code). Where the rows are not 16-byte
// aligned (bf16: d % 8 != 0; u8: d % 16 != 0) the same kernel fills the
// stage with masked loads and stores instead of copies.
// Epilogue: a thread's accumulator columns are 8i + 2 (lane % 4) + {0, 1};
// the loader puts payload row 32 (lane % 4) + 2i + j of the tile in column
// 8i + 2 (lane % 4) + j (tile_row), so each thread holds 32 consecutive
// payload rows of two query rows, and a group of w rows (the tile holds
// whole groups: 128 % w == 0) is reduced in registers, and for w = 64, 128
// across 2 or 4 lanes of a quad. The tile's pens arrive in shared memory
// with its first stage. The epilogue is compiled for each w; each minimum is
// written once.
//
// Edges: rows >= S and queries >= B read 0 (copies of 0 bytes zero-fill) and
// write nothing; k >= d reads 0 in both operands, which adds exactly 0.
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry points return cudaGetLastError().

#include <limits.h>
#include <math.h>

#include "wgmma.cuh"

namespace {

constexpr int BM = 128;  // queries per block: two warpgroups of 64
constexpr int BN = 128;  // payload rows per block (wgmma N)
constexpr int BK = 64;   // k per stage: 64 bf16 = one 128-byte swizzled row
constexpr int NS = 3;    // ring stages
constexpr int NK_RESIDENT = 4;  // d <= 256: the block's queries stay in shared memory
constexpr int THREADS = 256;
constexpr int RP = THREADS / 8;  // operand rows one pass of 16-byte copies covers
static_assert(BM == 64 * (THREADS / 128), "one warpgroup per 64 queries");
static_assert(BN % (2 * RP) == 0 && RP % 8 == 0, "loader passes cover whole tiles");
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int RAW_BYTES = BN * BK;  // a stage's u8 codes, row-major [BN][BK]

struct Params {
  const uint16_t* q;  // bf16 bits [B, d]
  const void* x;      // bf16 bits or u8 codes [S, d]
  const float* pen[2];
  float* out[2];
  int B, S, d, w, n_qt, nk;
  int vec;  // rows are 16-byte aligned: the stages are filled by cp.async
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// byte i of v (a u8 code) as an exact f32: the bits 0x4B0000bb are
// 2^23 + b, and 2^23 comes off exactly
template <int I>
__device__ __forceinline__ float u8_at(uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 | I)) - 8388608.f;
}

// 4 u8 codes (one byte each of v) -> 2 x bf16x2, exactly
__device__ __forceinline__ uint2 u8x4_to_bf16(uint32_t v) {
  return make_uint2(bf16x2(u8_at<0>(v), u8_at<1>(v)), bf16x2(u8_at<2>(v), u8_at<3>(v)));
}

__device__ __forceinline__ void st_shared_16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ uint2 ld_shared_8(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// The payload row (of the tile's 128) that B-tile row, i.e. accumulator
// column, col holds: thread lane % 4 = c, which holds columns 8i + 2c + j,
// gets rows 32c .. 32c+31 (see epilogue).
__device__ __forceinline__ int tile_row(int col) {
  return ((col >> 1) & 3) * 32 + (col >> 3) * 2 + (col & 1);
}

// One swizzled 16-byte chunk (8 k values from k) of a bf16 row, read with
// masked scalar loads: rows that are not 16-byte aligned.
__device__ __forceinline__ uint4 masked_bf16_chunk(const uint16_t* row, bool ok,
                                                   int k, int d) {
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    h[j] = (ok && k + j < d) ? static_cast<uint32_t>(__ldg(row + k + j)) : 0u;
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                    h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

__device__ __forceinline__ uint4 masked_u8_chunk(const uint8_t* row, bool ok,
                                                 int k, int d) {
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f[j] = (ok && k + j < d) ? static_cast<float>(__ldg(row + k + j)) : 0.f;
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                    bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
}

// The queries' k0 .. k0+63 slice of the block's BM rows -> the swizzled
// tile at a. Thread t copies chunk t % 8 of rows t / 8 + RP i.
__device__ __forceinline__ void load_a(const Params& p, uint32_t a, int m0, int k0) {
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, k = k0 + 8 * c;
  const uint32_t dst = a + vrt::sw128_offset(r, c);  // + RP * 128 i: row r + RP i
  const size_t stride = static_cast<size_t>(RP) * p.d;
  const uint16_t* src = p.q + static_cast<size_t>(m0 + r) * p.d;
#pragma unroll
  for (int i = 0; i < BM / RP; ++i) {
    const bool row_ok = m0 + r + RP * i < p.B;
    if (p.vec) {
      const bool ok = row_ok && k < p.d;
      vrt::cp_async_16(dst + RP * 128 * i, ok ? src + i * stride + k : p.q, ok ? 16 : 0);
    } else {
      st_shared_16(dst + RP * 128 * i,
                   masked_bf16_chunk(row_ok ? src + i * stride : p.q, row_ok, k, p.d));
    }
  }
}

// The payload's k0 .. k0+63 slice of the tile's 128 rows from n0 -> the
// swizzled tile at b, B-tile row r holding payload row n0 + tile_row(r) (u8
// with vec: the raw codes -> raw, converted by convert_stage). Thread t
// copies chunk t % 8 of B-tile rows t / 8 + RP i, which hold payload rows
// n0 + tile_row(t / 8) + (RP / 4) i.
template <bool U8>
__device__ __forceinline__ void load_b(const Params& p, uint32_t b, uint32_t raw, int n0,
                                       int k0) {
  if (U8 && p.vec) {  // 4 chunks of 16 codes a row: rows t / 4 + 2 RP i
    const int r = threadIdx.x >> 2, c = threadIdx.x & 3, k = k0 + 16 * c;
    const int row = n0 + tile_row(r);
    const uint8_t* x = static_cast<const uint8_t*>(p.x);
    const uint8_t* src = x + static_cast<size_t>(row) * p.d + k;
    const size_t stride = static_cast<size_t>(RP / 2) * p.d;
#pragma unroll
    for (int i = 0; i < BN / (2 * RP); ++i) {
      const bool ok = row + (RP / 2) * i < p.S && k < p.d;
      vrt::cp_async_16(raw + r * BK + 16 * c + 2 * RP * BK * i, ok ? src + i * stride : x,
                       ok ? 16 : 0);
    }
    return;
  }
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, k = k0 + 8 * c;
  const int row = n0 + tile_row(r);
  const uint32_t dst = b + vrt::sw128_offset(r, c);
  const size_t stride = static_cast<size_t>(RP / 4) * p.d;
#pragma unroll
  for (int i = 0; i < BN / RP; ++i) {
    const bool row_ok = row + (RP / 4) * i < p.S;
    const size_t off = static_cast<size_t>(row) * p.d + i * stride;
    if (!U8 && p.vec) {
      const uint16_t* x = static_cast<const uint16_t*>(p.x);
      const bool ok = row_ok && k < p.d;
      vrt::cp_async_16(dst + RP * 128 * i, ok ? x + off + k : x, ok ? 16 : 0);
    } else {
      uint4 v;
      if constexpr (U8)
        v = masked_u8_chunk(static_cast<const uint8_t*>(p.x) + (row_ok ? off : 0), row_ok, k,
                            p.d);
      else
        v = masked_bf16_chunk(static_cast<const uint16_t*>(p.x) + (row_ok ? off : 0), row_ok,
                              k, p.d);
      st_shared_16(dst + RP * 128 * i, v);
    }
  }
}

// u8 with vec: the stage's raw codes -> bf16 into its swizzled payload tile
__device__ __forceinline__ void convert_stage(uint32_t sb, uint32_t raw) {
#pragma unroll
  for (int i = 0; i < BN * 8 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS, r = idx >> 3, c = idx & 7;
    const uint2 v = ld_shared_8(raw + r * BK + c * 8);
    const uint2 lo = u8x4_to_bf16(v.x), hi = u8x4_to_bf16(v.y);
    st_shared_16(sb + vrt::sw128_offset(r, c), make_uint4(lo.x, lo.y, hi.x, hi.y));
  }
}

// The pens of n0 .. n0+127 -> pen_s (4-byte copies; rows past S are not
// read, and their groups are never written).
template <int NPEN>
__device__ __forceinline__ void load_pens(const Params& p, uint32_t pen_s, int n0) {
  const int tid = threadIdx.x;
  if (tid < NPEN * BN) {
    const int e = tid / BN, r = tid % BN;
    const bool ok = n0 + r < p.S;
    vrt::cp_async_4(pen_s + tid * 4, ok ? p.pen[e] + n0 + r : p.pen[e], ok ? 4 : 0);
  }
}

// r[t] = min(r[2t], r[2t+1]) for t < N
template <int N>
__device__ __forceinline__ void halve(float (&r)[32]) {
#pragma unroll
  for (int t = 0; t < N; ++t) r[t] = fminf(r[2 * t], r[2 * t + 1]);
}

// pen - 2 * acc, min over w-groups, written once per group (see the note).
// For its query rows q0 and q0 + 8 (h = 0, 1), this thread holds the 32
// consecutive payload rows nb .. nb+31 (nb = n0 + 32 (lane % 4)): row nb + t
// in acc[4 (t / 2) + 2h + t % 2]. pen_s holds the tile's 128 pens in row
// order. W <= 32 reduces in registers; 64 and 128 also across 2 or 4 lanes.
template <int W>
__device__ __forceinline__ void epilogue(const float (&acc)[64], uint32_t pen_s,
                                         float* __restrict__ out, int q0, int n0,
                                         int lane, int B, int S) {
  constexpr int GT = W < 32 ? 32 / W : 1;  // groups a thread writes
  const size_t G = static_cast<size_t>(S / W);
  const int c = lane & 3, nb = n0 + 32 * c;
  // whole groups: past S, all of this thread's rows are (W > 32: its
  // quad partners still shuffle with it)
  if (W <= 32 && nb >= S) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + 8 * h;
    float r[32];
#pragma unroll
    for (int t = 0; t < 32; t += 4) {
      const float4 pv = ld_shared_f4(pen_s + (32 * c + t) * 4);
      r[t] = fmaf(-2.f, acc[2 * t + 2 * h], pv.x);
      r[t + 1] = fmaf(-2.f, acc[2 * t + 2 * h + 1], pv.y);
      r[t + 2] = fmaf(-2.f, acc[2 * t + 4 + 2 * h], pv.z);
      r[t + 3] = fmaf(-2.f, acc[2 * t + 4 + 2 * h + 1], pv.w);
    }
    if constexpr (W >= 2) halve<16>(r);
    if constexpr (W >= 4) halve<8>(r);
    if constexpr (W >= 8) halve<4>(r);
    if constexpr (W >= 16) halve<2>(r);
    if constexpr (W >= 32) halve<1>(r);
    if constexpr (W >= 64) r[0] = fminf(r[0], __shfl_xor_sync(0xffffffffu, r[0], 1));
    if constexpr (W >= 128) r[0] = fminf(r[0], __shfl_xor_sync(0xffffffffu, r[0], 2));
    if (q >= B || (W > 32 && (c & (W / 32 - 1)) != 0)) continue;
    float* o = out + q * G + nb / W;
#pragma unroll
    for (int g = 0; g < GT; ++g)
      if (nb + g * W < S) o[g] = r[g];
  }
}

template <bool U8, int NPEN>
__global__ void __launch_bounds__(THREADS, 2)
dist_blockmin_tc_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int STAGE_B = B_BYTES + (U8 ? RAW_BYTES : 0);
  const uint32_t a_base = (vrt::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nk = p.nk;
  const bool res = nk <= NK_RESIDENT;
  const uint32_t ring = a_base + (res ? nk : NS) * A_BYTES;
  // the pens of the tiles in flight: tile j's in buffer j % NS (a buffer is
  // refilled NS tiles later, after that tile's epilogue)
  const uint32_t pens = ring + NS * STAGE_B;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // this warpgroup's 64 queries: m0 + 64 wg ..
  const int m0 = (blockIdx.x % p.n_qt) * BM;
  // this block's payload tiles: pt0, pt0 + pstride, ... (query tile fixed)
  const int pt0 = blockIdx.x / p.n_qt, pstride = gridDim.x / p.n_qt;
  const int n_pt = (p.S + BN - 1) / BN;
  const int steps = pt0 < n_pt ? ((n_pt - pt0 + pstride - 1) / pstride) * nk : 0;

  // step it: chunk it % nk of the block's tile it / nk, in ring stage it % NS;
  // the copies run NS - 1 steps ahead, at tile ij, chunk ik, stage is
  auto a_tile = [&](int s, int k) { return a_base + (res ? k : s) * A_BYTES; };
  int ij = 0, ik = 0, is = 0;
  auto issue = [&]() {
    const uint32_t b = ring + is * STAGE_B;
    const int n0 = (pt0 + ij * pstride) * BN;
    if (!res || ij == 0) load_a(p, a_tile(is, ik), m0, ik * BK);
    load_b<U8>(p, b, b + B_BYTES, n0, ik * BK);
    if (ik == 0) load_pens<NPEN>(p, pens + (ij % NS) * (NPEN * BN * 4), n0);
    if (++ik == nk) ik = 0, ++ij;
    if (++is == NS) is = 0;
  };

  float acc[64];
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) issue();
    vrt::cp_async_commit();
  }

  const int lane = tid & 31;
  const int q0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  int j = 0, k = 0, s = 0;
  for (int it = 0; it < steps; ++it) {
    vrt::cp_async_wait<NS - 2>();  // this thread's copies of step it landed
    vrt::fence_proxy_async();
    __syncthreads();  // everyone's have; both warpgroups left step it - 1
    if (it + NS - 1 < steps) issue();
    vrt::cp_async_commit();
    const uint32_t b = ring + s * STAGE_B;
    if (U8 && p.vec) {
      convert_stage(b, b + B_BYTES);
      vrt::fence_proxy_async();
      __syncthreads();
    }
    const uint64_t da = vrt::sw128_desc(a_tile(s, k) + wg * (64 * 128));
    const uint64_t db = vrt::sw128_desc(b);
    vrt::fence_operands(acc);
    vrt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // a tile's first product overwrites acc
      vrt::wgmma_m64n128k16_bf16(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
    vrt::wgmma_commit();
    vrt::wgmma_wait<0>();
    vrt::fence_operands(acc);
    if (++s == NS) s = 0;
    if (++k == nk) {  // the tile's product is whole: its minima
#pragma unroll
      for (int e = 0; e < NPEN; ++e) {
        const uint32_t pen_s = pens + ((j % NS) * NPEN + e) * (BN * 4);
        const int n0 = (pt0 + j * pstride) * BN;
        switch (p.w) {
          case 1: epilogue<1>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          case 2: epilogue<2>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          case 4: epilogue<4>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          case 8: epilogue<8>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          case 16: epilogue<16>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          case 32: epilogue<32>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          case 64: epilogue<64>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          default: epilogue<128>(acc, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
        }
      }
      k = 0;
      ++j;
    }
  }
}

template <bool U8, int NPEN>
int launch(const void* q, const void* x, const void* const* pen, void* const* out,
           int B, int S, int d, int w, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w <= 0 || w > BN || (w & (w - 1)) || S % w)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.x = x;
  for (int e = 0; e < 2; ++e) {
    p.pen[e] = static_cast<const float*>(pen[e < NPEN ? e : 0]);
    p.out[e] = static_cast<float*>(out[e < NPEN ? e : 0]);
  }
  p.B = B;
  p.S = S;
  p.d = d;
  p.w = w;
  p.n_qt = (B + BM - 1) / BM;
  p.nk = (d + BK - 1) / BK;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  p.vec = aligned && d % (U8 ? 16 : 8) == 0;
  constexpr int STAGE_B = B_BYTES + (U8 ? RAW_BYTES : 0);
  const int a_tiles = p.nk <= NK_RESIDENT ? p.nk : NS;
  const int smem = a_tiles * A_BYTES + NS * (STAGE_B + NPEN * BN * 4) + 1024;
  auto kernel = dist_blockmin_tc_kernel<U8, NPEN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many blocks as fit on the card, each walking payload
  // tiles of one query tile; the query tiles of a payload tile run together
  const int n_pt = (S + BN - 1) / BN;
  int lanes = (per_sm > 0 ? per_sm : 1) * sms / p.n_qt;
  lanes = lanes < 1 ? 1 : (lanes > n_pt ? n_pt : lanes);
  const long long blocks = static_cast<long long>(p.n_qt) * lanes;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries: bf16 bits [B, d]; payload: bf16 bits [S, d]
extern "C" int vrt_dist_blockmin_bf16(const void* queries, const void* payload,
                                      const void* pen, void* out, int B, int S,
                                      int d, int w, void* stream) {
  const void* pens[1] = {pen};
  void* outs[1] = {out};
  return launch<false, 1>(queries, payload, pens, outs, B, S, d, w, stream);
}

// queries: bf16 bits [B, d]; payload: u8 codes [S, d]
extern "C" int vrt_dist_blockmin_u8(const void* queries, const void* payload,
                                    const void* pen, void* out, int B, int S,
                                    int d, int w, void* stream) {
  const void* pens[1] = {pen};
  void* outs[1] = {out};
  return launch<true, 1>(queries, payload, pens, outs, B, S, d, w, stream);
}

// Two pens over one product: out_a from pen_a, out_b from pen_b.
extern "C" int vrt_dist_blockmin_pair_bf16(const void* queries, const void* payload,
                                           const void* pen_a, const void* pen_b,
                                           void* out_a, void* out_b, int B, int S,
                                           int d, int w, void* stream) {
  const void* pens[2] = {pen_a, pen_b};
  void* outs[2] = {out_a, out_b};
  return launch<false, 2>(queries, payload, pens, outs, B, S, d, w, stream);
}

extern "C" int vrt_dist_blockmin_pair_u8(const void* queries, const void* payload,
                                         const void* pen_a, const void* pen_b,
                                         void* out_a, void* out_b, int B, int S,
                                         int d, int w, void* stream) {
  const void* pens[2] = {pen_a, pen_b};
  void* outs[2] = {out_a, out_b};
  return launch<true, 2>(queries, payload, pens, outs, B, S, d, w, stream);
}

extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
