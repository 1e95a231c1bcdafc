// Block-slab dot products: the graph beam's wave probe (K2), regrouped by
// popped slab and run on the tensor cores (wgmma).
//
// Replaces the TPU kernels vectordb_retrieval_tpu/ops/pallas_kernels.py
// slab_dots_manual (manual-DMA ring) and slab_dots_pallas (per-spec
// pipeline), which share one contract. For queries [B, d] f32, member slabs
// list_vecs [Nb, L, d] (f32, or the raw 16 bits of bf16) and the popped
// block ids sel [B, W] int32, it computes
//
//   dots[b, w, l] = <list_vecs[sel[b, w], l, :], queries[b, :]>
//
// into dots [B, W, L] f32, all row-major. Pair p = b W + w owns out row p.
//
// What bounds it on an H100: 2 FLOP per stored element of each (query, slab)
// pair. Read per pair, the slabs of one surrogate wave (512 x 96 pairs of
// 128 x 384 bf16) are 4.83 GB, 1.44 ms at 3.35 TB/s; but the ~782 distinct
// slabs plus queries and output are ~103 MB (0.031 ms), and the products,
// even three times over, take 0.015 ms on the tensor cores. So the design
// reads each distinct popped slab once and multiplies it by every query
// that popped it, as one tensor-core product.
//
// Design, four launches on the caller's stream, none of them synchronising
// with the host (every size is static):
//   1. prep: a counting sort's histogram over the B W pairs, keyed by slab
//      (ids outside [0, Nb) get their own key Nb), each pair taking its rank
//      in its bucket (warp-aggregated atomics: the ranks' order varies from
//      run to run, but no output depends on it); and the query split (below)
//      into pieces [PIECES, B, d].
//   2. scan (one block): the buckets' exclusive sums, and each bucket cut
//      into work items (slab, first pair, count <= NQ = 128): at most
//      ceil(B W / NQ) + Nb items, so the pad slab that the beam clamps
//      stale pops to (thousands of pairs a wave) spreads over many blocks.
//   3. scatter: the pairs in bucket order.
//   4. product: persistent blocks of two warpgroups walk the items. An
//      item's A operand is its pairs' query pieces (128 rows, gathered by
//      pair; rows past the count zero-fill and are not read), its B operand
//      the slab's rows in n-tiles of 128 (L = 256: two), both staged in
//      128-byte stages of k through a 3-stage cp.async ring (wgmma.cuh's
//      swizzled layout, blockmin_tc.cuh's loaders; masked loads where rows
//      are not 16-byte aligned), so each slab byte is read from device
//      memory once an item. Each warpgroup runs m64n128 over 64 pairs (none
//      where the item holds no pair there); each stage's products start a
//      fresh accumulator added into a running f32 sum. The epilogue stages
//      each warp's 16 rows x 128 floats in the ring stage just consumed
//      (XOR-swizzled, no bank conflicts) and stores each row as 512
//      contiguous bytes, 16 bytes a lane. Items of key Nb read nothing and
//      write NaN rows, so a caller that forgot to clamp sees it at once.
//
// Precision, the f32 query against the stored values, as before:
//   bf16 slabs: each f32 query value is split into three bf16 pieces, hi =
//     bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid) (each difference
//     exact), which carry q to ~2^-24; every piece x bf16 product is exact
//     in f32, and each 16-deep k slice issues three bf16 wgmma (lo, mid, hi)
//     into the f32 accumulator. The TPU's two-piece split (~2^-16) is not
//     used.
//   f32 slabs: 3xTF32 as K1 f32 (blockmin_tc.cuh): the query's tf32 big and
//     small pieces come from the prep, the slab's are split in shared memory
//     in place (each thread the chunks it copied); three wgmma k8 a slice.
//   Duplicate ids in a row and queries popping the same blocks are separate
//   pairs of one bucket.
//
// Launch rules: runs on the caller's stream, allocates nothing (the caller
// passes the scratch words of vrt_slab_dots_scratch_words and the pieces)
// and does not synchronise. The C entry points return cudaGetLastError().

#include <algorithm>

#include "blockmin_tc.cuh"

namespace {

namespace btc = vrt::btc;
using btc::Elem;

constexpr int NQ = 128;  // pairs a work item: two warpgroups of 64 rows
constexpr int THREADS = 256;
constexpr int NS = 3;  // ring stages
constexpr int TILE = btc::TILE_BYTES;  // 128 rows x 128 bytes, swizzled
constexpr int STAGE_B = 4 * TILE;  // bf16: 3 query pieces + the slab; f32: 2 + 2
constexpr int ROW_B = 512;  // one staged output row: 128 f32
constexpr int PREP_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
static_assert(THREADS / 32 * 16 * ROW_B == STAGE_B, "each warp stages 16 rows in a stage");

template <bool F32>
struct K2 {
  static constexpr int PIECES = F32 ? 2 : 3;  // query pieces
  static constexpr int BK = F32 ? 32 : 64;  // k a stage: 128 bytes
  static constexpr int PER = F32 ? 4 : 8;  // values a 16-byte chunk
  static constexpr Elem E = F32 ? Elem::F32 : Elem::BF16;
  static constexpr int ES = F32 ? 4 : 2;  // bytes a value
};

struct SlabParams {
  const void* pieces;  // [PIECES, B, d] the query split: bf16 bits or tf32-valued f32
  const void* x;  // [Nb, L, d] slabs: bf16 bits or f32
  const int* order;  // [B W] pairs in bucket order
  const int4* items;  // (slab, first place in order, pairs, 0)
  const int* n_items;
  float* out;  // [B W, L]
  int B, W, L, d, Nb, ntl, nk;
  int vec;  // rows of pieces and slabs are 16-byte aligned: cp.async copies
  int out_vec;  // rows of out are 16-byte aligned
};

// The scratch words (int32) of one call, and their places: the work items
// first (16-byte aligned), then the item count, the buckets' counts and
// starts, and the pairs' ranks and order.
struct Scratch {
  int4* items;
  int *n_items, *count, *start, *rank, *order;
  int max_items;
};

// sum over the Nb + 1 buckets of ceil(c / NQ) <= ceil(pairs / NQ) + Nb: a
// bucket's items beyond its whole NQ are one partial item, and all the
// partial items but one add at least one pair beyond ceil(pairs / NQ) NQ
inline long long max_items_of(long long pairs, int nb) { return (pairs + NQ - 1) / NQ + nb; }

inline long long scratch_words(long long pairs, int nb) {
  return 4 * max_items_of(pairs, nb) + 1 + 2 * (static_cast<long long>(nb) + 1) + 2 * pairs;
}

Scratch scratch_of(void* words, int pairs, int nb) {
  Scratch s;
  s.max_items = static_cast<int>(max_items_of(pairs, nb));
  s.items = static_cast<int4*>(words);
  s.n_items = reinterpret_cast<int*>(s.items + s.max_items);
  s.count = s.n_items + 1;
  s.start = s.count + nb + 1;
  s.rank = s.start + nb + 1;
  s.order = s.rank + pairs;
  return s;
}

__device__ __forceinline__ uint16_t bf16_rn(float v) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ int bucket_of(const int* sel, int i, int nb) {
  const int g = __ldg(sel + i);
  return g >= 0 && g < nb ? g : nb;
}

// 1. Each pair's rank in its bucket (count[] zeroed by the caller), and the
// query pieces.
template <bool F32>
__global__ void __launch_bounds__(PREP_THREADS)
slab_prep_kernel(const float* __restrict__ q, const int* __restrict__ sel, void* pieces,
                 int* count, int* rank, int pairs, long long qvals, int nb) {
  const long long n = pairs > qvals ? pairs : qvals;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    if (i < pairs) {
      const int key = bucket_of(sel, static_cast<int>(i), nb);
      // the lanes of a warp with the same key share one atomic
      const unsigned peers = __match_any_sync(__activemask(), key);
      const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(count + key, __popc(peers));
      base = __shfl_sync(peers, base, leader);
      rank[i] = base + __popc(peers & ((1u << lane) - 1u));
    }
    if (i < qvals) {
      const float v = __ldg(q + i);
      if constexpr (F32) {
        float* o = static_cast<float*>(pieces);
        const float big = __uint_as_float(vrt::tf32_rna(v));
        o[i] = big;
        o[qvals + i] = __uint_as_float(vrt::tf32_rna(v - big));
      } else {
        uint16_t* o = static_cast<uint16_t*>(pieces);
        const uint16_t hi = bf16_rn(v);
        const float r1 = v - bf16_value(hi);
        const uint16_t mid = bf16_rn(r1);
        o[i] = hi;
        o[qvals + i] = mid;
        o[2 * qvals + i] = bf16_rn(r1 - bf16_value(mid));
      }
    }
  }
}

// 2. One block: the buckets' exclusive sums (pairs and items) and the work
// items of every bucket; the item count last.
__global__ void __launch_bounds__(SCAN_THREADS)
slab_scan_kernel(const int* __restrict__ count, int* start, int4* items, int* n_items, int buckets) {
  __shared__ int2 warp_off[SCAN_THREADS / 32];
  __shared__ int2 total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry_p = 0, carry_i = 0;
  for (int base = 0; base < buckets; base += SCAN_THREADS) {
    const int g = base + tid;
    const int c = g < buckets ? count[g] : 0;
    const int ni = (c + NQ - 1) / NQ;
    int xp = c, xi = ni;  // inclusive sums inside the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int yp = __shfl_up_sync(0xffffffffu, xp, off);
      const int yi = __shfl_up_sync(0xffffffffu, xi, off);
      if (lane >= off) xp += yp, xi += yi;
    }
    if (lane == 31) warp_off[warp] = make_int2(xp, xi);
    __syncthreads();
    if (warp == 0) {
      const int2 t = warp_off[lane];
      int tp = t.x, ti = t.y;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int yp = __shfl_up_sync(0xffffffffu, tp, off);
        const int yi = __shfl_up_sync(0xffffffffu, ti, off);
        if (lane >= off) tp += yp, ti += yi;
      }
      warp_off[lane] = make_int2(tp - t.x, ti - t.y);
      if (lane == 31) total = make_int2(tp, ti);
    }
    __syncthreads();
    const int sp = carry_p + warp_off[warp].x + xp - c;
    const int si = carry_i + warp_off[warp].y + xi - ni;
    if (g < buckets) {
      start[g] = sp;
      for (int j = 0; j < ni; ++j)
        items[si + j] = make_int4(g, sp + j * NQ, min(NQ, c - j * NQ), 0);
    }
    carry_p += total.x;
    carry_i += total.y;
    __syncthreads();  // warp_off and total are rewritten by the next chunk
  }
  if (tid == 0) *n_items = carry_i;
}

// 3. The pairs in bucket order.
__global__ void __launch_bounds__(PREP_THREADS)
slab_scatter_kernel(const int* __restrict__ sel, const int* __restrict__ rank,
                    const int* __restrict__ start, int* order, int pairs, int nb) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pairs; i += gridDim.x * blockDim.x)
    order[start[bucket_of(sel, i, nb)] + rank[i]] = i;
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// 4. The product of each work item (see the notes above).
template <bool F32>
__global__ void __launch_bounds__(THREADS, 1) slab_dots_tc_kernel(const SlabParams p) {
  using C = K2<F32>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (vrt::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int total = *p.n_items;
  const int mine = static_cast<int>(blockIdx.x) < total
                       ? (total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x
                       : 0;
  const int nk = p.nk, ntl = p.ntl;
  const int steps = mine * ntl * nk;
  const size_t piece_bytes = static_cast<size_t>(p.B) * p.d * C::ES;
  const size_t slab_bytes = static_cast<size_t>(p.L) * p.d * C::ES;

  // step it: chunk k of n-tile n of this block's item j, in ring stage s
  struct Cursor {
    int j, n, k, s;
  };
  auto advance = [&](Cursor& c) {
    if (++c.s == NS) c.s = 0;
    if (++c.k == nk) {
      c.k = 0;
      if (++c.n == ntl) c.n = 0, ++c.j;
    }
  };
  auto item_at = [&](int j) { return p.items[blockIdx.x + static_cast<size_t>(j) * gridDim.x]; };

  // the copies' cursor, and its item's slab and the query row of each of
  // this thread's four tile rows r + 32 i (-1: no pair there)
  const int r = tid >> 3, ch = tid & 7;
  Cursor ci = {0, 0, 0, 0};
  int ci_item = -1, slab = 0, qrow[4];
  auto issue = [&]() {
    if (ci.j != ci_item) {
      const int4 it = item_at(ci.j);
      ci_item = ci.j;
      slab = it.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r + 32 * i;
        qrow[i] = it.x < p.Nb && row < it.z ? __ldg(p.order + it.y + row) / p.W : -1;
      }
    }
    const uint32_t st = ring + ci.s * STAGE_B;
    const uint32_t off = vrt::sw128_offset(r, ch);
    const int k = ci.k * C::BK + C::PER * ch;
#pragma unroll
    for (int e = 0; e < C::PIECES; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        btc::load_chunk<C::E>(st + e * TILE + off + 32 * 128 * i,
                              static_cast<const char*>(p.pieces) + e * piece_bytes, qrow[i], k,
                              p.d, p.vec);
    const bool ok = slab < p.Nb;
    const char* x = static_cast<const char*>(p.x) + (ok ? static_cast<size_t>(slab) : 0) * slab_bytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ci.n * 128 + r + 32 * i;
      btc::load_chunk<C::E>(st + C::PIECES * TILE + off + 32 * 128 * i, x,
                            ok && row < p.L ? row : -1, k, p.d, p.vec);
    }
    advance(ci);
  };

  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) issue();
    vrt::cp_async_commit();
  }
  float unused[btc::SPLIT_CHUNKS];
  Cursor cs = {0, 0, 0, 0};
  int cs_item = -1;
  int4 item = make_int4(0, 0, 0, 0);
  for (int it = 0; it < steps; ++it) {
    vrt::cp_async_wait<NS - 2>();  // this thread's copies of step it
    // f32 slabs: this thread's chunks of the raw slab tile -> tf32 big (in
    // place) and small (the next tile)
    if constexpr (F32) btc::split_tf32<false>(ring + cs.s * STAGE_B + 2 * TILE, unused);
    vrt::fence_proxy_async();
    __syncthreads();  // step it is staged everywhere; step it - 1 is done
    if (it + NS - 1 < steps) issue();
    vrt::cp_async_commit();
    if (cs.j != cs_item) {
      item = item_at(cs.j);
      cs_item = cs.j;
    }
    // warpgroup-uniform: this warpgroup's 64 rows hold pairs of a real slab
    if (item.x < p.Nb && 64 * wg < item.z) {
      const uint32_t a = ring + cs.s * STAGE_B + wg * (64 * 128);
      const uint32_t b = ring + cs.s * STAGE_B + C::PIECES * TILE;
      vrt::fence_operands(acc);
      vrt::wgmma_fence();
      if constexpr (F32) {
        const uint64_t dab = vrt::sw128_desc(a), das = vrt::sw128_desc(a + TILE);
        const uint64_t dbb = vrt::sw128_desc(b), dbs = vrt::sw128_desc(b + TILE);
#pragma unroll
        for (int kk = 0; kk < C::BK / 8; ++kk) {
          vrt::wgmma_m64n128k8_tf32(acc, das + 2 * kk, dbb + 2 * kk, kk > 0);
          vrt::wgmma_m64n128k8_tf32(acc, dab + 2 * kk, dbs + 2 * kk, true);
          vrt::wgmma_m64n128k8_tf32(acc, dab + 2 * kk, dbb + 2 * kk, true);
        }
      } else {
        const uint64_t dh = vrt::sw128_desc(a), dm = vrt::sw128_desc(a + TILE);
        const uint64_t dl = vrt::sw128_desc(a + 2 * TILE), db = vrt::sw128_desc(b);
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk) {
          vrt::wgmma_m64n128k16_bf16(acc, dl + 2 * kk, db + 2 * kk, kk > 0);
          vrt::wgmma_m64n128k16_bf16(acc, dm + 2 * kk, db + 2 * kk, true);
          vrt::wgmma_m64n128k16_bf16(acc, dh + 2 * kk, db + 2 * kk, true);
        }
      }
      vrt::wgmma_commit();
      vrt::wgmma_wait<0>();
      vrt::fence_operands(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = cs.k == 0 ? acc[i] : sum[i] + acc[i];
    }
    if (cs.k == nk - 1) {  // the n-tile is whole: out[pair, n0 .. n0 + 127]
      __syncthreads();  // both warpgroups are done with stage cs.s
      // this warp's 16 rows: row 16 (warp % 4) + lane / 4 + 8 h holds
      // columns 8 i + 2 (lane % 4) + {0, 1} in sum[4 i + 2 h + {0, 1}]
      const uint32_t stg = ring + cs.s * STAGE_B + (tid >> 5) * (16 * ROW_B);
      const int c = lane & 3;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (lane >> 2) + 8 * h, chunk = 2 * i + (c >> 1);
          st_shared_f2(stg + row * ROW_B + ((chunk ^ ((row & 7) << 1)) << 4) + (c & 1) * 8,
                       sum[4 * i + 2 * h], sum[4 * i + 2 * h + 1]);
        }
      __syncwarp();
      const int row0 = 64 * wg + 16 * ((tid >> 5) & 3), col = cs.n * 128 + 4 * lane;
      for (int rr = 0; rr < 16 && row0 + rr < item.z; ++rr) {
        float4 v = vrt::ld_shared_f4(stg + rr * ROW_B + ((lane ^ ((rr & 7) << 1)) << 4));
        if (item.x >= p.Nb) v = make_float4(NAN, NAN, NAN, NAN);  // the id was not clamped
        float* o = p.out + static_cast<size_t>(__ldg(p.order + item.y + row0 + rr)) * p.L + col;
        if (p.out_vec) {
          if (col < p.L) *reinterpret_cast<float4*>(o) = v;
        } else {
          const float w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < p.L) o[j] = w4[j];
        }
      }
    }
    advance(cs);
  }
}

template <bool F32>
int launch(const void* q, const void* x, const void* sel, void* out, void* scratch,
           void* pieces, int B, int W, int L, int d, int Nb, void* stream) {
  using C = K2<F32>;
  if (B <= 0 || W <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || Nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs_ll = static_cast<long long>(B) * W;
  if (pairs_ll > INT_MAX || max_items_of(pairs_ll, Nb) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = static_cast<int>(pairs_ll);
  const Scratch s = scratch_of(scratch, pairs, Nb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = slab_dots_tc_kernel<F32>;
  const int smem = NS * STAGE_B + 1024;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(s.count, 0, (Nb + 1) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long qvals = static_cast<long long>(B) * d;
  const long long n = pairs > qvals ? pairs : qvals;
  const int prep_blocks = static_cast<int>(std::min<long long>((n + PREP_THREADS - 1) / PREP_THREADS, 8LL * sms));
  slab_prep_kernel<F32><<<prep_blocks, PREP_THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const int*>(sel), pieces, s.count, s.rank, pairs,
      qvals, Nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  slab_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(s.count, s.start, s.items, s.n_items, Nb + 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int scatter_blocks = std::min((pairs + PREP_THREADS - 1) / PREP_THREADS, 8 * sms);
  slab_scatter_kernel<<<scatter_blocks, PREP_THREADS, 0, st>>>(
      static_cast<const int*>(sel), s.rank, s.start, s.order, pairs, Nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  SlabParams p = {};
  p.pieces = pieces;
  p.x = x;
  p.order = s.order;
  p.items = s.items;
  p.n_items = s.n_items;
  p.out = static_cast<float*>(out);
  p.B = B;
  p.W = W;
  p.L = L;
  p.d = d;
  p.Nb = Nb;
  p.ntl = (L + 127) / 128;
  p.nk = (d + C::BK - 1) / C::BK;
  const bool aligned = ((reinterpret_cast<uintptr_t>(pieces) | reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  p.vec = aligned && d % C::PER == 0;
  p.out_vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && L % 4 == 0;
  const int blocks = std::min(s.max_items, (per_sm > 0 ? per_sm : 1) * sms);
  kernel<<<blocks, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int32 scratch words a call with B W pairs over Nb slabs needs.
extern "C" long long vrt_slab_dots_scratch_words(int pairs, int Nb) {
  return scratch_words(pairs, Nb);
}

// list_vecs: f32 [Nb, L, d]; pieces: f32 [2, B, d]
extern "C" int vrt_slab_dots_f32(const void* queries, const void* list_vecs, const void* sel,
                                 void* out, void* scratch, void* pieces, int B, int W, int L,
                                 int d, int Nb, void* stream) {
  return launch<true>(queries, list_vecs, sel, out, scratch, pieces, B, W, L, d, Nb, stream);
}

// list_vecs: bf16 bits [Nb, L, d]; pieces: bf16 bits [3, B, d]
extern "C" int vrt_slab_dots_bf16(const void* queries, const void* list_vecs, const void* sel,
                                  void* out, void* scratch, void* pieces, int B, int W, int L,
                                  int d, int Nb, void* stream) {
  return launch<false>(queries, list_vecs, sel, out, scratch, pieces, B, W, L, d, Nb, stream);
}

extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
