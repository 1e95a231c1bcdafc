// Exact rescore of the selected blocks (K6): stage 3 of exact search's
// blockmin path, one launch.
//
// Replaces no Pallas kernel. The JAX package does this step as plain jnp
// ops on the TPU's vector unit (vectordb_retrieval_tpu/ops/distances.py,
// _exact_search_blockmin, stage 3: gather the blocks, then
// jnp.sum((x - q)**2) or -jnp.sum(x * q)). On the card that chain was a
// gather that wrote a fresh [B, nb, w, d] f32 copy of the selected blocks
// and three more passes over it (difference, product, sum) plus the masks.
// This kernel reads each selected block once and writes only the scores.
//
// For queries [B, d] f32, payload [S, d] f32 (S % w == 0, rows >= n are
// padding) and block ids blk [B, nb] int64, all row-major, it computes for
// pair p = b nb + i, block g = blk[b, i] and row j < w
//
//   cd[b, i w + j]   = sum_e (payload[g w + j, e] - queries[b, e])^2   (l2)
//                    = -sum_e payload[g w + j, e] * queries[b, e]      (ip)
//   cand[b, i w + j] = g w + j
//
// and +inf / -1 where g w + j >= n. Every block id lies in [0, S / w):
// the caller's precondition (exact search's stage 2 gives no other); an id
// outside it traps the launch rather than read outside the payload.
//
// Precision: elementwise f32 on the CUDA cores (l2: a difference and a
// fused multiply-add a term; ip: a fused multiply-add), never a product on
// the tensor cores and never the expansion
// ||q||^2 + ||x||^2 - 2 q.x (cancellation flips near-ties at the top-k
// boundary). Each lane sums its own columns in order, then the warp adds
// the lanes' partial sums by a butterfly: the result differs from a
// sequential f32 sum only in its order (exact where every partial sum is
// an integer below 2^24, as SIFT's rows give).
//
// What bounds it on an H100: 3 operations (l2; 2 for ip) a payload
// element read, 0.75 a byte, far below the card's ridge, so the bytes of
// the selected blocks (486.5 MB at B 256, nb 116, w 32, d 128: 0.145 ms at
// 3.35 TB/s) are its floor. Each (query, block) pair is one contiguous run
// of w d 4 bytes. Queries share blocks (the counted work reads the distinct
// ones once); this kernel reads each pair's block, so a shared block is
// read again unless a cache still holds it.
//
// Design: one warp a pair, eight pairs a block of 256 threads, a grid of
// ceil(B nb / 8) blocks (many resident a multiprocessor, so each has tens
// of kilobytes of loads in flight). A lane holds its slice of the query in
// registers, QCH chunks of 16 bytes (d % 4 == 0 and 16-byte aligned bases;
// single floats otherwise), and walks the block's rows in batches of RB
// rows, issuing every load of a batch before it uses one; neighbouring
// lanes read neighbouring 16 bytes, so each row is one coalesced run. A
// lane keeps one partial sum per row of a group of WG rows (w, but at most
// 32, 16 or 8 as its query slice is one, two or more chunks wide); the
// butterfly halves the rows a lane holds at each of its first log2(WG)
// steps (each lane keeps the half its partner does not and adds the
// partner's copy of it), so after five shuffle steps lane l holds the whole
// sum of row l / (32 / WG): 31 shuffles for 32 rows. Wider blocks walk their
// rows in groups of WG. w, the vector width, QCH and the metric are
// template and launch parameters of this one algorithm.
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vrt {
namespace k6 {

constexpr int WARPS = 8;  // pairs (warps) a block
constexpr unsigned FULL = 0xffffffffu;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};

template <bool L2>
__device__ __forceinline__ float add_term(float acc, float x, float q) {
  if (L2) {
    const float t = x - q;
    return fmaf(t, t, acc);
  }
  return fmaf(x, q, acc);
}

template <bool L2>
__device__ __forceinline__ float add_terms(float acc, float x, float q) {
  return add_term<L2>(acc, x, q);
}

template <bool L2>
__device__ __forceinline__ float add_terms(float acc, float4 x, float4 q) {
  acc = add_term<L2>(acc, x.x, q.x);
  acc = add_term<L2>(acc, x.y, q.y);
  acc = add_term<L2>(acc, x.z, q.z);
  return add_term<L2>(acc, x.w, q.w);
}

// One butterfly step a level: each lane keeps the half of its H rows that
// its partner (lane ^ O) drops and adds the partner's copy of it.
template <int H, int O, int WG>
__device__ __forceinline__ void halve_rows(float (&acc)[WG], int lane) {
  if constexpr (H >= 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? acc[i] : acc[i + H];
      const float keep = upper ? acc[i + H] : acc[i];
      acc[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    halve_rows<H / 2, O / 2>(acc, lane);
  }
}

// The warp's sums of WG rows, one partial sum a row in each lane -> lane l
// returns the whole sum of row l / (32 / WG).
template <int WG>
__device__ __forceinline__ float reduce_rows(float (&acc)[WG], int lane) {
  halve_rows<WG / 2, 16>(acc, lane);
  float v = acc[0];
#pragma unroll
  for (int o = 16 / WG; o >= 1; o /= 2) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int WG, int V, int QCH, bool L2>
__global__ void __launch_bounds__(32 * WARPS)
block_rescore_kernel(const float* __restrict__ queries, const float* __restrict__ payload,
                     const int64_t* __restrict__ blk, float* __restrict__ cd,
                     int64_t* __restrict__ cand, long long pairs, int nb, int d, int w,
                     long long n, long long nblocks) {
  using T = typename Vec<V>::T;
  // rows a lane loads before it uses one: RB x QCH loads of V floats
  constexpr int RB = QCH == 1 ? 8 : QCH == 4 ? 2 : 4;
  constexpr int TILE = 32 * QCH;    // chunks of V floats a pass over a row
  constexpr int SHIFT = WG == 8 ? 2 : WG == 16 ? 1 : 0;  // log2(32 / WG)
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (p >= pairs) return;
  const long long b = p / nb;
  const long long g = blk[p];
  float* out = cd + p * w;
  int64_t* ids = cand + p * w;
  // The precondition's check also sets the code nvcc emits: with it a lane
  // issues its batch of loads before it uses one (78 registers at w 32,
  // d 128, l2, against 64 without: 0.073 against 0.114 ms a call at
  // sift1m.exact's shape on an H100)
  if (g < 0 || g >= nblocks) __trap();
  const int chunks = d / V;  // of a row
  const T* qv = reinterpret_cast<const T*>(queries + b * d);
  const T* xb = reinterpret_cast<const T*>(payload + g * w * static_cast<long long>(d));
  const int row = lane >> SHIFT;
  const bool writer = (lane & ((1 << SHIFT) - 1)) == 0;
  for (int r0 = 0; r0 < w; r0 += WG) {
    float acc[WG];
#pragma unroll
    for (int r = 0; r < WG; ++r) acc[r] = 0.0f;
    for (int c0 = 0; c0 < chunks; c0 += TILE) {
      T qr[QCH];
#pragma unroll
      for (int j = 0; j < QCH; ++j) {
        const int c = c0 + lane + 32 * j;
        qr[j] = c < chunks ? qv[c] : Vec<V>::zero();
      }
#pragma unroll
      for (int rb = 0; rb < WG; rb += RB) {
        T xr[RB][QCH];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const T* xrow = xb + static_cast<long long>(r0 + rb + r) * chunks;
#pragma unroll
          for (int j = 0; j < QCH; ++j) {
            const int c = c0 + lane + 32 * j;
            xr[r][j] = c < chunks ? __ldg(xrow + c) : Vec<V>::zero();
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int j = 0; j < QCH; ++j) acc[rb + r] = add_terms<L2>(acc[rb + r], xr[r][j], qr[j]);
        }
      }
    }
    const float v = reduce_rows<WG>(acc, lane);
    if (writer) {
      const int j = r0 + row;
      const long long id = g * w + j;
      const bool real = id < n;
      out[j] = real ? (L2 ? v : -v) : INFINITY;
      ids[j] = real ? id : -1;
    }
  }
}

struct Args {
  const float* q;
  const float* x;
  const int64_t* blk;
  float* cd;
  int64_t* cand;
  long long pairs, n, nblocks;
  int nb, d, w;
};

template <int WG, int V, int QCH, bool L2>
int launch(const Args& a, cudaStream_t stream) {
  const long long grid = (a.pairs + WARPS - 1) / WARPS;
  block_rescore_kernel<WG, V, QCH, L2><<<static_cast<unsigned>(grid), 32 * WARPS, 0, stream>>>(
      a.q, a.x, a.blk, a.cd, a.cand, a.pairs, a.nb, a.d, a.w, a.n, a.nblocks);
  return static_cast<int>(cudaGetLastError());
}

// WG: rows a lane sums at once, fewer where its slice of the query is wider
// (so a lane's partial sums and loads in flight stay in registers).
template <int V, int QCH, bool L2>
int launch_rows(const Args& a, cudaStream_t stream) {
  constexpr int CAP = QCH == 1 ? 32 : QCH == 2 ? 16 : 8;
  if constexpr (CAP >= 32) {
    if (a.w >= 32) return launch<32, V, QCH, L2>(a, stream);
  }
  if constexpr (CAP >= 16) {
    if (a.w >= 16) return launch<16, V, QCH, L2>(a, stream);
  }
  return launch<8, V, QCH, L2>(a, stream);
}

// QCH: the 16-byte chunks of the query a lane holds (a row of d / 4 chunks
// in passes of 32 QCH); single floats take one a pass.
template <bool L2>
int launch_metric(const Args& a, bool vec, cudaStream_t stream) {
  if (!vec) return launch_rows<1, 1, L2>(a, stream);
  switch ((a.d / 4 + 31) / 32) {
    case 1: return launch_rows<4, 1, L2>(a, stream);
    case 2: return launch_rows<4, 2, L2>(a, stream);
    case 3: return launch_rows<4, 3, L2>(a, stream);
    default: return launch_rows<4, 4, L2>(a, stream);
  }
}

}  // namespace k6
}  // namespace vrt

// w: a power of two in [8, 128]; l2: 1 for l2, 0 for ip. S rows, n real;
// every id of blk in [0, S / w) (another traps the launch).
extern "C" int vrt_block_rescore_f32(const void* queries, const void* payload, const void* blk,
                                     void* cd, void* cand, int B, int nb, int S, int d, int w,
                                     int n, int l2, void* stream) {
  namespace k6 = vrt::k6;
  if (B <= 0 || nb <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w < 8 || w > 128 || (w & (w - 1)) || S % w)
    return static_cast<int>(cudaErrorInvalidValue);
  k6::Args a;
  a.q = static_cast<const float*>(queries);
  a.x = static_cast<const float*>(payload);
  a.blk = static_cast<const int64_t*>(blk);
  a.cd = static_cast<float*>(cd);
  a.cand = static_cast<int64_t*>(cand);
  a.pairs = static_cast<long long>(B) * nb;
  a.n = n;
  a.nblocks = S / w;
  a.nb = nb;
  a.d = d;
  a.w = w;
  // 16-byte loads where every row starts on 16 bytes
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(payload) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l2 ? k6::launch_metric<true>(a, vec, s) : k6::launch_metric<false>(a, vec, s);
}

// ---- IVF-Flat's stage 3 over bf16 lists -----------------------------------
//
// Stage 3 of IVF-Flat's two block streams (vectordb_retrieval_tpu_torch/
// ops/ivf.py, _rescore_blocks) where the lists are bf16 and no per-slot
// penalty is added, one launch. Replaces no Pallas kernel either: the JAX
// package does this step as plain jnp ops (vectordb_retrieval_tpu/ops/
// ivf.py, _ivf_probed_blockmin and _ivf_blockmin: gather the blocks,
// widen them to f32, then the same difference sum, and mask the unprobed
// pairs and the dead slots). On the card that chain was a gather of a
// fresh [B, nb, w, d] bf16 copy of the selected blocks, its widening into
// an f32 copy twice its size and three passes over that (difference,
// product, sum) plus the masks. This kernel reads each selected block once
// and writes only the scores and row ids.
//
// For queries [B, d] f32, the bucketed list payload [S, d] bf16 (S % w ==
// 0), its slot ids [S] int32 (-1: a dead slot), block ids blk [B, nb]
// int64 in [0, S / w) and their block minima blk_vals [B, nb] f32, it
// computes for pair p = b nb + i, block g = blk[b, i], row j < w and
// x = payload[g w + j] widened exactly to f32
//
//   cd[b, i w + j]   = sum_e (x_e - queries[b, e])^2   (l2)
//                    = -sum_e x_e queries[b, e]        (ip)
//   cand[b, i w + j] = slot_ids[g w + j]
//
// and +inf / -1 where the slot is dead or blk_vals[b, i] is not finite (a
// pair that was never probed: it reads no payload). An id outside
// [0, S / w) traps the launch, as in K6.
//
// Precision: K6's rule. The bf16 values widen exactly (a shift into the
// high half of an f32); each lane sums its own columns in order with a
// fused multiply-add a term, the lanes' partial sums meet in a butterfly,
// never on the tensor cores and never by the norm expansion.
//
// What bounds it on an H100: 3 operations (l2) a 2-byte element, 1.5 a
// byte, far below the ridge: the bytes of the selected blocks are its
// floor (243 MB at B 256, nb 116, w 32, d 128 were every pair's block
// read: 0.073 ms at 3.35 TB/s; queries share blocks, and the counted work
// reads the distinct ones once).
//
// Design: K6's, one warp a pair and eight pairs a block of 256 threads,
// with the row split to fit bf16 rows. A load is 16 bytes, 8 values; a
// row of d / 8 chunks takes a group of G lanes (the next power of two, 4
// to 32), so one warp load covers 32 / G rows (two at d 128: each lane
// reads 16 bytes of a 512-byte run). A lane keeps its 8 query values as
// f32 in registers, and one partial sum per row step of a group of WG
// steps; it issues RB steps' loads before it uses one. The butterfly runs
// inside each group of G lanes: log2(WG) halving steps, then plain adds,
// so lane l of a group holds the whole sum of step l / (G / WG). Rows wider
// than 32 chunks take G = 32 and QCH chunks a lane a pass, as K6 does.
// Where d % 8 != 0 or a base is not on 16 bytes, single bf16 loads (G =
// 32). G, WG, the load width, QCH and the metric are template parameters
// of this one algorithm.

namespace vrt {
namespace ivfr {

constexpr int WARPS = 8;  // pairs (warps) a block
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// the exact f32 value of the bf16 in the low or the high half of u
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// V bf16 values a load: one 16-byte chunk of 8, or a single one
template <int V>
struct Chunk;
template <>
struct Chunk<8> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
template <>
struct Chunk<1> {
  using T = unsigned short;
  static __device__ __forceinline__ T zero() { return 0; }
};

template <bool L2>
__device__ __forceinline__ float add_chunk(float acc, uint4 x, const float (&q)[8]) {
  acc = k6::add_term<L2>(acc, bf16_lo(x.x), q[0]);
  acc = k6::add_term<L2>(acc, bf16_hi(x.x), q[1]);
  acc = k6::add_term<L2>(acc, bf16_lo(x.y), q[2]);
  acc = k6::add_term<L2>(acc, bf16_hi(x.y), q[3]);
  acc = k6::add_term<L2>(acc, bf16_lo(x.z), q[4]);
  acc = k6::add_term<L2>(acc, bf16_hi(x.z), q[5]);
  acc = k6::add_term<L2>(acc, bf16_lo(x.w), q[6]);
  return k6::add_term<L2>(acc, bf16_hi(x.w), q[7]);
}

template <bool L2>
__device__ __forceinline__ float add_chunk(float acc, unsigned short x, const float (&q)[1]) {
  return k6::add_term<L2>(acc, bf16_lo(x), q[0]);
}

// query values of chunk c (V of them), zeros past the row
template <int V>
__device__ __forceinline__ void load_query(float (&q)[V], const float* qrow, int c, int chunks) {
  if (c >= chunks) {
#pragma unroll
    for (int e = 0; e < V; ++e) q[e] = 0.0f;
    return;
  }
  if constexpr (V == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(qrow) + 2 * c);
    const float4 b = __ldg(reinterpret_cast<const float4*>(qrow) + 2 * c + 1);
    q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
    q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
  } else {
    q[0] = __ldg(qrow + c);
  }
}

// The sums of WG row steps over each group of G lanes, one partial sum a
// step in each lane -> lane l of a group returns the whole sum of step
// (l % G) / (G / WG).
template <int G, int WG>
__device__ __forceinline__ float reduce_steps(float (&acc)[WG], int lane) {
  k6::halve_rows<WG / 2, G / 2>(acc, lane);
  float v = acc[0];
#pragma unroll
  for (int o = G / (2 * WG); o >= 1; o /= 2) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Blocks resident a multiprocessor that the registers must allow: four
// (at most 64 registers a thread) where a row takes at most 16 lanes, so
// 32 pairs' loads are in flight an SM (at the cell's shape 0.087 ms a call
// against 0.115 with the 96 registers nvcc picks unbounded), two otherwise
template <int G, int WG, int V, int QCH, bool L2>
__global__ void __launch_bounds__(32 * WARPS, (G < 32 ? 4 : 2))
ivf_block_rescore_kernel(const float* __restrict__ queries,
                         const unsigned short* __restrict__ payload,
                         const int* __restrict__ slot_ids, const int64_t* __restrict__ blk,
                         const float* __restrict__ blk_vals, float* __restrict__ cd,
                         int64_t* __restrict__ cand, long long pairs, int nb, int d, int w,
                         long long nblocks) {
  using T = typename Chunk<V>::T;
  constexpr int R = 32 / G;  // rows a warp load
  // row steps a lane loads before it uses one: RB x QCH loads
  constexpr int RB_CAP = QCH == 1 ? 8 : QCH == 4 ? 2 : 4;
  constexpr int RB = RB_CAP < WG ? RB_CAP : WG;
  constexpr int TILE = G * QCH;  // chunks a pass over a row
  constexpr int SHIFT = ilog2(G / WG);
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (p >= pairs) return;
  const long long b = p / nb;
  const long long g = blk[p];
  float* out = cd + p * w;
  int64_t* ids = cand + p * w;
  if (g < 0 || g >= nblocks) __trap();
  if (!isfinite(blk_vals[p])) {  // never probed: no payload read
    for (int j = lane; j < w; j += 32) {
      out[j] = INFINITY;
      ids[j] = -1;
    }
    return;
  }
  const int chunks = d / V;  // of a row
  const int gl = lane & (G - 1);  // lane of its row group
  const int sub = lane / G;       // row of a warp load
  const float* qrow = queries + b * d;
  const T* xb = reinterpret_cast<const T*>(payload + g * w * static_cast<long long>(d));
  const int* slots = slot_ids + g * w;
  const int step = gl >> SHIFT;
  const bool writer = (gl & ((1 << SHIFT) - 1)) == 0;
  for (int r0 = 0; r0 < w; r0 += R * WG) {
    float acc[WG];
#pragma unroll
    for (int r = 0; r < WG; ++r) acc[r] = 0.0f;
    for (int c0 = 0; c0 < chunks; c0 += TILE) {
      float qr[QCH][V];
#pragma unroll
      for (int j = 0; j < QCH; ++j) load_query<V>(qr[j], qrow, c0 + gl + G * j, chunks);
#pragma unroll
      for (int rb = 0; rb < WG; rb += RB) {
        T xr[RB][QCH];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const T* xrow = xb + static_cast<long long>(r0 + (rb + r) * R + sub) * chunks;
#pragma unroll
          for (int j = 0; j < QCH; ++j) {
            const int c = c0 + gl + G * j;
            xr[r][j] = c < chunks ? __ldg(xrow + c) : Chunk<V>::zero();
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int j = 0; j < QCH; ++j) acc[rb + r] = add_chunk<L2>(acc[rb + r], xr[r][j], qr[j]);
        }
      }
    }
    const float v = reduce_steps<G, WG>(acc, lane);
    if (writer) {
      const int j = r0 + step * R + sub;
      const int id = __ldg(slots + j);
      out[j] = id >= 0 ? (L2 ? v : -v) : INFINITY;
      ids[j] = id >= 0 ? id : -1;
    }
  }
}

struct Args {
  const float* q;
  const unsigned short* x;
  const int* slots;
  const int64_t* blk;
  const float* vals;
  float* cd;
  int64_t* cand;
  long long pairs, nblocks;
  int nb, d, w;
};

template <int G, int WG, int V, int QCH, bool L2>
int launch(const Args& a, cudaStream_t stream) {
  const long long grid = (a.pairs + WARPS - 1) / WARPS;
  ivf_block_rescore_kernel<G, WG, V, QCH, L2>
      <<<static_cast<unsigned>(grid), 32 * WARPS, 0, stream>>>(
          a.q, a.x, a.slots, a.blk, a.vals, a.cd, a.cand, a.pairs, a.nb, a.d, a.w, a.nblocks);
  return static_cast<int>(cudaGetLastError());
}

// WG: row steps a lane sums at once, as many as the block has for its
// group (w / (32 / G), at least G / 4 at w 8), but at most G and at most
// 32, 16 or 8 as a lane's slice of the query is one, two or more chunks
// (so its partial sums and loads in flight stay in registers)
template <int G, int WG, int V, int QCH, bool L2>
int launch_steps(const Args& a, int steps, cudaStream_t stream) {
  if constexpr (WG > G / 4) {
    if (steps < WG) return launch_steps<G, WG / 2, V, QCH, L2>(a, steps, stream);
  }
  return launch<G, WG, V, QCH, L2>(a, stream);
}

template <int G, int V, int QCH, bool L2>
int launch_group(const Args& a, cudaStream_t stream) {
  constexpr int CAP = QCH == 1 ? 32 : QCH == 2 ? 16 : 8;
  return launch_steps<G, (G < CAP ? G : CAP), V, QCH, L2>(a, a.w / (32 / G), stream);
}

// G: lanes a row, the chunks of a row rounded up to a power of two, at
// least 4 (so a warp load covers at most 8 rows, w's least); rows wider
// than 32 chunks take QCH chunks a lane a pass. Single bf16 loads take the
// whole warp a row, one a pass.
template <bool L2>
int launch_metric(const Args& a, bool vec, cudaStream_t stream) {
  if (!vec) return launch_group<32, 1, 1, L2>(a, stream);
  const int chunks = a.d / 8;
  if (chunks <= 4) return launch_group<4, 8, 1, L2>(a, stream);
  if (chunks <= 8) return launch_group<8, 8, 1, L2>(a, stream);
  if (chunks <= 16) return launch_group<16, 8, 1, L2>(a, stream);
  switch ((chunks + 31) / 32) {
    case 1: return launch_group<32, 8, 1, L2>(a, stream);
    case 2: return launch_group<32, 8, 2, L2>(a, stream);
    case 3: return launch_group<32, 8, 3, L2>(a, stream);
    default: return launch_group<32, 8, 4, L2>(a, stream);
  }
}

}  // namespace ivfr
}  // namespace vrt

// w: a power of two in [8, 128]; l2: 1 for l2, 0 for ip. S slots; every id
// of blk in [0, S / w) (another traps the launch).
extern "C" int vrt_ivf_block_rescore_bf16(const void* queries, const void* payload,
                                          const void* slot_ids, const void* blk,
                                          const void* blk_vals, void* cd, void* cand, int B,
                                          int nb, int S, int d, int w, int l2, void* stream) {
  namespace ivfr = vrt::ivfr;
  if (B <= 0 || nb <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w < 8 || w > 128 || (w & (w - 1)) || S % w)
    return static_cast<int>(cudaErrorInvalidValue);
  ivfr::Args a;
  a.q = static_cast<const float*>(queries);
  a.x = static_cast<const unsigned short*>(payload);
  a.slots = static_cast<const int*>(slot_ids);
  a.blk = static_cast<const int64_t*>(blk);
  a.vals = static_cast<const float*>(blk_vals);
  a.cd = static_cast<float*>(cd);
  a.cand = static_cast<int64_t*>(cand);
  a.pairs = static_cast<long long>(B) * nb;
  a.nblocks = S / w;
  a.nb = nb;
  a.d = d;
  a.w = w;
  // 16-byte loads where every row of the payload and the queries starts on
  // 16 bytes
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(payload) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l2 ? ivfr::launch_metric<true>(a, vec, s) : ivfr::launch_metric<false>(a, vec, s);
}

extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
