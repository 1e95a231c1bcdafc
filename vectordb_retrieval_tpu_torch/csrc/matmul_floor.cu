// K5, K1 f32's matmul floor, as a warp-specialised Hopper kernel: TMA into
// an mbarrier ring fed by one producer thread, 3xTF32 wgmma with the payload
// as the A operand from registers.
//
// Replaces the TPU kernel of scripts/exp_dbm_tune.py matmul_floor (its body
// matmul_floor_kernel), a tuning probe that keeps K1's tiling and product and
// swaps the block minimum for a strided slice. For queries [B, d] f32 and a
// payload [S, d] f32 (S % w == 0, w a power of two <= 128) it computes
//
//   out[g, q] = <payload[g*w], queries[q]>,   out [S/w, B] f32, row-major,
//
// and, as the TPU kernel does, it multiplies EVERY payload row to get there:
// it does K1 f32's arithmetic at K1 f32's shapes with no pen, no minimum and
// no epilogue beyond a store, so its time is the card's floor for K1 f32's
// main loop. K1 f32's time less this one is what K1 loses to the card's
// product loop, epilogue included.
//
// Numerics (K1 f32's): each value v of both operands splits into big =
// tf32_rna(v) and small = tf32_rna(v - big); each 8-deep k slice takes three
// tf32 products, small_q big_x, big_q small_x, big_q big_x; each 32-deep
// stage's twelve products go into a fresh accumulator, added into a running
// f32 sum.
//
// What bounds it on an H100: 6 B S d FLOP of TF32 at 495 TFLOP/s (0.119 ms
// at 256 x 100,032 x 384) against 4 S d payload bytes at 3.35 TB/s (0.046
// ms): the tensor cores. The function alone needs only the S/w rows
// (ops/kernels.py matmul_floor_work), which one strided product computes in
// less time: by design this kernel does w times that work.
//
// Design (K1 f32's loop is paced by shared memory: queries reloaded and
// split in place at every stage, payload split in place, a block barrier a
// stage):
//   1. split (one launch a call): queries -> q_big, q_small [Bp, dp] (B and
//      d rounded up to 128 and 32, zeros past them) in the caller's scratch,
//      each 32-deep stage of k in the order of step 3.
//   2. persistent CTAs of three warpgroups (setmaxnreg: the producer's drop
//      to PRODUCER_REGS registers, the two consumers' rise to
//      CONSUMER_REGS), in clusters of CL = 2 CTAs on neighbouring payload
//      tiles of one query tile. A unit is one 128-row payload tile against
//      one 128-query tile, walked in stages of 32 k through a ring of NS = 4
//      stages, each a 16 KB payload tile and a 32 KB query tile (big, small)
//      in the 128-byte swizzle, with a full and an empty mbarrier a stage.
//      One producer thread issues the TMA copies: the payload box into its
//      own CTA, and its 64 rows of the query boxes multicast to both CTAs of
//      the cluster, so the queries come from L2 once for two payload tiles
//      (at 256 x 100,032 x 384: L2 reads 4x the payload's bytes, the payload
//      twice for the two query tiles and the split queries once; 6x with no
//      cluster; a cluster of 4, 3x, measured slower). Where the query stages
//      fit the ring (d <= 128) they are loaded at a CTA's first unit and
//      stay. A CTA's units share its query tile; the clusters of one payload
//      stretch run side by side, so the payload comes from device memory
//      about once a call.
//   3. each consumer warpgroup multiplies 64 payload rows by the 128
//      queries. The payload is wgmma's A operand from registers: each thread
//      loads its two rows' 16 values of a stage with four conflict-free
//      16-byte loads from the swizzled tile and splits them in registers
//      (nothing is written back to shared memory); q_big and q_small are B
//      from shared memory. A thread holds k 8c .. 8c+7 of its rows (c = lane
//      % 4), and wgmma's fragment takes k c and c + 4 of each 8-deep slice,
//      so slice kk's column j is the stage's k 8 (j % 4) + 2 kk + j / 4, and
//      step 1 writes the queries in that order (split_k). The 128 queries
//      are two halves of 64 (m64n64k8), each with its own accumulator, and
//      the fragments have two buffers: while one half's products run, the
//      other half's stage sum and the next stage's loads and split do, so
//      the tensor cores are not left waiting on the sums (with one m64n128
//      accumulator they were, between every two stages). No block barrier:
//      each warp releases a stage on the empty barriers of both CTAs of its
//      cluster once both halves' products are done.
//   4. epilogue: the accumulator's rows are payload rows, so the threads that
//      hold a group's first row store its 128 queries along out's row, while
//      the producer loads the next unit.
//
// Edges: payload rows past S and k past d read 0 (TMA's fill); queries past
// B and k past d are the split's zeros. TMA needs a 16-byte aligned payload
// and row stride (d % 4 == 0); otherwise the producer warpgroup fills the
// payload tiles with masked loads, into the same layout and barriers.
//
// Launch rules: runs on the caller's stream, allocates nothing (the caller
// passes vrt_matmul_floor_scratch_floats floats of scratch) and does not
// synchronise. The C entry point returns the first CUDA error.

#include <limits.h>

#include <type_traits>

#include "tma.cuh"

namespace {

using namespace vrt;

constexpr int CL = 2;               // CTAs a cluster, along the payload
constexpr int BM = 128;             // payload rows a tile: two consumer warpgroups of 64
constexpr int BN = 128;             // queries a tile (wgmma N)
constexpr int BK = 32;              // k a stage: 128 bytes of f32, the swizzle span
constexpr int NS = 4;               // ring stages
constexpr int THREADS = 384;        // the producer warpgroup, then two consumers
constexpr int TILE = 128 * 128;     // bytes of one swizzled 128 x 32 f32 tile
constexpr int QROWS = BN / CL;      // query rows a CTA loads for its cluster
constexpr int Q_STAGE = 2 * TILE;   // q_big, q_small
constexpr int P_STAGE = TILE;
constexpr int BARS = NS * (Q_STAGE + P_STAGE);  // the barriers' offset
constexpr int SMEM = BARS + 2 * NS * 8 + 1024;  // + alignment to 1024 bytes
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(BN % (8 * CL) == 0, "each CTA's query rows are whole 8-row swizzle atoms");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 65536, "one CTA an SM");

struct Params {
  const float* x;  // the payload [S, d] (the masked route reads it)
  float* out;      // [S/w, B]
  int B, S, d, w, Bp;
  int nk;          // stages a unit: dp / BK
  int n_pt, n_ct;  // payload tiles, cluster tiles (CL payload tiles each)
  int n_qt, lanes; // query tiles; clusters a query tile (cluster c: tile c % n_qt)
  int vec;         // TMA for the payload (16-byte aligned base and rows)
  int resident;    // the query stages stay in the ring (nk <= NS)
};

// The k of its 32-deep stage that the split's column kp holds (step 3).
__device__ __forceinline__ int split_k(int kp) {
  const int kk = (kp >> 3) & 3, j = kp & 7;
  return (kp & ~31) + 8 * (j & 3) + 2 * kk + (j >> 2);
}

// queries [B, d] -> q_big [Bp, dp] at qs, q_small [Bp, dp] right after it.
__global__ void split_queries(const float* __restrict__ q, float* __restrict__ qs, int B, int d,
                              int Bp, int dp) {
  const long long n = static_cast<long long>(Bp) * dp;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = static_cast<int>(i / dp), k = split_k(static_cast<int>(i % dp));
  const float v = r < B && k < d ? q[static_cast<size_t>(r) * d + k] : 0.f;
  const uint32_t big = tf32_rna(v);
  qs[i] = __uint_as_float(big);
  qs[n + i] = __uint_as_float(tf32_rna(v - __uint_as_float(big)));
}

// This CTA's rows of the query tile's stage k (big and small) -> the query
// slot qs of every CTA of the cluster.
__device__ __forceinline__ void load_queries(uint32_t qs, const CUtensorMap* map, int k, int qt,
                                             uint32_t rank, int Bp, uint32_t bar) {
  const int row = qt * BN + static_cast<int>(rank) * QROWS;
  const uint32_t off = rank * QROWS * 128;
  constexpr uint16_t ALL = (1u << CL) - 1;
  tma_load_2d_multicast(qs + off, map, k * BK, row, bar, ALL);
  tma_load_2d_multicast(qs + TILE + off, map, k * BK, Bp + row, bar, ALL);
}

// The masked route: the payload's k0 .. k0 + 31 of rows n0 .. n0 + 127 ->
// the swizzled tile at ps, by the 128 producer threads (thread t: chunk
// t % 8 of rows t / 8 + 16 i); rows past S and k past d are 0.
__device__ __forceinline__ void fill_masked(const Params& p, uint32_t ps, int n0, int k0,
                                            int tid) {
  const int c = tid & 7, k = k0 + 4 * c;
#pragma unroll 1
  for (int i = 0; i < BM / 16; ++i) {
    const int r = (tid >> 3) + 16 * i, row = n0 + r;
    const float* src = p.x + static_cast<size_t>(row < p.S ? row : 0) * p.d;
    uint32_t f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = row < p.S && k + e < p.d ? __float_as_uint(__ldg(src + k + e)) : 0u;
    st_shared_16(ps + sw128_offset(r, c), make_uint4(f[0], f[1], f[2], f[3]));
  }
}

// A warp is done with a stage: one arrival on its empty barrier in every
// CTA of the cluster (each producer refills its own CTA's payload and every
// CTA's queries).
__device__ __forceinline__ void release(uint32_t bar) {
#pragma unroll
  for (uint32_t r = 0; r < CL; ++r) mbar_arrive_cluster(bar, r);
}

// This thread's 16 payload values of the stage at ps: k 8c .. 8c+7 (c =
// lane % 4) of row r0 at raw[0..7] and of row r0 + 8 at raw[8..15], from
// chunks 2c, 2c + 1 (a0, a1: their offsets in row r0; row r0 + 8 lies 1024
// bytes on, with the same swizzle, r0 % 8 == (r0 + 8) % 8).
__device__ __forceinline__ void load_rows(float (&raw)[16], uint32_t ps, uint32_t a0,
                                          uint32_t a1) {
  const float4 v[4] = {ld_shared_f4(ps + a0), ld_shared_f4(ps + a1),
                       ld_shared_f4(ps + a0 + 1024), ld_shared_f4(ps + a1 + 1024)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    raw[4 * i] = v[i].x;
    raw[4 * i + 1] = v[i].y;
    raw[4 * i + 2] = v[i].z;
    raw[4 * i + 3] = v[i].w;
  }
}

template <int N>
__device__ __forceinline__ void fence_words(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
matmul_floor_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_q, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + BARS, empty = full + NS * 8;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, p.vec ? 1 : 128);
      mbar_init(empty + 8 * s, 8 * CL);  // every consumer warp of the cluster
    }
    fence_mbar_init();
  }
  cluster_sync();  // no multicast before the whole cluster's barriers exist

  const uint32_t rank = cluster_ctarank();
  const int cid = blockIdx.x / CL;
  const int qt = cid % p.n_qt, lane0 = cid / p.n_qt;
  const int units = lane0 < p.n_ct ? (p.n_ct - lane0 + p.lanes - 1) / p.lanes : 0;
  const int steps = units * p.nk;
  // step: stage k of the CTA's unit u, in ring slot step % NS
  struct Cursor {
    int step, k, u;
  };
  auto advance = [&](Cursor c) {
    ++c.step;
    if (++c.k == p.nk) c.k = 0, ++c.u;
    return c;
  };
  auto p_slot = [&](const Cursor& c) { return base + NS * Q_STAGE + (c.step % NS) * P_STAGE; };
  auto q_slot = [&](const Cursor& c) {
    return base + (p.resident ? c.k : c.step % NS) * Q_STAGE;
  };
  // the payload tile of unit u (past n_pt in a cluster's last tile: loads
  // the last real tile, stores nothing)
  auto p_tile = [&](int u) { return (lane0 + u * p.lanes) * CL + static_cast<int>(rank); };

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues TMA; the masked route takes
    // all 128
    setmaxnreg_dec<PRODUCER_REGS>();
    if (!p.vec || tid == 0) {
      for (Cursor c = {0, 0, 0}; c.step < steps; c = advance(c)) {
        const int pt = p_tile(c.u);
        mbar_wait(empty + 8 * (c.step % NS), ((c.step / NS) & 1) ^ 1);
        const bool queries = !p.resident || c.u == 0;
        const uint32_t fb = full + 8 * (c.step % NS);
        if (!p.vec) fill_masked(p, p_slot(c), pt * BM, c.k * BK, tid);
        if (tid == 0) {
          const uint32_t bytes = (p.vec ? P_STAGE : 0) + (queries ? Q_STAGE : 0);
          if (bytes > 0) {
            mbar_arrive_expect_tx(fb, bytes);
          } else {
            mbar_arrive(fb);
          }
          if (p.vec) tma_load_2d(p_slot(c), &map_x, c.k * BK, min(pt, p.n_pt - 1) * BM, fb);
          if (queries) load_queries(q_slot(c), &map_q, c.k, qt, rank, p.Bp, fb);
        } else {
          mbar_arrive(fb);
        }
      }
      // stay until every consumer of the cluster has released the last
      // stages: no remote arrival may reach an exited CTA
      if (tid == 0)
        for (int step = steps; step < steps + NS; ++step)
          mbar_wait(empty + 8 * (step % NS), ((step / NS) & 1) ^ 1);
    }
  } else {
    // ---- consumer warpgroups: 64 payload rows each x the 128 queries, as
    // two halves of 64 queries (h), each with its own accumulator: while
    // one half's products run, the other's stage sum and the next stage's
    // split do
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = tid & 31, g = lane >> 2, c = lane & 3;
    const int r0 = 64 * ((tid >> 7) - 1) + 16 * ((tid >> 5) & 3) + g;  // rows r0, r0 + 8
    const uint32_t a0 = r0 * 128 + (((2 * c) ^ g) << 4);  // r0 % 8 == g
    const uint32_t a1 = r0 * 128 + (((2 * c + 1) ^ g) << 4);
    // sum[4i + 2h + j]: payload row r0 + 8h, query 8i + 2c + j of the tiles;
    // acc[n] holds those of i = 8n .. 8n + 7
    float acc[2][32], sum[64];
    // a stage's A fragments, big and small, for slices kk, in two buffers
    // (stage step in buffer step % 2: the next stage's split runs while the
    // products of this one still read theirs)
    uint32_t frag[2][2][4][4];
    auto split_stage = [&](auto buf, const Cursor& cur) {
      constexpr int F = decltype(buf)::value;
      mbar_wait(full + 8 * (cur.step % NS), (cur.step / NS) & 1);
      float raw[16];
      load_rows(raw, p_slot(cur), a0, a1);
      // slice kk's fragment: rows r0, r0 + 8 at k 8c + 2kk (column c) and
      // 8c + 2kk + 1 (column c + 4)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float v[4] = {raw[2 * kk], raw[8 + 2 * kk], raw[2 * kk + 1], raw[9 + 2 * kk]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          frag[F][0][kk][e] = tf32_rna(v[e]);
          frag[F][1][kk][e] = tf32_rna(v[e] - __uint_as_float(frag[F][0][kk][e]));
        }
      }
    };
    // the twelve products of half n of the stage into a fresh acc[n]
    auto products = [&](auto buf, int n, const Cursor& cur) {
      constexpr int F = decltype(buf)::value;
      const uint32_t qs = q_slot(cur) + n * (64 * 128);
      const uint64_t db = sw128_desc(qs), ds = sw128_desc(qs + TILE);
      fence_operands(acc[n]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k8_tf32_rs(acc[n], frag[F][0][kk], ds + 2 * kk, kk > 0);  // big_x small_q
        wgmma_m64n64k8_tf32_rs(acc[n], frag[F][1][kk], db + 2 * kk, true);  // small_x big_q
        wgmma_m64n64k8_tf32_rs(acc[n], frag[F][0][kk], db + 2 * kk, true);  // big_x big_q
      }
      wgmma_commit();
      fence_operands(acc[n]);
    };
    auto add = [&](int n, bool first) {
      fence_operands(acc[n]);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[32 * n + i] = first ? acc[n][i] : sum[32 * n + i] + acc[n][i];
    };
    // the unit's output once its last stage is summed
    auto store = [&](const Cursor& cur) {
      const int pt = p_tile(cur.u);
      if (cur.k != p.nk - 1 || pt >= p.n_pt) return;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = pt * BM + r0 + 8 * h;
        if (row >= p.S || (row & (p.w - 1)) != 0) continue;
        float* o = p.out + static_cast<size_t>(row / p.w) * p.B;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int q = qt * BN + 8 * i + 2 * c;
          const float lo = sum[4 * i + 2 * h], hi = sum[4 * i + 2 * h + 1];
          if ((p.B & 1) == 0) {
            if (q < p.B) *reinterpret_cast<float2*>(o + q) = make_float2(lo, hi);
          } else {
            if (q < p.B) o[q] = lo;
            if (q + 1 < p.B) o[q + 1] = hi;
          }
        }
      }
    };
    // stage cur, its products in flight (half 0, then half 1), and a next
    // stage: sums half 0, starts the next stage's half 0, sums half 1,
    // starts the next stage's half 1, so that the tensor cores always hold
    // one half's products. Returns the next stage.
    auto stage = [&](auto buf, const Cursor& cur) {
      constexpr int F = decltype(buf)::value;
      const std::integral_constant<int, 1 - F> other{};
      const Cursor next = advance(cur);
      wgmma_wait<1>();  // half 0 (and the stage before) done
      add(0, cur.k == 0);
      split_stage(other, next);
      products(other, 0, next);
      wgmma_wait<1>();  // half 1 done
      fence_words(frag[F][0]);
      fence_words(frag[F][1]);
      __syncwarp();
      if (lane == 0) release(empty + 8 * (cur.step % NS));
      add(1, cur.k == 0);
      products(other, 1, next);
      store(cur);
      return next;
    };
    // the last stage: nothing follows
    auto last = [&](auto buf, const Cursor& cur) {
      constexpr int F = decltype(buf)::value;
      wgmma_wait<1>();
      add(0, cur.k == 0);
      wgmma_wait<0>();
      fence_words(frag[F][0]);
      fence_words(frag[F][1]);
      __syncwarp();
      if (lane == 0) release(empty + 8 * (cur.step % NS));
      add(1, cur.k == 0);
      store(cur);
    };
    // stages alternate between the fragment buffers, two a turn; the last
    // one (or two) outside the loop, so that no product is in flight where
    // the loop exits
    const std::integral_constant<int, 0> even{};
    const std::integral_constant<int, 1> odd{};
    if (steps > 0) {
      Cursor cur = {0, 0, 0};
      split_stage(even, cur);
      products(even, 0, cur);
      products(even, 1, cur);
      int left = steps;
      for (; left > 2; left -= 2) {
        cur = stage(even, cur);
        cur = stage(odd, cur);
      }
      if (left == 2) {
        cur = stage(even, cur);
        last(odd, cur);
      } else {
        last(even, cur);
      }
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

// Floats of scratch vrt_matmul_floor_f32 takes: q_big and q_small, [Bp, dp]
// each.
extern "C" long long vrt_matmul_floor_scratch_floats(int B, int d) {
  return 2LL * round_up(B, BN) * round_up(d, BK);
}

// queries f32 [B, d]; payload f32 [S, d]; scratch (above); out f32 [S/w, B]
extern "C" int vrt_matmul_floor_f32(const void* queries, const void* payload, void* scratch,
                                    void* out, int B, int S, int d, int w, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w <= 0 || w > BM || (w & (w - 1)) || S % w)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p = {};
  p.x = static_cast<const float*>(payload);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.S = S;
  p.d = d;
  p.w = w;
  p.Bp = round_up(B, BN);
  const int dp = round_up(d, BK);
  p.nk = dp / BK;
  p.n_pt = (S + BM - 1) / BM;
  p.n_ct = (p.n_pt + CL - 1) / CL;
  p.n_qt = p.Bp / BN;
  p.vec = (reinterpret_cast<uintptr_t>(payload) & 15) == 0 && d % 4 == 0;
  p.resident = p.nk <= NS;

  CUtensorMap map_x, map_q;
  memset(&map_x, 0, sizeof(map_x));
  cudaError_t err = encode_f32_2d(&map_q, scratch, 2ULL * p.Bp, dp, dp, QROWS, BK);
  if (err == cudaSuccess && p.vec) err = encode_f32_2d(&map_x, payload, S, d, d, BM, BK);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n = static_cast<long long>(p.Bp) * dp;
  split_queries<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(queries), static_cast<float*>(scratch), B, d, p.Bp, dp);
  err = cudaGetLastError();

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(matmul_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, matmul_floor_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: the clusters that fit, split evenly over the query tiles
  int lanes = clusters / p.n_qt;
  lanes = lanes < 1 ? 1 : (lanes > p.n_ct ? p.n_ct : lanes);
  p.lanes = lanes;
  const long long grid = static_cast<long long>(p.n_qt) * lanes * CL;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  err = cudaLaunchKernelEx(&cfg, matmul_floor_kernel, map_x, map_q, p);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
