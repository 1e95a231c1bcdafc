// The persistent tensor-core block-minimum kernel that K1 (dist_blockmin_tc.cu:
// bf16, u8 and f32 payloads), K4 (blockmin.cu: full-L2 minima over
// interleaved blocks) and K3 (assign.cu: nearest centroid) share. One main loop; the
// modes differ in the payload element, in how a stage becomes wgmma
// operands, and in the epilogue. slab_dots.cu (K2) uses its loaders.
//
// Work: one block holds a tile of BM = 128 queries (two warpgroups of 64)
// and walks payload n-tiles of BN = 128 rows. Each warpgroup runs wgmma
// m64n128 over its 64 queries and the 128 rows, accumulating in 64 f32
// registers a thread. d advances in stages of 128 bytes of k (one row of the
// 128B-swizzled K-major layout of wgmma.cuh: 64 bf16 or 32 f32) through a
// ring of NS stages in shared memory, filled by 16-byte cp.async copies that
// every thread issues NS - 1 stages ahead, across tile boundaries; while the
// query tile fits (nk <= NK_RESIDENT stages) it stays in shared memory and
// only the payload streams. Blocks are persistent (as many as fit on the
// card); block i holds query tile i % n_qt and walks units i / n_qt,
// + lanes, ..., so the query tiles of one unit run side by side and the
// payload comes from HBM about once a launch. A unit is one n-tile (K1) or
// the per_unit n-tiles of one column chunk (K4). K3 turns this around: its
// points are many query tiles and its centroids few n-tiles, so a unit is
// one query tile of points walking all per_unit centroid n-tiles, and every
// block walks units (n_qt = 1): the points come from HBM once, the
// centroids from L2. Its query tile is reloaded at each unit; it stays in
// shared memory across the unit's n-tiles where NS <= nk <= NK_RESIDENT (a
// reloaded chunk's last reader is then at least NS steps back).
//
// Modes and their numerics:
//   BF16, U8 (K1): queries rounded to bf16 once; bf16 payload values and u8
//     codes 0-255 are exact in bf16, so every product is exact and the sums
//     are f32: wgmma k16 on bf16 operands. u8 codes are copied raw and
//     converted to bf16 into the swizzled tile in shared memory.
//   F32 (K1), L2 (K4), ASSIGN (K3): 3xTF32. Each staged f32 value v
//     (queries and payload) is split in shared memory, in place, into big =
//     tf32_rna(v) and small = tf32_rna(v - big) (cvt.rna.tf32.f32: the low
//     13 bits zero, ties away
//     from zero, so the product does not depend on how the tensor core
//     treats those bits); each 8-deep k slice issues three wgmma k8 into one
//     f32 accumulator: small_q big_x, big_q small_x, big_q big_x. What is
//     left out (small small, and the rounding of each small) is <= 3 * 2^-22
//     of |q_k x_k|, so each product is f32-class: at least the TPU's
//     Precision.HIGHEST (K4) and finer than its HIGH 3-pass bf16 split (K1
//     f32). A stage holds 32 k of four tiles (q big, q small, x big, x small).
//     At depth the accumulator's adds, not the products, set the error:
//     wgmma's f32 adds into the accumulator (3 a k slice, 144 at d = 384)
//     err by several times cuBLAS's f32 sum on unit vectors. So K1 f32 and
//     K3 let each stage's 12 products start a fresh accumulator and add it
//     into a running sum (one rounded f32 add a stage, 64 more registers);
//     K4 has no registers left for it and keeps one accumulator (its scale,
//     qn + xn, is larger than the dot).
//
// Epilogues. Accumulator column 8i + 2 (lane % 4) + j holds B-tile row of
// that index; the loader puts logical row tile_row(col) of the n-tile there,
// so each thread holds the 32 consecutive logical rows 32 (lane % 4) .. +31
// of two query rows (q0 and q0 + 8).
//   K1: out[q, g] = min_{j < w}(pen[g*w + j] - 2 <x[g*w + j], q>); the
//     n-tile's pens arrive in shared memory with its first stage; a group of
//     w rows (128 % w == 0) is reduced in registers, and for w = 64, 128
//     across 2 or 4 lanes of a quad; compiled for each w. NPEN = 2 applies two
//     pens to one product (the cover tree's pens of all and of real nodes).
//   K4: out[q, t*seg + col] = min_{i < w}(qn[q] + ||x_r||^2 - 2 <x_r, q>),
//     r = t*tile + i*seg + col. A unit owns CW (a power of two, 16 .. 128,
//     <= seg where seg allows; l2_layout) columns c0 .. of tile t and walks
//     its members in per_unit n-tiles of 128 / CW members each: logical row
//     l holds member m*(128/CW) + l / CW, column c0 + l % CW. ||x||^2 is summed in
//     f32 from the staged raw rows (not from the split product) while they
//     are split, and is +inf for slots past w or seg, so they never win. A
//     running minimum of 64 registers a thread is kept elementwise across
//     the unit's n-tiles; at its end the members that share a column meet
//     in registers (CW < 32) and across the quad (CW < 128).
//   K3: ids[p], mins[p] = (argmin, min)_c (pn[p] + cn[c]) - 2 <p, c>, the
//     lowest c among equals. pn is summed in f32 from the staged raw point
//     values while the unit's first n-tile splits them (pn_buffers); cn
//     arrives as the n-tile's pens, +inf past K. After each n-tile a thread
//     folds its 32 ascending centroid columns of its two rows into a running
//     (min, id) with a strict <; at the unit's end the quad meets on the
//     lexicographic order of (min, id). No atomics, deterministic.
//
// Edges: payload rows past S (or past w, seg in K4) and queries past B read
// 0 (copies of 0 bytes zero-fill) and write nothing; k >= d reads 0 in both
// operands, which adds exactly 0. Where rows are not 16-byte aligned (bf16:
// d % 8; u8: d % 16; f32: d % 4 != 0) the same kernel fills the stage with
// masked loads and stores instead of copies.
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise; launch() returns cudaGetLastError().

#pragma once

#include <limits.h>
#include <math.h>

#include "wgmma.cuh"

namespace vrt {
namespace btc {

enum class Mode { BF16, U8, F32, L2, ASSIGN };

constexpr int BM = 128;  // queries per block: two warpgroups of 64
constexpr int BN = 128;  // payload rows per n-tile (wgmma N)
constexpr int NS = 3;    // ring stages
constexpr int NK_RESIDENT = 4;  // nk <= 4: the block's queries stay in shared memory
constexpr int THREADS = 256;
constexpr int RP = THREADS / 8;  // operand rows one pass of 16-byte copies covers
constexpr int TILE_BYTES = BN * 128;  // one 128 x 128-byte swizzled operand tile
static_assert(BM == 64 * (THREADS / 128), "one warpgroup per 64 queries");
static_assert(BM == BN, "operand tiles of queries and payload are alike");
static_assert(BN % (2 * RP) == 0 && RP % 8 == 0, "loader passes cover whole tiles");

template <Mode M>
struct Cfg {
  static constexpr bool TF32 = M == Mode::F32 || M == Mode::L2 || M == Mode::ASSIGN;
  static constexpr int BK = TF32 ? 32 : 64;  // k per stage: 128 bytes
  // tf32 modes keep a big and a small tile of each operand
  static constexpr int A_BYTES = (TF32 ? 2 : 1) * TILE_BYTES;
  static constexpr int RAW_BYTES = M == Mode::U8 ? BN * BK : 0;  // u8 codes, row-major
  static constexpr int STAGE_B = (TF32 ? 2 : 1) * TILE_BYTES + RAW_BYTES;
  // two blocks an SM fit the bf16/u8 stages; the tf32 stages take one
  static constexpr int MIN_BLOCKS = TF32 ? 1 : 2;
  // each stage's products in a fresh accumulator, added into a running sum
  static constexpr bool STAGE_SUM = M == Mode::F32 || M == Mode::ASSIGN;
};

// The query tile stays in shared memory across a unit's n-tiles (K3: it is
// reloaded at every unit, so a reloaded chunk's last reader must lie NS
// steps back).
template <Mode M>
__host__ __device__ __forceinline__ bool resident(int nk) {
  return nk <= NK_RESIDENT && (M != Mode::ASSIGN || nk >= NS);
}

// K3's buffers of point norms: unit u + 1's are written while its first
// n-tile is split, a step ahead of its product, after every epilogue of
// unit u but where nk == 1 (the split of a step runs before the epilogue of
// the step before), which alternates two.
__host__ __device__ __forceinline__ int pn_buffers(int nk) { return nk == 1 ? 2 : 1; }

struct Params {
  const void* q;       // [B, d]: bf16 bits (BF16, U8) or f32 (K3: the points)
  const void* x;       // [S, d]: bf16 bits, u8 codes or f32 (K3: the centroids)
  const float* pen[2]; // K1: pens [S]; K4: pen[0] = ||q||^2 [B]; K3: pen[0] = cn [S]
  float* out[2];       // K3: out[0] = the minima [B]
  int64_t* ids;        // K3: the argmin [B]
  int B, S, d, w, n_qt, nk;
  int vec;  // rows are 16-byte aligned: the stages are filled by cp.async
  int n_units, per_unit;  // the units a launch walks, n-tiles a unit
  // K4: rows a tile, columns a tile, log2 of the columns a unit (CW), units a tile
  int tile, seg, cw_log2, col_chunks;
};

// An n-tile's place: K1 and K3 its first payload row; K4 its tile, first
// column and the member of logical row 0.
struct NTile {
  int n0, t, c0, m0;
};

template <Mode M>
__device__ __forceinline__ NTile ntile(const Params& p, int u, int m) {
  if constexpr (M == Mode::L2) {
    const int t = u / p.col_chunks;
    return {t * p.tile, t, (u - t * p.col_chunks) << p.cw_log2, m * (BN >> p.cw_log2)};
  } else if constexpr (M == Mode::ASSIGN) {
    return {m * BN, 0, 0, 0};
  } else {
    return {u * BN, 0, 0, 0};
  }
}

// The payload row that logical row l of the n-tile holds, or -1 (a row
// past S; in K4 a member past w or a column past seg).
template <Mode M>
__device__ __forceinline__ int payload_row(const Params& p, const NTile& nt, int l) {
  if constexpr (M == Mode::L2) {
    const int member = nt.m0 + (l >> p.cw_log2);
    const int col = nt.c0 + (l & ((1 << p.cw_log2) - 1));
    return member < p.w && col < p.seg ? nt.n0 + member * p.seg + col : -1;
  } else {
    return nt.n0 + l < p.S ? nt.n0 + l : -1;
  }
}

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

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint2 ld_shared_8(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

// The payload row (of the tile's 128) that B-tile row, i.e. accumulator
// column, col holds: thread lane % 4 = c, which holds columns 8i + 2c + j,
// gets rows 32c .. 32c+31 (see the epilogues).
__device__ __forceinline__ int tile_row(int col) {
  return ((col >> 1) & 3) * 32 + (col >> 3) * 2 + (col & 1);
}

// Element types of a staged 16-byte chunk
enum class Elem { BF16, U8, F32 };

// One swizzled 16-byte chunk from k of a row, read with masked scalar
// loads (rows that are not 16-byte aligned): 8 bf16 values (bf16 bits or u8
// codes, converted exactly) or 4 f32 values.
template <Elem E>
__device__ __forceinline__ uint4 masked_chunk(const void* base, int row, int k, int d) {
  const bool ok = row >= 0;
  const size_t off = ok ? static_cast<size_t>(row) * d : 0;
  if constexpr (E == Elem::F32) {
    const float* r = static_cast<const float*>(base) + off;
    uint32_t f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = (ok && k + j < d) ? __float_as_uint(__ldg(r + k + j)) : 0u;
    return make_uint4(f[0], f[1], f[2], f[3]);
  } else if constexpr (E == Elem::BF16) {
    const uint16_t* r = static_cast<const uint16_t*>(base) + off;
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      h[j] = (ok && k + j < d) ? static_cast<uint32_t>(__ldg(r + k + j)) : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                      h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  } else {
    const uint8_t* r = static_cast<const uint8_t*>(base) + off;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = (ok && k + j < d) ? static_cast<float>(__ldg(r + k + j)) : 0.f;
    return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                      bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
}

// The chunk of row (-1: none) from k -> shared dst: a cp.async copy where
// rows are aligned (bf16 bits or f32 only), else masked loads and a store.
template <Elem E>
__device__ __forceinline__ void load_chunk(uint32_t dst, const void* base, int row, int k,
                                           int d, int vec) {
  if constexpr (E != Elem::U8) {
    if (vec) {
      constexpr int ES = E == Elem::F32 ? 4 : 2;
      const bool ok = row >= 0 && k < d;
      const char* src = static_cast<const char*>(base) +
                        (ok ? (static_cast<size_t>(row) * d + k) * ES : 0);
      cp_async_16(dst, src, ok ? 16 : 0);
      return;
    }
  }
  st_shared_16(dst, masked_chunk<E>(base, row, k, d));
}

// The queries' k0 .. k0 + BK - 1 slice of the block's BM rows -> the
// swizzled tile at a (raw f32 in the tf32 modes, split later). Thread t
// copies chunk t % 8 of rows t / 8 + RP i.
template <Mode M>
__device__ __forceinline__ void load_a(const Params& p, uint32_t a, int m0, int k0) {
  constexpr Elem E = Cfg<M>::TF32 ? Elem::F32 : Elem::BF16;
  constexpr int PER = E == Elem::F32 ? 4 : 8;  // values a chunk
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, k = k0 + PER * c;
  const uint32_t dst = a + sw128_offset(r, c);  // + RP * 128 i: row r + RP i
#pragma unroll
  for (int i = 0; i < BM / RP; ++i) {
    const int row = m0 + r + RP * i;
    load_chunk<E>(dst + RP * 128 * i, p.q, row < p.B ? row : -1, k, p.d, p.vec);
  }
}

// The payload's k0 .. k0 + BK - 1 slice of the n-tile -> the swizzled tile
// at b, B-tile row r holding logical row tile_row(r) (u8 with vec: the raw
// codes -> raw, converted by convert_u8). Thread t copies chunk t % 8 of
// B-tile rows t / 8 + RP i, which hold logical rows tile_row(t / 8) + 8 i.
template <Mode M>
__device__ __forceinline__ void load_b(const Params& p, uint32_t b, uint32_t raw,
                                       const NTile& nt, int k0) {
  if constexpr (M == Mode::U8) {
    if (p.vec) {  // 4 chunks of 16 codes a row: rows t / 4 + 2 RP i
      const int r = threadIdx.x >> 2, c = threadIdx.x & 3, k = k0 + 16 * c;
      const int row = nt.n0 + tile_row(r);
      const uint8_t* x = static_cast<const uint8_t*>(p.x);
      const uint8_t* src = x + static_cast<size_t>(row) * p.d + k;
      const size_t stride = static_cast<size_t>(RP / 2) * p.d;
#pragma unroll
      for (int i = 0; i < BN / (2 * RP); ++i) {
        const bool ok = row + (RP / 2) * i < p.S && k < p.d;
        cp_async_16(raw + r * Cfg<M>::BK + 16 * c + 2 * RP * Cfg<M>::BK * i,
                    ok ? src + i * stride : x, ok ? 16 : 0);
      }
      return;
    }
  }
  constexpr Elem E = M == Mode::U8 ? Elem::U8 : (M == Mode::BF16 ? Elem::BF16 : Elem::F32);
  constexpr int PER = E == Elem::F32 ? 4 : 8;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, k = k0 + PER * c;
  const int l = tile_row(r);
  const uint32_t dst = b + sw128_offset(r, c);
#pragma unroll
  for (int i = 0; i < BN / RP; ++i)
    load_chunk<E>(dst + RP * 128 * i, p.x, payload_row<M>(p, nt, l + (RP / 4) * i), k, p.d,
                  p.vec);
}

// u8 with vec: the stage's raw codes -> bf16 into its swizzled payload tile
__device__ __forceinline__ void convert_u8(uint32_t sb, uint32_t raw) {
#pragma unroll
  for (int i = 0; i < BN * 8 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS, r = idx >> 3, c = idx & 7;
    const uint2 v = ld_shared_8(raw + r * Cfg<Mode::U8>::BK + c * 8);
    const uint2 lo = u8x4_to_bf16(v.x), hi = u8x4_to_bf16(v.y);
    st_shared_16(sb + sw128_offset(r, c), make_uint4(lo.x, lo.y, hi.x, hi.y));
  }
}

constexpr int SPLIT_CHUNKS = BN * 8 / THREADS;  // 16-byte chunks a thread splits a tile

// The raw f32 tile at t -> its tf32 big parts in place and its small parts
// at t + TILE_BYTES (the same swizzled offsets). Thread t splits chunk t % 8
// of rows t / 8 + RP i; with SQ it adds each row's squares to xs[i].
template <bool SQ>
__device__ __forceinline__ void split_tf32(uint32_t t, float (&xs)[SPLIT_CHUNKS]) {
#pragma unroll
  for (int i = 0; i < SPLIT_CHUNKS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const uint32_t at = t + sw128_offset(idx >> 3, idx & 7);
    const float4 v = ld_shared_f4(at);
    if constexpr (SQ)
      xs[i] = fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, fmaf(v.x, v.x, xs[i]))));
    const uint4 big = make_uint4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
    const uint4 small = make_uint4(tf32_rna(v.x - __uint_as_float(big.x)),
                                   tf32_rna(v.y - __uint_as_float(big.y)),
                                   tf32_rna(v.z - __uint_as_float(big.z)),
                                   tf32_rna(v.w - __uint_as_float(big.w)));
    st_shared_16(at, big);
    st_shared_16(at + TILE_BYTES, small);
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
    cp_async_4(pen_s + tid * 4, ok ? p.pen[e] + n0 + r : p.pen[e], ok ? 4 : 0);
  }
}

// r[t] = min(r[2t], r[2t+1]) for t < N
template <int N>
__device__ __forceinline__ void halve(float (&r)[32]) {
#pragma unroll
  for (int t = 0; t < N; ++t) r[t] = fminf(r[2 * t], r[2 * t + 1]);
}

// K1: pen - 2 * acc, min over w-groups, written once per group. For its
// query rows q0 and q0 + 8 (h = 0, 1), this thread holds the 32 consecutive
// payload rows nb .. nb+31 (nb = n0 + 32 (lane % 4)): row nb + t in
// acc[4 (t / 2) + 2h + t % 2]. pen_s holds the tile's 128 pens in row
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

// K4, each n-tile: run = min(run, qn + ||x||^2 - 2 acc), elementwise (xn_s
// holds the n-tile's 128 row norms by logical row, +inf for empty slots).
__device__ __forceinline__ void l2_update(float (&run)[64], const float (&acc)[64],
                                          uint32_t xn_s, const float (&qv)[2], int lane) {
  const int c = lane & 3;
#pragma unroll
  for (int t = 0; t < 32; t += 4) {
    const float4 xv = ld_shared_f4(xn_s + (32 * c + t) * 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * t + 2 * h;
      run[i] = fminf(run[i], fmaf(-2.f, acc[i], qv[h] + xv.x));
      run[i + 1] = fminf(run[i + 1], fmaf(-2.f, acc[i + 1], qv[h] + xv.y));
      run[i + 4] = fminf(run[i + 4], fmaf(-2.f, acc[i + 4], qv[h] + xv.z));
      run[i + 5] = fminf(run[i + 5], fmaf(-2.f, acc[i + 5], qv[h] + xv.w));
    }
  }
}

// K4, a unit's end: the members of each of its CW columns meet (logical
// rows l and l + CW share a column), each minimum is written once, and run
// goes back to +inf.
template <int CW>
__device__ __forceinline__ void l2_write(float (&run)[64], const Params& p, const NTile& nt,
                                         int q0, int lane) {
  constexpr int TC = CW < 32 ? CW : 32;  // columns a lane holds after the fold
  const int c = lane & 3;
  const size_t G = static_cast<size_t>(p.S / p.w);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float r[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int i = 4 * (t / 2) + 2 * h + t % 2;
      r[t] = run[i];
      run[i] = INFINITY;
    }
#pragma unroll
    for (int s = 16; s >= CW; s >>= 1)
#pragma unroll
      for (int t = 0; t < s; ++t) r[t] = fminf(r[t], r[t + s]);
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      if constexpr (CW <= 32) r[t] = fminf(r[t], __shfl_xor_sync(0xffffffffu, r[t], 1));
      if constexpr (CW <= 64) r[t] = fminf(r[t], __shfl_xor_sync(0xffffffffu, r[t], 2));
    }
    const int q = q0 + 8 * h;
    if (q >= p.B || 32 * c >= CW) continue;
    float* o = p.out[0] + q * G + static_cast<size_t>(nt.t) * p.seg;
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      const int col = nt.c0 + 32 * c + t;
      if (col < p.seg) o[col] = r[t];
    }
  }
}

// K3, each n-tile: this thread's 32 centroid columns n0 + 32 (lane % 4) ..
// +31 (ascending; cn_s holds the n-tile's cn by row) of its two points
// (pn[h]) folded into its running (min, id); a strict < keeps the lowest
// id, and columns past S never win (+inf).
__device__ __forceinline__ void assign_update(float (&bd)[2], int (&bi)[2], const float (&dots)[64],
                                              uint32_t cn_s, const float (&pn)[2], int n0,
                                              int lane, int S) {
  const int c = lane & 3, nb = n0 + 32 * c;
#pragma unroll
  for (int t = 0; t < 32; t += 4) {
    const float4 cv = ld_shared_f4(cn_s + (32 * c + t) * 4);
    const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = nb + t + j;
      const float cnj = col < S ? cn[j] : INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dist = fmaf(-2.f, dots[4 * ((t + j) / 2) + 2 * h + (t + j) % 2], pn[h] + cnj);
        if (dist < bd[h]) {
          bd[h] = dist;
          bi[h] = col;
        }
      }
    }
  }
}

// K3, a unit's end: the quad meets on the lexicographic order of (min, id)
// (equal minima resolve to the lowest id), lane % 4 == 0 writes its two
// points, and the running state goes back to (+inf, 0).
__device__ __forceinline__ void assign_write(float (&bd)[2], int (&bi)[2], const Params& p,
                                             int q0, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[h], off);
      if (od < bd[h] || (od == bd[h] && oi < bi[h])) {
        bd[h] = od;
        bi[h] = oi;
      }
    }
    const int q = q0 + 8 * h;
    if ((lane & 3) == 0 && q < p.B) {
      p.ids[q] = bi[h];
      p.out[0][q] = bd[h];
    }
    bd[h] = INFINITY;
    bi[h] = 0;
  }
}

template <Mode M, int NPEN>
__global__ void __launch_bounds__(THREADS, Cfg<M>::MIN_BLOCKS)
blockmin_tc_kernel(const Params p) {
  using C = Cfg<M>;
  constexpr bool L2 = M == Mode::L2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t a_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  constexpr bool ASSIGN = M == Mode::ASSIGN;
  const int nk = p.nk;
  const bool res = resident<M>(nk);
  const uint32_t ring = a_base + (res ? nk : NS) * C::A_BYTES;
  // K1, K3: the pens of the n-tiles in flight, n-tile j's in buffer j % NS
  // (a buffer is refilled NS n-tiles later, after that n-tile's epilogue).
  // K4: the row norms of n-tile j in buffer j % 2. K3: then the points'
  // norms of unit u in buffer u % pn_buffers(nk).
  const uint32_t pens = ring + NS * C::STAGE_B;
  const uint32_t pn_base = pens + NS * BN * 4;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // this warpgroup's 64 queries: m0 + 64 wg ..
  const int m0 = (blockIdx.x % p.n_qt) * BM;
  // this block's units: u0, u0 + ustride, ... (query tile fixed; K3: the
  // unit is the query tile, n_qt = 1)
  const int u0 = blockIdx.x / p.n_qt, ustride = gridDim.x / p.n_qt;
  const int units = u0 < p.n_units ? (p.n_units - u0 + ustride - 1) / ustride : 0;
  const int steps = units * p.per_unit * nk;

  // step it: chunk it % nk of the block's n-tile it / nk (unit, member
  // step), in ring stage it % NS. Three cursors walk the steps: the copies
  // (NS - 1 steps ahead), the tf32 split (one step ahead) and the product.
  struct Cursor {
    int j, u, m, k, s;  // n-tile, unit, member step, chunk, stage
  };
  auto advance = [&](Cursor& c) {
    if (++c.s == NS) c.s = 0;
    if (++c.k == nk) {
      c.k = 0;
      ++c.j;
      if (++c.m == p.per_unit) c.m = 0, ++c.u;
    }
  };
  auto a_tile = [&](int s, int k) { return a_base + (res ? k : s) * C::A_BYTES; };
  auto n_tile = [&](const Cursor& c) { return ntile<M>(p, u0 + c.u * ustride, c.m); };
  // the first query row of the step's tile, and whether its chunk of the
  // query tile is staged (and split) at this step
  auto q_tile = [&](const Cursor& c) { return ASSIGN ? (u0 + c.u * ustride) * BM : m0; };
  auto loads_a = [&](const Cursor& c) { return !res || (ASSIGN ? c.m == 0 : c.j == 0); };
  Cursor ci = {0, 0, 0, 0, 0};
  auto issue = [&]() {
    const uint32_t b = ring + ci.s * C::STAGE_B;
    const NTile nt = n_tile(ci);
    if (loads_a(ci)) load_a<M>(p, a_tile(ci.s, ci.k), q_tile(ci), ci.k * C::BK);
    load_b<M>(p, b, b + TILE_BYTES, nt, ci.k * C::BK);
    if constexpr (!L2)
      if (ci.k == 0) load_pens<NPEN>(p, pens + (ci.j % NS) * (NPEN * BN * 4), nt.n0);
    advance(ci);
  };

  float acc[64];
  // K1 f32, K3: each stage's products land in a fresh acc, added into sum
  // with one rounded f32 add a stage (see the note on accumulation)
  constexpr bool STAGE_SUM = C::STAGE_SUM;
  float sum[64];
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) issue();
    cp_async_commit();
  }

  const int lane = tid & 31;
  const int qr = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's row of a tile
  const int q0 = m0 + qr;
  float bd[2] = {INFINITY, INFINITY};  // K3: the running (min, id) of rows qr, qr + 8
  int bi[2] = {0, 0};
  float run[L2 ? 64 : 1];  // K4: the unit's running minima
  float qv[2] = {0.f, 0.f};
  float xs[SPLIT_CHUNKS];  // K4: this thread's partial row norms
  if constexpr (L2) {
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = INFINITY;
#pragma unroll
    for (int h = 0; h < 2; ++h) qv[h] = q0 + 8 * h < p.B ? __ldg(p.pen[0] + q0 + 8 * h) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < SPLIT_CHUNKS; ++i) xs[i] = 0.f;

  // tf32: the step's raw stage -> big and small tiles, in place. A thread
  // splits exactly the chunks it copied (load_a, load_b and split_tf32 map
  // thread t to chunk t % 8 of rows t / 8 + RP i), so its own cp.async wait
  // suffices, and the split of step it + 1 runs while step it's products
  // are in flight. K4: at an n-tile's last chunk its row norms go to buffer
  // j % 2 (the epilogue of n-tile j - 1 may still read the other). K3: the
  // points' squares are summed while the unit's first n-tile splits them,
  // and at its last chunk the norms go to buffer u % pn_buffers(nk).
  auto split_step = [&](const Cursor& c) {
    if (ASSIGN && c.m == 0) {
      split_tf32<true>(a_tile(c.s, c.k), xs);
      if (c.k == nk - 1) {
        const uint32_t pn_s = pn_base + (c.u % pn_buffers(nk)) * (BM * 4);
#pragma unroll
        for (int i = 0; i < SPLIT_CHUNKS; ++i) {
          float v = xs[i];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          xs[i] = 0.f;
          if ((tid & 7) == 0) st_shared_f32(pn_s + ((tid >> 3) + RP * i) * 4, v);
        }
      }
    } else if (loads_a(c)) {
      split_tf32<false>(a_tile(c.s, c.k), xs);
    }
    split_tf32<L2>(ring + c.s * C::STAGE_B, xs);
    if constexpr (L2) {
      if (c.k == nk - 1) {
        const NTile nt = n_tile(c);
        const uint32_t xn_s = pens + (c.j & 1) * (BN * 4);
#pragma unroll
        for (int i = 0; i < SPLIT_CHUNKS; ++i) {
          float v = xs[i];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          xs[i] = 0.f;
          const int l = tile_row((tid >> 3) + RP * i);
          if ((tid & 7) == 0)
            st_shared_f32(xn_s + l * 4, payload_row<M>(p, nt, l) >= 0 ? v : INFINITY);
        }
      }
    }
  };

  Cursor cs = {0, 0, 0, 0, 0}, cp = cs;  // the product's step, the split's
  if constexpr (C::TF32) {
    if (steps > 0) {
      cp_async_wait<NS - 2>();  // this thread's copies of step 0 landed
      split_step(cp);
      advance(cp);
    }
  }
  for (int it = 0; it < steps; ++it) {
    if constexpr (!C::TF32) cp_async_wait<NS - 2>();  // this thread's copies of step it
    fence_proxy_async();
    __syncthreads();  // everyone's copies (tf32: splits) of step it are in; step it - 1 is done
    if (it + NS - 1 < steps) issue();
    cp_async_commit();
    const uint32_t a = a_tile(cs.s, cs.k) + wg * (64 * 128);
    const uint32_t b = ring + cs.s * C::STAGE_B;
    if constexpr (M == Mode::U8) {
      if (p.vec) {
        convert_u8(b, b + TILE_BYTES);
        fence_proxy_async();
        __syncthreads();
      }
    }
    fence_operands(acc);
    wgmma_fence();
    if constexpr (C::TF32) {
      const uint64_t dab = sw128_desc(a), das = sw128_desc(a + TILE_BYTES);
      const uint64_t dbb = sw128_desc(b), dbs = sw128_desc(b + TILE_BYTES);
#pragma unroll
      // a tile's (K1 f32, K3: a stage's) first product overwrites acc
      const bool carry = !STAGE_SUM && cs.k > 0;
#pragma unroll
      for (int kk = 0; kk < C::BK / 8; ++kk) {
        wgmma_m64n128k8_tf32(acc, das + 2 * kk, dbb + 2 * kk, carry || kk > 0);
        wgmma_m64n128k8_tf32(acc, dab + 2 * kk, dbs + 2 * kk, true);
        wgmma_m64n128k8_tf32(acc, dab + 2 * kk, dbb + 2 * kk, true);
      }
    } else {
      const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_m64n128k16_bf16(acc, da + 2 * kk, db + 2 * kk, cs.k > 0 || kk > 0);
    }
    wgmma_commit();
    if constexpr (C::TF32) {
      if (it + 1 < steps) {  // step it + 1's stage, while the products run
        cp_async_wait<NS - 2>();
        split_step(cp);
        advance(cp);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if constexpr (STAGE_SUM) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = cs.k == 0 ? acc[i] : sum[i] + acc[i];
    }
    if (cs.k == nk - 1) {  // the n-tile's product is whole
      if constexpr (L2) {
        l2_update(run, acc, pens + (cs.j & 1) * (BN * 4), qv, lane);
        if (cs.m == p.per_unit - 1) {  // the unit's last members: its minima
          const NTile nt = n_tile(cs);
          switch (p.cw_log2) {
            case 7: l2_write<128>(run, p, nt, q0, lane); break;
            case 6: l2_write<64>(run, p, nt, q0, lane); break;
            case 5: l2_write<32>(run, p, nt, q0, lane); break;
            default: l2_write<16>(run, p, nt, q0, lane); break;
          }
        }
      } else if constexpr (ASSIGN) {
        const uint32_t pn_s = pn_base + (cs.u % pn_buffers(nk)) * (BM * 4);
        const float pn[2] = {ld_shared_f32(pn_s + qr * 4), ld_shared_f32(pn_s + (qr + 8) * 4)};
        assign_update(bd, bi, sum, pens + (cs.j % NS) * (BN * 4), pn, n_tile(cs).n0, lane, p.S);
        if (cs.m == p.per_unit - 1) assign_write(bd, bi, p, q_tile(cs) + qr, lane);
      } else {
        const int n0 = n_tile(cs).n0;
        const float (&dots)[64] = STAGE_SUM ? sum : acc;
#pragma unroll
        for (int e = 0; e < NPEN; ++e) {
          const uint32_t pen_s = pens + ((cs.j % NS) * NPEN + e) * (BN * 4);
          switch (p.w) {
            case 1: epilogue<1>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
            case 2: epilogue<2>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
            case 4: epilogue<4>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
            case 8: epilogue<8>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
            case 16: epilogue<16>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
            case 32: epilogue<32>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
            case 64: epilogue<64>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
            default: epilogue<128>(dots, pen_s, p.out[e], q0, n0, lane, p.B, p.S); break;
          }
        }
      }
    }
    advance(cs);
  }
}

// K4: the columns a unit owns (CW = 2^cw_log2, 16 .. 128, at most seg where
// seg >= 16) and the units that follow, chosen so that the units spread
// evenly over the lanes (blocks a query tile) that fit on the card: the
// fewest n-tiles on the busiest lane, then the widest CW.
inline int l2_layout(Params& p, int lanes_max) {
  const int top = p.seg >= 128 ? 7 : (p.seg >= 64 ? 6 : (p.seg >= 32 ? 5 : 4));
  long long best = -1;
  for (int lg = top; lg >= 4; --lg) {
    const int cw = 1 << lg, chunks = (p.seg + cw - 1) / cw;
    const long long units = static_cast<long long>(p.S / p.tile) * chunks;
    const int per_unit = (p.w + BN / cw - 1) / (BN / cw);
    const long long lanes = units < lanes_max ? units : lanes_max;
    const long long cost = (units + lanes - 1) / lanes * per_unit;
    if (units > INT_MAX || (best >= 0 && cost >= best)) continue;
    best = cost;
    p.cw_log2 = lg;
    p.col_chunks = chunks;
    p.n_units = static_cast<int>(units);
    p.per_unit = per_unit;
  }
  return best < 0 ? static_cast<int>(cudaErrorInvalidValue) : static_cast<int>(cudaSuccess);
}

// Launches the kernel for p (B, S, d, w, q, x, pen, out and, for K1 and K3,
// n_units and per_unit, for K3 ids, for K4 tile and seg, set by the caller;
// the rest here): persistent, as many blocks as fit on the card, each
// walking the units of one query tile (K3: units of query tiles). p.vec
// needs 16-byte aligned rows.
template <Mode M, int NPEN>
int launch(Params p, void* stream) {
  using C = Cfg<M>;
  constexpr int VEC_ALIGN = M == Mode::U8 ? 16 : (C::TF32 ? 4 : 8);  // elements
  // K3's blocks all walk units of query tiles
  p.n_qt = M == Mode::ASSIGN ? 1 : (p.B + BM - 1) / BM;
  p.nk = (p.d + C::BK - 1) / C::BK;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.x)) & 15) == 0;
  p.vec = aligned && p.d % VEC_ALIGN == 0;
  const int a_tiles = resident<M>(p.nk) ? p.nk : NS;
  const int pen_bytes = M == Mode::L2 ? 2 * BN * 4
                                      : NS * NPEN * BN * 4 +
                                            (M == Mode::ASSIGN ? pn_buffers(p.nk) * BM * 4 : 0);
  const int smem = a_tiles * C::A_BYTES + NS * C::STAGE_B + pen_bytes + 1024;
  auto kernel = blockmin_tc_kernel<M, NPEN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int lanes = (per_sm > 0 ? per_sm : 1) * sms / p.n_qt;
  lanes = lanes < 1 ? 1 : lanes;
  if constexpr (M == Mode::L2) {
    const int rc = l2_layout(p, lanes);
    if (rc != cudaSuccess) return rc;
  }
  lanes = lanes > p.n_units ? p.n_units : lanes;
  const long long blocks = static_cast<long long>(p.n_qt) * lanes;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace btc
}  // namespace vrt
