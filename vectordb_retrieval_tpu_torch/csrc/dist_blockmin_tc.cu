// Fused distance + per-block minimum on the tensor cores (wgmma), in all
// three payload modes: f32 (exact-search stage 1, ground truth, the cover
// tree's exact fallback), bf16 (the IVF-Flat fused probed stream, the cover
// tree's block walk) and u8 (the IVF-SQ8 stream).
//
// Replaces the TPU kernel vectordb_retrieval_tpu/ops/pallas_kernels.py
// dist_blockmin_pallas in its f32, bf16 and u8 modes. Computes, for one or
// two pens,
//
//   out[q, g] = min_{j < w} (pen[g*w + j] - 2 * <payload[g*w + j], queries[q]>)
//
// for queries [B, d] (f32 for an f32 payload, else bf16), payload [S, d] f32,
// bf16 or u8, pen [S] f32 (S % w == 0, w a power of two <= 128), out
// [B, S/w] f32, all row-major. The [B, S] score matrix never reaches device
// memory. The pair entry points apply two pens to one product and write two
// outputs (the cover tree's pens of all and of real nodes over one slab), so
// the slab is read and multiplied once. A group whose pens are all +inf gives
// +inf. The kernel is blockmin_tc.cuh's (design, numerics and edges there).
//
// Numerics: bf16/u8 as the TPU modes (one bf16 dot, f32 sums). f32 by
// 3xTF32 (each operand split into tf32 big + small, three products of 8-deep
// slices into one f32 accumulator): f32-class products, finer than the TPU
// kernel's 3-pass bf16 hi/lo split (Precision.HIGH), which is what ranks the
// blocks for the exact rescore that follows. pen - 2 * dot rounds once.
//
// What bounds it on an H100: bf16/u8 do 2 B S d FLOP on the tensor cores
// (989 TFLOP/s bf16) against S d (bf16: 2 S d) payload bytes: at B = 256,
// 256 FLOP per bf16 byte and 512 per u8 byte, near the card's 295 FLOP/byte
// balance; the bf16 IVF stream is bound by its bytes, the u8 stream and the
// cover tree (B = 512, d = 384) by the tensor cores. f32 does three TF32
// products, 6 B S d FLOP at 495 TFLOP/s, against 4 S d bytes: at B = 256,
// 384 FLOP per byte, so it is bound by the tensor cores' TF32 rate (the
// FP32 FFMA units, 67 TFLOP/s, would take 2.5x longer).
//
// Launch rules: runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry points return cudaGetLastError().

#include "blockmin_tc.cuh"

namespace {

using vrt::btc::Mode;

template <Mode M, int NPEN>
int launch(const void* q, const void* x, const void* const* pen, void* const* out,
           int B, int S, int d, int w, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || w <= 0 || w > vrt::btc::BN || (w & (w - 1)) || S % w)
    return static_cast<int>(cudaErrorInvalidValue);
  vrt::btc::Params p = {};
  p.q = q;
  p.x = x;
  for (int e = 0; e < 2; ++e) {
    p.pen[e] = static_cast<const float*>(pen[e < NPEN ? e : 0]);
    p.out[e] = static_cast<float*>(out[e < NPEN ? e : 0]);
  }
  p.B = B;
  p.S = S;
  p.d = d;
  p.w = w;
  p.n_units = (S + vrt::btc::BN - 1) / vrt::btc::BN;
  p.per_unit = 1;
  return vrt::btc::launch<M, NPEN>(p, stream);
}

template <Mode M>
int launch_one(const void* q, const void* x, const void* pen, void* out, int B, int S,
               int d, int w, void* stream) {
  const void* pens[1] = {pen};
  void* outs[1] = {out};
  return launch<M, 1>(q, x, pens, outs, B, S, d, w, stream);
}

template <Mode M>
int launch_pair(const void* q, const void* x, const void* pen_a, const void* pen_b,
                void* out_a, void* out_b, int B, int S, int d, int w, void* stream) {
  const void* pens[2] = {pen_a, pen_b};
  void* outs[2] = {out_a, out_b};
  return launch<M, 2>(q, x, pens, outs, B, S, d, w, stream);
}

}  // namespace

// queries: f32 [B, d]; payload: f32 [S, d]
extern "C" int vrt_dist_blockmin_f32(const void* queries, const void* payload,
                                     const void* pen, void* out, int B, int S,
                                     int d, int w, void* stream) {
  return launch_one<Mode::F32>(queries, payload, pen, out, B, S, d, w, stream);
}

// queries: bf16 bits [B, d]; payload: bf16 bits [S, d]
extern "C" int vrt_dist_blockmin_bf16(const void* queries, const void* payload,
                                      const void* pen, void* out, int B, int S,
                                      int d, int w, void* stream) {
  return launch_one<Mode::BF16>(queries, payload, pen, out, B, S, d, w, stream);
}

// queries: bf16 bits [B, d]; payload: u8 codes [S, d]
extern "C" int vrt_dist_blockmin_u8(const void* queries, const void* payload,
                                    const void* pen, void* out, int B, int S,
                                    int d, int w, void* stream) {
  return launch_one<Mode::U8>(queries, payload, pen, out, B, S, d, w, stream);
}

// Two pens over one product: out_a from pen_a, out_b from pen_b.
extern "C" int vrt_dist_blockmin_pair_bf16(const void* queries, const void* payload,
                                           const void* pen_a, const void* pen_b,
                                           void* out_a, void* out_b, int B, int S,
                                           int d, int w, void* stream) {
  return launch_pair<Mode::BF16>(queries, payload, pen_a, pen_b, out_a, out_b, B, S, d, w,
                                 stream);
}

extern "C" int vrt_dist_blockmin_pair_u8(const void* queries, const void* payload,
                                         const void* pen_a, const void* pen_b,
                                         void* out_a, void* out_b, int B, int S,
                                         int d, int w, void* stream) {
  return launch_pair<Mode::U8>(queries, payload, pen_a, pen_b, out_a, out_b, B, S, d, w,
                               stream);
}

extern "C" const char* vrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
