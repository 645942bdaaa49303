// The int8 epilogue arithmetic shared by resnet_int8.cu (the conv's
// requant and fused pre-activation), k2_unit.cu (K2) and int8_root.cu (the
// int8 max pool's fused pre-activation): saturating round-to-int8, the
// branch-free exact division of the pre-activation's modes 1 and 3, and the
// pre-activation quantiser itself. Every multiply and add names its rounding
// (__fmul_rn, __fadd_rn, __fmaf_rn), so nvcc's contraction cannot change
// which operations are fused.
//
// Pre-activation modes (keep in step with resnet_int8_cuda.py's Preact):
//   0 K2's, from the bf16 stream:      clip(rint(max(fma(v, a, b), 0)), 0, 127)
//   1 the XLA path's, from the bf16 stream: clip(rint(p / s), 0, 127),
//     p = max(bf16(bf16(v * a) + b), 0)
//   2 from the int8 stream (int8_stream): mode 0's arithmetic on the int8
//     value q, a = s_stream * A / s_p, b = B / s_p
//   3 at an int8 -> bf16 block boundary: mode 1's arithmetic on the value
//     the boundary's dequantisation makes, bf16(q * ds), ds = bf16(s_stream)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace int8_epilogue {

// clip(rint(v), lo, 127) for an integer lo, as the low byte of the result
// (two's complement). Clamping first is the same (rint is monotonic and the
// bounds are integers); adding 1.5 * 2^23, where a float's ulp is 1, rounds
// half to even as rintf does, and leaves the integer in the low bits:
// FMA-pipe operations only, no FRND and F2I, which issue at 1/8 the rate.
__device__ __forceinline__ uint32_t sat_s8(float v, float lo) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, lo), 127.f), 12582912.f));
}

// Four sat_s8 results -> 4 packed int8, a first.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The reciprocal quot_clip works from: RN(1 / s) where s lies in
// [2^-40, 2^40], else 0, which sends the caller to __fdiv_rn.
__device__ __forceinline__ float div_recip(float s) {
  return (s >= 0x1p-40f && s <= 0x1p40f) ? __frcp_rn(s) : 0.f;
}

// min(RN(p / s), 256) for a p >= 0 that is not NaN, with y = div_recip(s)
// nonzero, without a branch. p <= s / 4 gives a quotient at most 0.25 and
// p >= 256 s one of at least 256, which round and clip to 0 and 127 as the
// exact quotient would. Between them, p * y refined by two residual steps
// q' = RN(q + RN(p - s * q) * y) is the correctly rounded quotient: after
// the first q is within one ulp of p / s, and with y within half an ulp of
// 1 / s the second rounds correctly (Markstein's theorem), nothing under-
// or overflowing for s in [2^-40, 2^40]. Five FMA-pipe operations, where
// __fdiv_rn takes a 1/8-rate reciprocal, a range check and a branch per
// element, and its slow path for p = 0 (half the values, after the ReLU).
__device__ __forceinline__ float quot_clip(float p, float s, float y) {
  float q = __fmul_rn(p, y);
  q = __fmaf_rn(__fmaf_rn(-s, q, p), y, q);
  q = __fmaf_rn(__fmaf_rn(-s, q, p), y, q);
  return p <= 0.25f * s ? 0.f : (p >= 256.f * s ? 256.f : q);
}

// Two bf16 roundings in one conversion: (bf16(x), bf16(y)) as f32.
__device__ __forceinline__ float2 bf16_round2(float x, float y) {
  return __bfloat1622float2(__floats2bfloat162_rn(x, y));
}

// Mode 1's pre-activation p = max(bf16(bf16(v * a) + b), 0) of channels
// j and j + 1.
__device__ __forceinline__ float2 preact_p2(const float (&v)[8],
                                            const float (&a)[8],
                                            const float (&b)[8], int j) {
  const float2 t = bf16_round2(__fmul_rn(v[j], a[j]),
                               __fmul_rn(v[j + 1], a[j + 1]));
  const float2 u = bf16_round2(__fadd_rn(t.x, b[j]), __fadd_rn(t.y, b[j + 1]));
  return make_float2(fmaxf(u.x, 0.f), fmaxf(u.y, 0.f));
}

// Whether a mode divides by the scale s (modes 1 and 3).
__device__ __forceinline__ bool preact_divides(int mode) { return mode & 1; }

// The value of int8 q (held as f32) that a mode-2 or mode-3 pre-activation
// quantises: q itself, or bf16(q * ds) for mode 3 (exact product: 8 bits by
// 8, one bf16 rounding, as XLA's bf16 multiply).
__device__ __forceinline__ float preact_in_s8(float q, float ds, int mode) {
  return mode == 3 ? __bfloat162float(__float2bfloat16_rn(__fmul_rn(q, ds)))
                   : q;
}

// The integer value of a sat_s8 result, as f32 (exact: the magic number's
// subtraction).
__device__ __forceinline__ float s8_value(uint32_t q) {
  return __fsub_rn(__uint_as_float(q), 12582912.f);
}

// Pre-activation + quantisation of 8 values v (held as f32: bf16 values
// for modes 0 and 1, the preact_in_s8 values for modes 2 and 3), packed as
// 8 int8:
//   modes 0 and 2: clip(rint(max(fma(v, a, b), 0)), 0, 127)
//   modes 1 and 3: clip(rint(p / s), 0, 127), p as preact_p2, with a and b
//          bf16 values held as f32 and y = div_recip(s)
// The mode and y branches stay outside the per-channel work, so that a
// caller's loop over rows can hoist them.
__device__ __forceinline__ uint2 preact_q8(const float (&v)[8],
                                           const float (&pa)[8],
                                           const float (&pb)[8], float s,
                                           float y, int mode) {
  uint32_t q[8];
  if (!preact_divides(mode)) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      q[j] = sat_s8(fmaxf(__fmaf_rn(v[j], pa[j], pb[j]), 0.f), 0.f);
  } else if (y != 0.f) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 p = preact_p2(v, pa, pb, j);
      q[j] = sat_s8(quot_clip(p.x, s, y), 0.f);
      q[j + 1] = sat_s8(quot_clip(p.y, s, y), 0.f);
    }
  } else {  // s outside [2^-40, 2^40]
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 p = preact_p2(v, pa, pb, j);
      q[j] = sat_s8(__fdiv_rn(p.x, s), 0.f);
      q[j + 1] = sat_s8(__fdiv_rn(p.y, s), 0.f);
    }
  }
  return make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
}

// preact_q8's arithmetic on two channels (v0, v1) with operands (a0, b0),
// (a1, b1): the two sat_s8 results (K2's fragment pairs).
__device__ __forceinline__ uint2 preact_q2(float v0, float v1, float a0,
                                           float a1, float b0, float b1,
                                           float s, float y, int mode) {
  if (!preact_divides(mode))
    return make_uint2(sat_s8(fmaxf(__fmaf_rn(v0, a0, b0), 0.f), 0.f),
                      sat_s8(fmaxf(__fmaf_rn(v1, a1, b1), 0.f), 0.f));
  const float2 t = bf16_round2(__fmul_rn(v0, a0), __fmul_rn(v1, a1));
  const float2 u = bf16_round2(__fadd_rn(t.x, b0), __fadd_rn(t.y, b1));
  const float p0 = fmaxf(u.x, 0.f), p1 = fmaxf(u.y, 0.f);
  if (y != 0.f)
    return make_uint2(sat_s8(quot_clip(p0, s, y), 0.f),
                      sat_s8(quot_clip(p1, s, y), 0.f));
  return make_uint2(sat_s8(__fdiv_rn(p0, s), 0.f),
                    sat_s8(__fdiv_rn(p1, s), 0.f));
}

}  // namespace int8_epilogue
