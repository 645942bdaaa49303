// int8 ResNet-50 v2 kernels for Hopper (sm_90a): an implicit-GEMM int8
// convolution on warpgroup MMAs with per-output-channel epilogues (and,
// optionally, the next unit's pre-activation quantiser fused into them), and
// the standalone pre-activation + quantisation pass, from the bf16 residual
// stream or from the int8 one (int8_stream).
//
// Replaces, together with the wrapper human_dynamics_tpu_torch/ops/resnet_int8_cuda.py,
// the XLA integer convolutions of human_dynamics_tpu/models/resnet_int8.py
// (_conv_s8, requant, dequant) and its preact + quant, for the units K2
// (k2_unit.cu) does not take. The requant and dequant epilogues' multiply-add
// is fused (FLAG_FMA: XLA contracts it on the CPU, and K2 fuses it) or a
// separate multiply and add. The int8 residual
// stream's conv3 epilogue (resnet_int8.py:633-650, the "stream" epilogue)
// and its pre-activations (:565-576, modes 2 and 3 of int8_epilogue.cuh)
// follow XLA's contractions on the CPU: res = fma(y, m, a), then
// fma(q, k, res) for an int8 identity shortcut q (k = sc_s / s_out) or
// res + sc / s_out for a bf16 projection shortcut sc.
//
// conv: out[m, co] = epilogue(sum_k A[m, k] * Wt[co, k]), int32 accumulation.
//   A is the implicit im2col view of x (N, H, W, Cin) int8 NHWC: row m is an
//   output pixel (n, ho, wo), column k = (ky * ks + kx) * Cin + ci, i.e. the
//   flattened HWIO order; taps outside the image read 0 (exact: the
//   quantisation is symmetric, so 0 is real 0). Padding is (ks - 1) / 2 on
//   both sides, which is SAME at stride 1 and slim conv2d_same at stride 2.
//   Wt is the weight as (Cout, K) with K contiguous.
//
// What bounds it: bytes for most of the trunk's 1x1 convs (a bf16 residual
// in and a bf16 map out per element, against K = 64-512 int8 MACs), int8
// tensor-core operations for the 3x3 convs and the 1x1 convs with K >= 1024.
//
// Design (hopper_s8.cuh has the building blocks):
// - Block tile 128 pixels x BN (64 or 128) output channels, 256 threads =
//   two warpgroups of 64 x BN int32 accumulators each, issuing
//   wgmma.mma_async m64nNk32 s8 with A and B in shared memory.
// - K in slices of BK bytes (128 with the 128-byte swizzle; 64 with the
//   64-byte swizzle on the TMA path where Cin is not a multiple of 128,
//   e.g. block 1's 64 channels), a ring of 3-4 stages with one mbarrier
//   each and one CTA barrier per slice.
// - 1x1 stride-1 convs (a plain GEMM, (M, Cin) x (Cout, Cin)^T): A and B by
//   TMA from 2-D tensor maps built on the host; out-of-bounds rows and
//   columns (ragged M, Cout and K edges) arrive as zeros.
// - Every other geometry: B by TMA, A gathered with 16-byte cp.async that
//   writes the swizzled layout itself, zero fill for padding taps.
// - Epilogue through shared memory: the accumulators go to the freed ring,
//   then each thread takes 4-16 consecutive channels of a row (16 bytes of
//   output, 8 for int8 with Cout % 16 != 0) with their multipliers loaded
//   once, reads the residual the same way (all its rows' loads in flight
//   at once, from L2: the tile's residual rows are prefetched there when
//   the main loop starts), and stores whole lines.
// - Fused pre-activation: the dequant-with-residual and residual epilogues
//   can also write the next unit's int8 pre-activation from the bf16 value
//   they store (1 extra byte per element instead of a pass of 3); the
//   stream epilogue from the int8 value it stores (modes 2 and 3).
// - Stream epilogue: its int8 identity shortcut may be read strided (the
//   stride-2 last unit of blocks 1-3 reads x[:, ::2, ::2]) by index
//   arithmetic, so no subsampled copy is made.
//
// Rounding: int32 -> f32 by __int2float_rn, f32 -> int8 half to even as
// rintf and jnp.round (by a magic-number add, see sat_s8), f32 -> bf16 by
// __floats2bfloat162_rn. Every multiply and add names its rounding
// (__fmul_rn, __fadd_rn, __fmaf_rn), so nvcc's contraction cannot change
// which operations are fused; mode 1's division is exact without __fdiv_rn
// (see quot_clip).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_s8.cuh"
#include "int8_epilogue.cuh"

namespace {

using namespace hopper;
using namespace int8_epilogue;

// Epilogues (keep in step with resnet_int8_cuda.py).
constexpr int kEpiInt32 = 0;     // int32 accumulators
constexpr int kEpiRequant = 1;   // int8 clip(rint(y*m + a), lo, 127)
constexpr int kEpiDequant = 2;   // bf16(y*m + a or fma) [relu] [+ bf16 residual]
constexpr int kEpiDequantF32 = 3;  // f32 fma(y, m, a)
constexpr int kEpiResidual = 4;  // bf16(fma(y, m, shortcut) + a)
constexpr int kEpiStream = 5;    // int8 clip(rint(fma(y, m, a) + shortcut term))

constexpr int kFlagFma = 1;      // requant, dequant: fma(y, m, a), not y*m + a
constexpr int kFlagRelu = 2;     // requant: lo = 0; dequant: max(., 0)
constexpr int kFlagResBf16 = 4;  // residual / shortcut operand is bf16 (else f32)
constexpr int kFlagResS8 = 8;    // stream: int8 shortcut times *rsc (else bf16 / *rsc)

// Main-loop paths.
constexpr int kPathTma = 0;      // 1x1 stride 1: A and B by TMA
constexpr int kPathGather = 1;   // other geometries: A by cp.async gather

// Error codes of the launch functions besides cudaError_t.
constexpr int kErrNoEncoder = -1;   // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = -2;   // the driver refused a tensor map
constexpr int kErrTile = -3;        // a path / tile the library does not have

constexpr int kBM = 128;
constexpr int kThreads = 256;
constexpr int kStgPad = 8;       // int32 pad of a staged accumulator row

struct ConvParams {
  const int8_t* x;
  const int8_t* wt;
  void* out;
  const float* mul;
  const float* add;
  const void* res;
  int8_t* pq;           // fused pre-activation output, or null
  const float* pa;
  const float* pb;
  const float* ps;
  const float* pds;     // mode 3's dequantisation scale
  const float* rsc;     // stream: the shortcut's multiplier or divisor
  int pmode;
  int n, h, w, cin, cout, ks, stride, pad, ho, wo, k, m;
  int epi, flags;
  int rh, rw, rstride;  // stream: the int8 shortcut's map and its stride
};

// Element offset of the residual row of output row m: row m itself, or for
// the stream epilogue's strided int8 shortcut the pixel (n, oy * rstride,
// ox * rstride) of its (rh, rw) map.
__device__ __forceinline__ size_t res_offset(const ConvParams& p, int m) {
  if (p.rstride == 1 && p.rh == p.ho && p.rw == p.wo) return (size_t)m * p.cout;
  const int hw = p.ho * p.wo;
  const int nb = m / hw;
  const int r = m - nb * hw;
  const int oy = r / p.wo;
  const int ox = r - oy * p.wo;
  return (((size_t)nb * p.rh + (size_t)oy * p.rstride) * p.rw +
          (size_t)ox * p.rstride) * p.cout;
}

template <int BN, int BK>
struct Tile {
  static constexpr int kStages = BK == 128 ? 3 : 4;
  static constexpr int kA = kBM * BK;
  static constexpr int kB = BN * BK;
  static constexpr int kStage = kA + kB;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kStaging = kBM * (BN + kStgPad) * 4;
  static constexpr int kBars = kRing > kStaging ? kRing : kStaging;
  // + the barriers + slack to align the base to 1024 bytes.
  static constexpr int kSmem = kBars + kStages * 8 + 1024;
  static_assert(kStage % 1024 == 0, "stages must keep 1024-byte alignment");
  static_assert(BN == 64 || BN == 128, "one m64n64 or m64n128 wgmma per k32");
};

// Chunk j of row r of a swizzled K-major tile with BK-byte rows.
template <int BK>
__device__ __forceinline__ int swizzled(int r, int j) {
  return BK == 128 ? r * 128 + ((j ^ (r & 7)) << 4)
                   : r * 64 + ((j ^ ((r >> 1) & 3)) << 4);
}

template <int C>
__device__ __forceinline__ void load_ints(const int* s, int (&v)[C]) {
#pragma unroll
  for (int i = 0; i < C; i += 4) {
    const int4 q = *reinterpret_cast<const int4*>(s + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

template <int C>
__device__ __forceinline__ void load_cols(const float* src, int c, int n,
                                          float (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = j < n ? __ldg(src + c + j) : 0.f;
}

// The bf16-output epilogues (dequant, residual) of one tile, 8 channels a
// thread: every residual row this thread needs is loaded before the first
// is used, so kIt loads are in flight at once.
template <int BN, bool kResF32>
__device__ __forceinline__ void epilogue_bf16(const ConvParams& p,
                                              const int* stg, int m0,
                                              int n0) {
  constexpr int C = 8, kCh = BN / C, kStep = kThreads / kCh;
  constexpr int kIt = kBM / kStep, kLd = BN + kStgPad;
  const int tid = threadIdx.x;
  const int cl = (tid % kCh) * C, c = n0 + cl, r0 = tid / kCh;
  if (c >= p.cout) return;
  const bool dequant = p.epi == kEpiDequant;
  const bool fused = p.flags & kFlagFma;
  const bool relu = p.flags & kFlagRelu;
  const bool has_res = p.res != nullptr;
  uint4 raw[kIt][kResF32 ? 2 : 1] = {};
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int m = m0 + r0 + i * kStep;
    if (has_res && m < p.m) {
      const size_t o = (size_t)m * p.cout + c;
      if constexpr (kResF32) {
        const uint4* src =
            reinterpret_cast<const uint4*>(static_cast<const float*>(p.res) + o);
        raw[i][0] = src[0];
        raw[i][1] = src[1];
      } else {
        raw[i][0] = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.res) + o);
      }
    }
  }
  float mv[C], av[C], pa[C], pb[C];
  load_cols<C>(p.mul, c, C, mv);
  load_cols<C>(p.add, c, C, av);
  float ps = 1.f, py = 1.f;
  if (p.pq != nullptr) {
    load_cols<C>(p.pa, c, C, pa);
    load_cols<C>(p.pb, c, C, pb);
    if (preact_divides(p.pmode)) {
      ps = __ldg(p.ps);
      py = div_recip(ps);
    }
  }
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int r = r0 + i * kStep;
    if (m0 + r >= p.m) break;
    const size_t o = (size_t)(m0 + r) * p.cout + c;
    int acc[C];
    load_ints<C>(stg + r * kLd + cl, acc);
    float res[C];
    if constexpr (kResF32) {
      const float* rf = reinterpret_cast<const float*>(raw[i]);
#pragma unroll
      for (int j = 0; j < C; ++j) res[j] = rf[j];
    } else {
      const __nv_bfloat162* rb =
          reinterpret_cast<const __nv_bfloat162*>(&raw[i][0]);
#pragma unroll
      for (int j = 0; j < C / 2; ++j) {
        const float2 f = __bfloat1622float2(rb[j]);
        res[2 * j] = f.x;
        res[2 * j + 1] = f.y;
      }
    }
    float v[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float y = __int2float_rn(acc[j]);
      if (dequant) {
        v[j] = fused ? __fmaf_rn(y, mv[j], av[j])
                     : __fadd_rn(__fmul_rn(y, mv[j]), av[j]);
      } else {
        v[j] = __fadd_rn(__fmaf_rn(y, mv[j], res[j]), av[j]);
      }
    }
    uint4 packed;
    __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      if (dequant) {
        // bf16(y*m + a), [relu], [+ residual, rounded once to bf16]
        float2 d = bf16_round2(v[2 * j], v[2 * j + 1]);
        if (relu) {
          d.x = fmaxf(d.x, 0.f);
          d.y = fmaxf(d.y, 0.f);
        }
        if (has_res) {
          d.x = __fadd_rn(res[2 * j], d.x);
          d.y = __fadd_rn(res[2 * j + 1], d.y);
        }
        ob[j] = __floats2bfloat162_rn(d.x, d.y);
      } else {
        ob[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      }
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o) = packed;
    if (p.pq != nullptr) {
      float stored[C];
#pragma unroll
      for (int j = 0; j < C / 2; ++j) {
        const float2 f = __bfloat1622float2(ob[j]);
        stored[2 * j] = f.x;
        stored[2 * j + 1] = f.y;
      }
      *reinterpret_cast<uint2*>(p.pq + o) = preact_q8(stored, pa, pb, ps, py,
                                                     p.pmode);
    }
  }
}

// The stream epilogue of one tile (int8_stream's conv3), 8 channels a
// thread: res = fma(y, m, a), then + the shortcut term, fma(q, rsc, res) for
// an int8 shortcut q or res + sc / rsc (correctly rounded) for a bf16 one,
// then int8 clip(rint(res), -127, 127); with pq, the next unit's
// pre-activation (mode 2 or 3) of the int8 value stored. Every shortcut row
// this thread needs is loaded before the first is used.
template <int BN>
__device__ __forceinline__ void epilogue_stream(const ConvParams& p,
                                                const int* stg, int m0,
                                                int n0) {
  constexpr int C = 8, kCh = BN / C, kStep = kThreads / kCh;
  constexpr int kIt = kBM / kStep, kLd = BN + kStgPad;
  const int tid = threadIdx.x;
  const int cl = (tid % kCh) * C, c = n0 + cl, r0 = tid / kCh;
  if (c >= p.cout) return;
  const bool s8 = p.flags & kFlagResS8;
  uint4 raw[kIt];
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    raw[i] = make_uint4(0, 0, 0, 0);
    const int m = m0 + r0 + i * kStep;
    if (m < p.m) {
      const size_t o = res_offset(p, m) + c;
      if (s8) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(p.res) + o);
        raw[i].x = v.x;
        raw[i].y = v.y;
      } else {
        raw[i] = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.res) + o);
      }
    }
  }
  float mv[C], av[C], pa[C], pb[C];
  load_cols<C>(p.mul, c, C, mv);
  load_cols<C>(p.add, c, C, av);
  const float rs = __ldg(p.rsc);
  float ps = 1.f, py = 1.f, ds = 1.f;
  if (p.pq != nullptr) {
    load_cols<C>(p.pa, c, C, pa);
    load_cols<C>(p.pb, c, C, pb);
    if (preact_divides(p.pmode)) {
      ps = __ldg(p.ps);
      py = div_recip(ps);
    }
    if (p.pmode == 3) ds = __ldg(p.pds);
  }
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int r = r0 + i * kStep;
    if (m0 + r >= p.m) break;
    const size_t o = (size_t)(m0 + r) * p.cout + c;
    int acc[C];
    load_ints<C>(stg + r * kLd + cl, acc);
    float sc[C];
    if (s8) {
      const int8_t* rb = reinterpret_cast<const int8_t*>(&raw[i]);
#pragma unroll
      for (int j = 0; j < C; ++j) sc[j] = __int2float_rn(rb[j]);
    } else {
      const __nv_bfloat162* rb = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
      for (int j = 0; j < C / 2; ++j) {
        const float2 f = __bfloat1622float2(rb[j]);
        sc[2 * j] = f.x;
        sc[2 * j + 1] = f.y;
      }
    }
    uint32_t q[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float v = __fmaf_rn(__int2float_rn(acc[j]), mv[j], av[j]);
      q[j] = sat_s8(s8 ? __fmaf_rn(sc[j], rs, v)
                       : __fadd_rn(v, __fdiv_rn(sc[j], rs)), -127.f);
    }
    *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
    if (p.pq != nullptr) {
      float v[C];
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = preact_in_s8(s8_value(q[j]), ds, p.pmode);
      *reinterpret_cast<uint2*>(p.pq + o) = preact_q8(v, pa, pb, ps, py, p.pmode);
    }
  }
}

// Epilogue of one 128 x BN tile whose int32 accumulators are staged in
// shared memory (row stride BN + kStgPad). Thread t takes the C channels
// starting at column (t % (BN / C)) * C of every (256 / (BN / C))-th row,
// so its per-column operands are loaded once and a warp's stores cover
// whole lines.
template <int BN>
__device__ __forceinline__ void epilogue(const ConvParams& p, const int* stg,
                                         int m0, int n0) {
  constexpr int kLd = BN + kStgPad;
  const int tid = threadIdx.x;
  switch (p.epi) {
    case kEpiInt32: {
      constexpr int C = 4, kCh = BN / C, kStep = kThreads / kCh;
      const int cl = (tid % kCh) * C, c = n0 + cl;
      if (c >= p.cout) return;
      int* out = static_cast<int*>(p.out);
      for (int r = tid / kCh; r < kBM && m0 + r < p.m; r += kStep)
        *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * p.cout + c) =
            *reinterpret_cast<const int4*>(stg + r * kLd + cl);
      return;
    }
    case kEpiRequant: {
      constexpr int C = 16, kCh = BN / C, kStep = kThreads / kCh;
      const int cl = (tid % kCh) * C, c = n0 + cl;
      if (c >= p.cout) return;
      const int nv = min(C, p.cout - c);  // 16, or 8 at the Cout edge
      const bool vec16 = nv == C && (p.cout & 15) == 0;
      float mv[C], av[C];
      load_cols<C>(p.mul, c, nv, mv);
      load_cols<C>(p.add, c, nv, av);
      const bool fused = p.flags & kFlagFma;
      const float lo = (p.flags & kFlagRelu) ? 0.f : -127.f;
      for (int r = tid / kCh; r < kBM && m0 + r < p.m; r += kStep) {
        int acc[C];
        load_ints<C>(stg + r * kLd + cl, acc);
        uint32_t q[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float y = __int2float_rn(acc[j]);
          const float v = fused ? __fmaf_rn(y, mv[j], av[j])
                                : __fadd_rn(__fmul_rn(y, mv[j]), av[j]);
          q[j] = sat_s8(v, lo);
        }
        const uint4 packed = make_uint4(
            pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
            pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
        int8_t* dst = static_cast<int8_t*>(p.out) + (size_t)(m0 + r) * p.cout + c;
        if (vec16) {
          *reinterpret_cast<uint4*>(dst) = packed;
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(packed.x, packed.y);
          if (nv == C)
            *reinterpret_cast<uint2*>(dst + 8) = make_uint2(packed.z, packed.w);
        }
      }
      return;
    }
    case kEpiDequantF32: {
      constexpr int C = 4, kCh = BN / C, kStep = kThreads / kCh;
      const int cl = (tid % kCh) * C, c = n0 + cl;
      if (c >= p.cout) return;
      float mv[C], av[C];
      load_cols<C>(p.mul, c, C, mv);
      load_cols<C>(p.add, c, C, av);
      for (int r = tid / kCh; r < kBM && m0 + r < p.m; r += kStep) {
        int acc[C];
        load_ints<C>(stg + r * kLd + cl, acc);
        float4 v;
        v.x = __fmaf_rn(__int2float_rn(acc[0]), mv[0], av[0]);
        v.y = __fmaf_rn(__int2float_rn(acc[1]), mv[1], av[1]);
        v.z = __fmaf_rn(__int2float_rn(acc[2]), mv[2], av[2]);
        v.w = __fmaf_rn(__int2float_rn(acc[3]), mv[3], av[3]);
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) +
                                   (size_t)(m0 + r) * p.cout + c) = v;
      }
      return;
    }
    case kEpiDequant:
      epilogue_bf16<BN, false>(p, stg, m0, n0);
      return;
    case kEpiResidual:
      if (p.flags & kFlagResBf16) {
        epilogue_bf16<BN, false>(p, stg, m0, n0);
      } else {
        epilogue_bf16<BN, true>(p, stg, m0, n0);
      }
      return;
    case kEpiStream:
      epilogue_stream<BN>(p, stg, m0, n0);
      return;
  }
}

template <int BN, int BK, bool kTmaA>
__global__ void __launch_bounds__(kThreads, 2)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b,
                      const ConvParams p, int n_tiles) {
  using T = Tile<BN, BK>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBars);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k_tiles = (p.k + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  // Gather path: this thread's 16-byte chunk column and its A rows (their
  // image, top-left input corner and whether the output pixel exists).
  constexpr int kCpr = BK / 16;
  constexpr int kRowStep = kThreads / kCpr;
  constexpr int kRows = kBM / kRowStep;
  const int jc = tid % kCpr;
  const int8_t* a_base[kRows];
  int a_ih[kRows], a_iw[kRows];
  bool a_ok[kRows];
  if (!kTmaA) {
    const int hw_out = p.ho * p.wo;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + tid / kCpr + i * kRowStep;
      a_ok[i] = m < p.m;
      const int mm = a_ok[i] ? m : 0;
      const int nb = mm / hw_out;
      const int r = mm - nb * hw_out;
      const int oy = r / p.wo;
      const int ox = r - oy * p.wo;
      a_base[i] = p.x + (size_t)nb * p.h * p.w * p.cin;
      a_ih[i] = oy * p.stride - p.pad;
      a_iw[i] = ox * p.stride - p.pad;
    }
  }

  // Fill stage kt % S with K slice kt.
  auto issue = [&](int kt) {
    const int s = kt % S;
    uint8_t* a_s = smem + s * T::kStage;
    uint8_t* b_s = a_s + T::kA;
    if (tid == 0) {
      mbar_arrive_expect_tx(&full[s], kTmaA ? T::kStage : T::kB);
      if (kTmaA) tma_load_2d(a_s, &tm_a, kt * BK, m0, &full[s]);
      tma_load_2d(b_s, &tm_b, kt * BK, n0, &full[s]);
    }
    if (!kTmaA) {
      const int k = kt * BK + jc * 16;
      const bool k_ok = k < p.k;
      int ci = 0, ky = 0, kx = 0;
      if (k_ok) {
        const int tap = k / p.cin;
        ci = k - tap * p.cin;
        ky = tap / p.ks;
        kx = tap - ky * p.ks;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = tid / kCpr + i * kRowStep;
        const int ih = a_ih[i] + ky, iw = a_iw[i] + kx;
        const bool ok = k_ok && a_ok[i] && ih >= 0 && ih < p.h && iw >= 0 &&
                        iw < p.w;
        const int8_t* src =
            ok ? a_base[i] + ((size_t)ih * p.w + iw) * p.cin + ci : p.x;
        cp_async16(a_s + swizzled<BK>(row, jc), src, ok);
      }
      cp_async_commit();
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int kt = 0; kt < S - 1; ++kt) {
    if (kt < k_tiles) {
      issue(kt);
    } else if (!kTmaA) {
      cp_async_commit();  // keep one cp.async group per slot
    }
  }
  // The epilogue's residual rows, fetched into L2 while the main loop runs.
  if (p.res != nullptr && tid < kBM && m0 + tid < p.m) {
    const int esize =
        (p.epi == kEpiStream && (p.flags & kFlagResS8)) ? 1
        : (p.epi == kEpiResidual && !(p.flags & kFlagResBf16)) ? 4 : 2;
    prefetch_l2(static_cast<const uint8_t*>(p.res) +
                    (res_offset(p, m0 + tid) + n0) * esize,
                min(BN, p.cout - n0) * esize);
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % S;
    if (!kTmaA) {
      cp_async_wait<S - 2>();  // this thread's A chunks of slice kt landed
      fence_proxy_async();
    }
    mbar_wait(&full[s], (kt / S) & 1);
    wgmma_wait<0>();  // this warpgroup's products of slice kt - 1 are done
    fence_regs<BN / 2>(acc);
    // One barrier a slice: every thread's A chunks of slice kt are in, and
    // both warpgroups are done with stage (kt - 1) % S, which is refilled
    // before slice kt's products are issued.
    __syncthreads();
    const int next = kt + S - 1;
    if (next < k_tiles) {
      issue(next);
    } else if (!kTmaA) {
      cp_async_commit();
    }
    const uint8_t* a_s = smem + s * T::kStage + wg * 64 * BK;
    const uint8_t* b_s = smem + s * T::kStage + T::kA;
    const uint64_t da = smem_desc<BK>(a_s);
    const uint64_t db = smem_desc<BK>(b_s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // +32 bytes of K per step: +2 in the descriptor's 16-byte units.
      if constexpr (BN == 64) {
        wgmma_m64n64k32(acc, da + 2 * kk, db + 2 * kk);
      } else {
        wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);
  if (!kTmaA) cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the accumulators there

  // Accumulator fragment of warpgroup wg: thread (warp w, lane l) holds rows
  // wg*64 + w*16 + l/4 (+8) and columns 8j + 2(l%4) (+1) of every n8 block j.
  int* stg = reinterpret_cast<int*>(smem);
  {
    constexpr int kLd = BN + kStgPad;
    const int lane = tid & 31;
    const int r = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<int2*>(stg + r * kLd + c) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(stg + (r + 8) * kLd + c) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  epilogue<BN>(p, stg, m0, n0);
}

// Pre-activation + quantisation, bf16 in (modes 0 and 1) or int8 in (modes
// 2 and 3), int8 out: thread (x, y) of a block takes channel group x (8
// channels: its pa / pb as two 16-byte loads each, once) of every
// (gridDim.x * blockDim.y)-th row.
template <typename In>
__global__ void __launch_bounds__(256)
    preact_quant_kernel(const In* __restrict__ x, int8_t* __restrict__ out,
                        const float* __restrict__ pa,
                        const float* __restrict__ pb,
                        const float* __restrict__ s,
                        const float* __restrict__ ds, long long rows, int c,
                        int mode) {
  const float sv = preact_divides(mode) ? __ldg(s) : 1.f;
  const float yv = div_recip(sv);
  const float dv = mode == 3 ? __ldg(ds) : 1.f;
  for (int g = threadIdx.x; g * 8 < c; g += blockDim.x) {
    float a[8], b[8];
    const float4* pa4 = reinterpret_cast<const float4*>(pa + g * 8);
    const float4* pb4 = reinterpret_cast<const float4*>(pb + g * 8);
    *reinterpret_cast<float4*>(a) = __ldg(pa4);
    *reinterpret_cast<float4*>(a + 4) = __ldg(pa4 + 1);
    *reinterpret_cast<float4*>(b) = __ldg(pb4);
    *reinterpret_cast<float4*>(b + 4) = __ldg(pb4 + 1);
    for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
         r < rows; r += (long long)gridDim.x * blockDim.y) {
      const size_t o = (size_t)r * c + g * 8;
      float v[8];
      if constexpr (sizeof(In) == 1) {
        const uint2 raw = *reinterpret_cast<const uint2*>(x + o);
        const int8_t* xv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = preact_in_s8(__int2float_rn(xv[j]), dv, mode);
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(x + o);
        const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(xv[j]);
      }
      *reinterpret_cast<uint2*>(out + o) = preact_q8(v, a, b, sv, yv, mode);
    }
  }
}

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A row-major int8 (rows, cols) matrix read in (box_rows, bk) tiles,
// swizzled for wgmma; out-of-bounds elements read as zeros.
int make_map(CUtensorMap* map, const void* base, int rows, int cols,
             int box_rows, int bk) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int BN, int BK, bool kTmaA>
int launch_conv(const ConvParams& p, cudaStream_t st) {
  using T = Tile<BN, BK>;
  CUtensorMap tm_a = {}, tm_b = {};
  int err = make_map(&tm_b, p.wt, p.cout, p.k, BN, BK);
  if (err == 0 && kTmaA) err = make_map(&tm_a, p.x, p.m, p.cin, kBM, BK);
  if (err != 0) return err;
  auto kernel = conv_wgmma_kernel<BN, BK, kTmaA>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (p.cout + BN - 1) / BN;
  const int m_tiles = (p.m + kBM - 1) / kBM;
  kernel<<<m_tiles * n_tiles, kThreads, T::kSmem, st>>>(tm_a, tm_b, p, n_tiles);
  return (int)cudaGetLastError();
}

// The tiles conv_plan picks: BN 64 or 128; BK 128, or 64 on the TMA path.
template <bool kTmaA>
int launch_path(const ConvParams& p, int bn, int bk, cudaStream_t st) {
  if (bn == 64 && bk == 128) return launch_conv<64, 128, kTmaA>(p, st);
  if (bn == 128 && bk == 128) return launch_conv<128, 128, kTmaA>(p, st);
  if constexpr (kTmaA) {
    if (bn == 64 && bk == 64) return launch_conv<64, 64, kTmaA>(p, st);
    if (bn == 128 && bk == 64) return launch_conv<128, 64, kTmaA>(p, st);
  }
  return kErrTile;
}

}  // namespace

extern "C" {

// Launches the conv on `stream`; returns 0, a cudaError_t, or one of the
// kErr codes. x (n, h, w, cin) int8, wt (cout, ks*ks*cin) int8, out
// (n, ho, wo, cout) of the epilogue's type; mul/add (cout,) f32 (unused for
// kEpiInt32); res (n, ho, wo, cout) bf16 or f32, or null; for kEpiStream
// res is int8 (n, rh, rw, cout), read at stride rstride, with rsc (1,) f32
// its multiplier (kFlagResS8), or bf16 (n, ho, wo, cout) with rsc its
// divisor; pq (n, ho, wo, cout) int8 or null, with pa/pb (cout,) f32, ps
// (1,) f32 for pmode 1 and 3, pds (1,) f32 for pmode 3. path / bn / bk come
// from the wrapper's conv_plan. The wrapper checks shapes, alignment (cin %
// 16 == 0, cout % 8 == 0, 16-byte aligned tensors) and devices.
int resnet_int8_conv_launch(const void* x, const void* wt, void* out,
                            const float* mul, const float* add,
                            const void* res, void* pq, const float* pa,
                            const float* pb, const float* ps,
                            const float* pds, const float* rsc, int pmode,
                            int n, int h, int w, int cin, int cout, int ks,
                            int stride, int ho, int wo, int epi, int flags,
                            int path, int bn, int bk, int rh, int rw,
                            int rstride, void* stream) {
  ConvParams p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.out = out;
  p.mul = mul;
  p.add = add;
  p.res = res;
  p.pq = static_cast<int8_t*>(pq);
  p.pa = pa;
  p.pb = pb;
  p.ps = ps;
  p.pds = pds;
  p.rsc = rsc;
  p.pmode = pmode;
  p.rh = rh; p.rw = rw; p.rstride = rstride;
  p.n = n; p.h = h; p.w = w; p.cin = cin; p.cout = cout; p.ks = ks;
  p.stride = stride; p.pad = (ks - 1) / 2; p.ho = ho; p.wo = wo;
  p.k = ks * ks * cin;
  p.m = n * ho * wo;
  p.epi = epi;
  p.flags = flags;
  if (p.m <= 0 || cout <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == kPathTma) {
    if (ks != 1 || stride != 1) return kErrTile;
    return launch_path<true>(p, bn, bk, st);
  }
  if (path == kPathGather) return launch_path<false>(p, bn, bk, st);
  return kErrTile;
}

// x (rows, c) with channels innermost, bf16 for modes 0 and 1, int8 for
// modes 2 and 3, c % 8 == 0; out (rows, c) int8; pa / pb 16-byte aligned;
// s (1,) f32 for modes 1 and 3, ds (1,) f32 for mode 3.
int resnet_int8_preact_launch(const void* x, void* out, const float* pa,
                              const float* pb, const float* s,
                              const float* ds, long long rows, int c,
                              int mode, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaSuccess;
  if (mode < 0 || mode > 3) return kErrTile;
  const int groups = c / 8;
  const int bx = groups < 256 ? groups : 256;
  const int by = 256 / bx;
  long long blocks = (rows + by - 1) / by;
  if (blocks > 132 * 16) blocks = 132 * 16;  // each thread then loops over rows
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode >= 2) {
    preact_quant_kernel<int8_t><<<(unsigned)blocks, dim3(bx, by), 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<int8_t*>(out), pa, pb, s,
        ds, rows, c, mode);
  } else {
    preact_quant_kernel<__nv_bfloat16><<<(unsigned)blocks, dim3(bx, by), 0,
                                         st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(out), pa,
        pb, s, ds, rows, c, mode);
  }
  return (int)cudaGetLastError();
}

const char* resnet_int8_error_string(int code) {
  switch (code) {
    case kErrNoEncoder: return "cuTensorMapEncodeTiled not found in the driver";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused the tensor map";
    case kErrTile: return "no kernel for this path, tile or mode";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

// Epilogue, flag and path codes, so the Python wrapper can check that it
// matches.
int resnet_int8_layout(int which) {
  switch (which) {
    case 0: return kEpiInt32;
    case 1: return kEpiRequant;
    case 2: return kEpiDequant;
    case 3: return kEpiDequantF32;
    case 4: return kEpiResidual;
    case 5: return kEpiStream;
    case 6: return kFlagFma;
    case 7: return kFlagRelu;
    case 8: return kFlagResBf16;
    case 9: return kFlagResS8;
    case 10: return kPathTma;
    case 11: return kPathGather;
    default: return -100;
  }
}

}  // extern "C"
