// int8 ResNet-50 v2 kernels for Hopper (sm_90a): an implicit-GEMM int8
// convolution with per-output-channel epilogues, and the pre-activation +
// quantisation pass ahead of it.
//
// Replaces, together with the wrapper human_dynamics_tpu_torch/ops/resnet_int8_cuda.py:
// - the Pallas TPU kernel _chained_block_kernel
//   (human_dynamics_tpu/ops/resnet_int8_pallas.py: _unit_body, _conv3x3_planar):
//   K2 is one preact_quant launch and three or four conv launches per unit,
//   with the kernel's f32 multiply-adds done as explicit fused multiply-adds;
// - the XLA integer convolutions of human_dynamics_tpu/models/resnet_int8.py
//   (_conv_s8, requant, dequant) for the units K2 does not take, with the
//   epilogue multiply-adds done as a separate multiply and add.
//
// conv: out[m, co] = epilogue(sum_k A[m, k] * Wt[co, k]), int32 accumulation.
//   A is the implicit im2col view of x (N, H, W, Cin) int8 NHWC: row m is an
//   output pixel (n, ho, wo), column k = (ky * ks + kx) * Cin + ci, i.e. the
//   flattened HWIO order; taps outside the image read 0 (exact: the
//   quantisation is symmetric, so 0 is real 0). Padding is (ks - 1) / 2 on
//   both sides, which is SAME at stride 1 and slim conv2d_same at stride 2.
//   Wt is the weight as (Cout, K) with K contiguous.
//
// What bounds it: operations. The trunk's convs at 120 frames of 224x224
// are ~0.98 TOP of int8 multiply-adds against ~0.3 GB of compulsory
// traffic, so the floor is the tensor cores' 1,979 TOP/s (~0.5 ms), far
// above the 3.35 TB/s memory floor (~0.1 ms).
//
// Design (simple and correct first; no TMA, no wgmma):
// - Tensor cores through mma.sync.m16n8k32 s8 x s8 -> s32.
// - Block tile 128 (pixels) x BN (channels, 128 or 64) x 64 (K bytes),
//   8 warps of 32 x BN/2; two shared-memory stages filled by 16-byte
//   cp.async with zero fill for padding taps and ragged edges.
// - Shared rows are padded 64 -> 80 bytes so that the 32-bit fragment
//   loads of 8 rows x 4 threads hit 32 distinct banks.
// - Intermediates of a unit go through device memory (one conv launch per
//   conv); keeping the unit's chain on chip is later work.
//
// Rounding: int32 -> f32 by __int2float_rn, f32 -> int8 by rintf (half to
// even, as jnp.round), f32 -> bf16 by __float2bfloat16_rn. Every multiply
// and add names its rounding (__fmul_rn, __fadd_rn, __fmaf_rn), so nvcc's
// contraction cannot change which operations are fused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Epilogues (keep in step with resnet_int8_cuda.py).
constexpr int kEpiInt32 = 0;     // int32 accumulators
constexpr int kEpiRequant = 1;   // int8 clip(rint(y*m + a), lo, 127)
constexpr int kEpiDequant = 2;   // bf16(y*m + a) [relu] [+ bf16 residual]
constexpr int kEpiDequantF32 = 3;  // f32 fma(y, m, a)
constexpr int kEpiResidual = 4;  // bf16(fma(y, m, shortcut) + a)

constexpr int kFlagFma = 1;      // requant: fma(y, m, a) instead of y*m + a
constexpr int kFlagRelu = 2;     // requant: lo = 0; dequant: max(., 0)
constexpr int kFlagResBf16 = 4;  // residual / shortcut operand is bf16 (else f32)

constexpr int kBM = 128;
constexpr int kBK = 64;
constexpr int kLds = kBK + 16;   // padded shared row, bytes
constexpr int kThreads = 256;

struct ConvParams {
  const int8_t* x;
  const int8_t* wt;
  void* out;
  const float* mul;
  const float* add;
  const void* res;
  int n, h, w, cin, cout, ks, stride, pad, ho, wo, k, m;
  int epi, flags;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t sat_s8(float v, float lo) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), lo), 127.f));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Epilogue for the output pair (row m, columns c and c + 1).
__device__ __forceinline__ void store_pair(const ConvParams& p, size_t o,
                                           int acc0, int acc1, float m0,
                                           float m1, float a0, float a1) {
  const float y0 = __int2float_rn(acc0), y1 = __int2float_rn(acc1);
  switch (p.epi) {
    case kEpiInt32: {
      *reinterpret_cast<int2*>(static_cast<int*>(p.out) + o) =
          make_int2(acc0, acc1);
      break;
    }
    case kEpiRequant: {
      const bool fused = p.flags & kFlagFma;
      const float lo = (p.flags & kFlagRelu) ? 0.f : -127.f;
      const float v0 = fused ? __fmaf_rn(y0, m0, a0) : __fadd_rn(__fmul_rn(y0, m0), a0);
      const float v1 = fused ? __fmaf_rn(y1, m1, a1) : __fadd_rn(__fmul_rn(y1, m1), a1);
      char2 q;
      q.x = sat_s8(v0, lo);
      q.y = sat_s8(v1, lo);
      *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + o) = q;
      break;
    }
    case kEpiDequant: {
      float v0 = bf16_round(__fadd_rn(__fmul_rn(y0, m0), a0));
      float v1 = bf16_round(__fadd_rn(__fmul_rn(y1, m1), a1));
      if (p.flags & kFlagRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (p.res != nullptr) {  // bf16 + bf16, rounded once to bf16
        const __nv_bfloat162 r =
            reinterpret_cast<const __nv_bfloat162*>(p.res)[o / 2];
        v0 = __fadd_rn(__bfloat162float(r.x), v0);
        v1 = __fadd_rn(__bfloat162float(r.y), v1);
      }
      reinterpret_cast<__nv_bfloat162*>(p.out)[o / 2] =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      break;
    }
    case kEpiDequantF32: {
      reinterpret_cast<float2*>(p.out)[o / 2] =
          make_float2(__fmaf_rn(y0, m0, a0), __fmaf_rn(y1, m1, a1));
      break;
    }
    case kEpiResidual: {
      float s0, s1;
      if (p.flags & kFlagResBf16) {
        const __nv_bfloat162 r =
            reinterpret_cast<const __nv_bfloat162*>(p.res)[o / 2];
        s0 = __bfloat162float(r.x);
        s1 = __bfloat162float(r.y);
      } else {
        const float2 r = reinterpret_cast<const float2*>(p.res)[o / 2];
        s0 = r.x;
        s1 = r.y;
      }
      const float v0 = __fadd_rn(__fmaf_rn(y0, m0, s0), a0);
      const float v1 = __fadd_rn(__fmaf_rn(y1, m1, s1), a1);
      reinterpret_cast<__nv_bfloat162*>(p.out)[o / 2] =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      break;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads) conv_s8_kernel(const ConvParams p) {
  constexpr int kNI = BN / 16;              // n8 tiles per warp (warp: 32 x BN/2)
  constexpr int kBChunks = BN * kBK / 16 / kThreads;  // 16-byte chunks per thread
  __shared__ __align__(16) int8_t a_s[2][kBM * kLds];
  __shared__ __align__(16) int8_t b_s[2][BN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int kc = (tid & 3) * 16;            // this thread's 16 bytes of a row

  // The two A rows this thread loads: their image, top-left input corner
  // and whether the output pixel exists.
  const int8_t* a_base[2];
  int a_ih[2], a_iw[2];
  bool a_ok[2];
  const int hw_out = p.ho * p.wo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + i * 64;
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

  auto load_tile = [&](int kt, int stage) {
    const int k = kt * kBK + kc;
    const bool k_ok = k < p.k;
    int tap = 0, ci = 0, ky = 0, kx = 0;
    if (k_ok) {
      tap = k / p.cin;
      ci = k - tap * p.cin;
      ky = tap / p.ks;
      kx = tap - ky * p.ks;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int ih = a_ih[i] + ky, iw = a_iw[i] + kx;
      const bool ok = k_ok && a_ok[i] && ih >= 0 && ih < p.h && iw >= 0 &&
                      iw < p.w;
      const int8_t* src =
          ok ? a_base[i] + ((size_t)ih * p.w + iw) * p.cin + ci : p.x;
      cp_async16(&a_s[stage][row * kLds + kc], src, ok);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int row = (tid >> 2) + i * 64;
      const bool ok = k_ok && n0 + row < p.cout;
      const int8_t* src = ok ? p.wt + (size_t)(n0 + row) * p.k + k : p.wt;
      cp_async16(&b_s[stage][row * kLds + kc], src, ok);
    }
  };

  int acc[2][kNI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int k_tiles = (p.k + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) {
      load_tile(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = a_s[stage];
    const int8_t* bs = b_s[stage];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      int af[2][4], bf[kNI][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        const int8_t* p0 = as + r * kLds + kk + t4 * 4;
        af[mi][0] = *reinterpret_cast<const int*>(p0);
        af[mi][1] = *reinterpret_cast<const int*>(p0 + 8 * kLds);
        af[mi][2] = *reinterpret_cast<const int*>(p0 + 16);
        af[mi][3] = *reinterpret_cast<const int*>(p0 + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int c = wn * (BN / 2) + ni * 8 + g;
        const int8_t* p0 = bs + c * kLds + kk + t4 * 4;
        bf[ni][0] = *reinterpret_cast<const int*>(p0);
        bf[ni][1] = *reinterpret_cast<const int*>(p0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Epilogue: each thread owns rows (r, r + 8) x columns (c, c + 1) of
  // every 16 x 8 tile.
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int c = n0 + wn * (BN / 2) + ni * 8 + t4 * 2;
    if (c >= p.cout) continue;
    float m0v = 0.f, m1v = 0.f, a0v = 0.f, a1v = 0.f;
    if (p.epi != kEpiInt32) {
      m0v = __ldg(p.mul + c);
      m1v = __ldg(p.mul + c + 1);
      a0v = __ldg(p.add + c);
      a1v = __ldg(p.add + c + 1);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (m < p.m) {
          store_pair(p, (size_t)m * p.cout + c, acc[mi][ni][2 * half],
                     acc[mi][ni][2 * half + 1], m0v, m1v, a0v, a1v);
        }
      }
    }
  }
}

// Pre-activation + quantisation, 8 channels per thread, bf16 in, int8 out.
//   mode 0 (K2, _unit_body): clip(rint(max(fma(x, pa, pb), 0)), 0, 127)
//   mode 1 (XLA static path): p = max(bf16(bf16(x * pa) + pb), 0);
//          clip(rint(p / s), 0, 127), with pa and pb bf16 values held as f32
__global__ void preact_quant_kernel(const __nv_bfloat16* __restrict__ x,
                                    int8_t* __restrict__ out,
                                    const float* __restrict__ pa,
                                    const float* __restrict__ pb,
                                    const float* __restrict__ s,
                                    long long groups, int c, int mode) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const int c0 = (int)((i * 8) % c);
  const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
  const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
  const float sv = mode == 1 ? __ldg(s) : 1.f;
  uint2 packed;
  int8_t* qb = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float xf = __bfloat162float(xv[j]);
    const float a = __ldg(pa + c0 + j), b = __ldg(pb + c0 + j);
    float v;
    if (mode == 0) {
      v = fmaxf(__fmaf_rn(xf, a, b), 0.f);
    } else {
      const float t = bf16_round(__fmul_rn(xf, a));
      v = __fdiv_rn(fmaxf(bf16_round(__fadd_rn(t, b)), 0.f), sv);
    }
    qb[j] = sat_s8(v, 0.f);
  }
  reinterpret_cast<uint2*>(out)[i] = packed;
}

}  // namespace

extern "C" {

// Launches the conv on `stream`; returns the cudaError_t of the launch.
// x (n, h, w, cin) int8, wt (cout, ks*ks*cin) int8, out (n, ho, wo, cout) of
// the epilogue's type; mul/add (cout,) f32 (unused for kEpiInt32); res
// (n, ho, wo, cout) bf16 or f32, or null. The wrapper checks shapes,
// alignment (cin % 16 == 0, cout % 8 == 0) and devices.
int resnet_int8_conv_launch(const void* x, const void* wt, void* out,
                            const float* mul, const float* add,
                            const void* res, int n, int h, int w, int cin,
                            int cout, int ks, int stride, int ho, int wo,
                            int epi, int flags, void* stream) {
  ConvParams p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.out = out;
  p.mul = mul;
  p.add = add;
  p.res = res;
  p.n = n; p.h = h; p.w = w; p.cin = cin; p.cout = cout; p.ks = ks;
  p.stride = stride; p.pad = (ks - 1) / 2; p.ho = ho; p.wo = wo;
  p.k = ks * ks * cin;
  p.m = n * ho * wo;
  p.epi = epi;
  p.flags = flags;
  if (p.m <= 0 || cout <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cout <= 64) {
    const dim3 grid((p.m + kBM - 1) / kBM, (cout + 63) / 64);
    conv_s8_kernel<64><<<grid, kThreads, 0, st>>>(p);
  } else {
    const dim3 grid((p.m + kBM - 1) / kBM, (cout + 127) / 128);
    conv_s8_kernel<128><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// x (total,) bf16 with channels innermost, c % 8 == 0; out (total,) int8.
int resnet_int8_preact_launch(const void* x, void* out, const float* pa,
                              const float* pb, const float* s,
                              long long total, int c, int mode, void* stream) {
  const long long groups = total / 8;
  if (groups <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (groups + threads - 1) / threads;
  preact_quant_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(out), pa, pb,
      s, groups, c, mode);
  return (int)cudaGetLastError();
}

const char* resnet_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Epilogue and flag codes, so the Python wrapper can check that it matches.
int resnet_int8_layout(int which) {
  switch (which) {
    case 0: return kEpiInt32;
    case 1: return kEpiRequant;
    case 2: return kEpiDequant;
    case 3: return kEpiDequantF32;
    case 4: return kEpiResidual;
    case 5: return kFlagFma;
    case 6: return kFlagRelu;
    case 7: return kFlagResBf16;
    default: return -1;
  }
}

}  // extern "C"
