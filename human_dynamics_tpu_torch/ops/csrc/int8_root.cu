// The int8 root stems and the int8 max pool of the static-scale int8
// ResNet-50 v2 trunk, for Hopper (sm_90a).
//
// Replaces, together with the wrapper human_dynamics_tpu_torch/ops/int8_root_cuda.py,
// the int8_root stems of human_dynamics_tpu/models/resnet_int8.py
// (apply_int8, :371-463), which XLA runs as an elementwise input pass, an
// integer convolution over a space-to-depth or width-folded view with a
// requant epilogue, and an int8 reduce_window. Not a Pallas kernel.
//
// Stem: out[n, oy, ox, co] = clip(rint(fma(y, mul[co], add)), -127, 127),
//   y = sum_k A[n, oy, ox, k] * Wt[co, k] in int32, K = 192 (s2d: the 7x7/2
//   Cin=3 conv as a 4x4/1 conv over the (H/2, W/2, 12) view) or 168 (wfold:
//   a (7, 4)/(2, 1) conv over the (H, W/2, 6) view). Index k maps to input
//   pixel (2 oy + drow, 2 ox + dcol), channel c, with drow, dcol in [-4, 3]
//   (the wrapper's root_taps; fold_k below is its inverse); pixels outside
//   the frame read 0, as the views' zero padding. The input transform is done on load, so no
//   transformed copy of the clip is written: f32 x -> clip(rint(x*127),
//   -127, 127); f32 x -> clip(rint(fma(x, 127.5, 127.5)), 0, 255) - 128
//   (the "u8" stem on float frames; XLA contracts it); uint8 u -> u ^ 0x80.
//   add is per channel, or the "u8" stem's per-(row, column, channel)
//   border-correction map. XLA contracts the epilogue's multiply-add on the
//   CPU, so it is one __fmaf_rn here.
//
// What bounds it: bytes (120 frames of 224x224: 72 MB of f32 frames or 18
// MB of bytes in, 96 MB of int8 out, against ~32-37 GOP, 0.02 ms on the
// int8 tensor cores). Both folds are the 7x7/2 taps in an 8 x 8 window of
// input pixels around (2 oy, 2 ox): s2d's K index is (row step 2 ay + dy,
// column 2 ax + dx, channel), wfold's (row ky, column 2 a + p, channel).
// So the kernel takes each input pixel as one 32-bit word (3 int8
// channels and a zero byte), and a k32 step of mma.sync m16n8k32 s8 is one
// patch row of 8 consecutive pixel words: the A fragments are read
// straight from the tile's input patch, with no im2col. Design: persistent
// blocks (2 an SM) repack the fold's k-major weights once into that
// layout (fold_k: each K index by index arithmetic; the unused slots
// zero); per 8 x 16 output tile a block loads the 22 x 38 pixel patch,
// transformed to int8 on load, 8 warps (32 pixels x 32 channels each) run
// 7 (wfold) or 8 (s2d) k steps, the epilogue runs on the accumulator
// fragments and stages the int8 tile in shared memory, which is stored 16
// bytes a thread.
//
// Pool: the 3x3/2 max pool with XLA's "SAME" padding (pad_top / pad_left
// before, the rest after; -128 pads, never the max: the stem's output is
// clipped to [-127, 127]), 16 channels a thread by __vmaxs4. With a
// pre-activation (mode 2 or 3 of int8_epilogue.cuh) it writes the
// pre-activation of the pooled values instead of them. Bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

using namespace int8_epilogue;

// Fold and input codes (keep in step with int8_root_cuda.py).
constexpr int kFoldS2d = 0;
constexpr int kFoldWfold = 1;
constexpr int kInF32 = 0;     // f32 in [-1, 1]: clip(rint(x*127), -127, 127)
constexpr int kInU8F32 = 1;   // f32: clip(rint(fma(x, 127.5, 127.5)), 0, 255) - 128
constexpr int kInU8 = 2;      // uint8: u ^ 0x80

constexpr int kErrArgs = -1;  // a fold, input kind or mode the library lacks

constexpr int kCout = 64;
constexpr int kTR = 8, kTC = 16, kPix = kTR * kTC;  // a tile of output pixels
constexpr int kThreads = 256;
// Persistent blocks an SM: ~128 registers a thread fit two (capping them
// at 85 for three spilled and ran slower on an H100).
constexpr int kBlocksPerSm = 2;
// The tile's input patch: rows 2 oy0 - 4 .. 2 oy0 + 2 kTR + 1 and columns
// 2 ox0 - 4 .. 2 ox0 + 2 kTC + 1, one 32-bit word a pixel (its 3 int8
// channels and a zero byte).
constexpr int kPR = 2 * kTR + 6, kPC = 2 * kTC + 6;
// The weights as the kernel reads them, word (co, kk, j) = channels 0-2 of
// tap (row offset kk - 4 (s2d) or kk - 3 (wfold), column offset j - 4) and
// a zero byte: one mma k32 step per patch row kk, 8 pixels of it. Row
// stride 68 words = 4 * 17, so the 8 rows x 4 words of a fragment load fall
// in 32 banks.
constexpr int kSteps = 8;
constexpr int kWLd = kSteps * 8 + 4;
constexpr int kOutLd = kCout + 16;  // staged int8 output row, bytes

template <int kFold>
struct Fold {
  static constexpr int K = kFold == kFoldS2d ? 192 : 168;
  static constexpr int kRows = kFold == kFoldS2d ? 8 : 7;   // k32 steps
  static constexpr int kRowOff = kFold == kFoldS2d ? 0 : 1;  // patch row - 2 py - kk
};

// Index k of the fold's k-major weights for tap (row step kk, column j,
// channel c): the inverse of the wrapper's root_taps. s2d: kk = 2 ay + dy,
// j = 2 ax + dx, k = (ay*4 + ax)*12 + (dy*2 + dx)*3 + c; wfold: kk = ky,
// j = 2 a + p, k = (ky*4 + a)*6 + p*3 + c.
template <int kFold>
__device__ __forceinline__ int fold_k(int kk, int j, int c) {
  if constexpr (kFold == kFoldS2d) {
    return ((kk >> 1) * 4 + (j >> 1)) * 12 + ((kk & 1) * 2 + (j & 1)) * 3 + c;
  } else {
    return (kk * 4 + (j >> 1)) * 6 + (j & 1) * 3 + c;
  }
}

template <int kIn>
__device__ __forceinline__ uint32_t load_q(const void* x, size_t i) {
  if constexpr (kIn == kInU8) {
    return (static_cast<const uint8_t*>(x)[i] ^ 0x80u) & 0xffu;
  } else if constexpr (kIn == kInF32) {
    const float v = __ldg(static_cast<const float*>(x) + i);
    return sat_s8(__fmul_rn(v, 127.f), -127.f) & 0xffu;
  } else {
    const float v = __fmaf_rn(__ldg(static_cast<const float*>(x) + i), 127.5f,
                              127.5f);
    return static_cast<uint32_t>(
               __float2int_rn(fminf(fmaxf(v, 0.f), 255.f)) - 128) & 0xffu;
  }
}

struct RootParams {
  const void* x;
  const int8_t* wt;
  int8_t* out;
  const float* mul;
  const float* add;
  int add_map;
  int n, h, w, ho, wo;
  int tiles_x, tiles_y, tiles;
};

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulators.
// Fragments (PTX m16n8k32 .s8): lane = 4 g + t; a0 / a2 hold row g, bytes
// 4t .. 4t+3 / 16+4t .. 16+4t+3 of the k step, a1 / a3 the same of row
// g + 8; b0 / b1 column g, the same bytes; d0, d1 row g, columns 2t, 2t+1,
// d2, d3 row g + 8.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A persistent block: the weights repacked into shared memory once, then
// one 8 x 16 output tile after another. Warp (wm, wn) = (warp % 4, warp /
// 4) takes output rows 2 wm, 2 wm + 1 of the tile (two m16 tiles) and
// channels 32 wn .. 32 wn + 31 (four n8 tiles); the A fragment of output
// pixel (py, px) at k step kk is 8 consecutive pixel words of patch row
// 2 py + kk + kRowOff from column 2 px, read straight from the patch.
template <int kIn, int kFold>
__global__ void __launch_bounds__(kThreads)
    root_kernel(const RootParams p) {
  using F = Fold<kFold>;
  __shared__ uint32_t w_s[kCout * kWLd];
  __shared__ uint32_t patch[kPR * kPC];
  __shared__ __align__(16) int8_t out_s[kPix * kOutLd];

  const int tid = threadIdx.x;
  for (int i = tid; i < kCout * kSteps * 8; i += kThreads) {
    const int co = i / (kSteps * 8), r = i - co * (kSteps * 8);
    const int kk = r >> 3, j = r & 7;
    uint32_t word = 0;
    if (kk < F::kRows) {
      const int8_t* w = p.wt + (size_t)co * F::K;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        word |= (static_cast<uint32_t>(__ldg(w + fold_k<kFold>(kk, j, c))) &
                 0xffu) << (8 * c);
    }
    w_s[co * kWLd + r] = word;
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  // This thread's 8 output channels: 32 wn + 8 nt + 2 t (+ 1).
  float mv[4][2], av[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = wn * 32 + nt * 8 + 2 * t + e;
      mv[nt][e] = __ldg(p.mul + c);
      av[nt][e] = p.add_map ? 0.f : __ldg(p.add + c);
    }

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int tx = tile % p.tiles_x;
    const int ty = (tile / p.tiles_x) % p.tiles_y;
    const int nb = tile / (p.tiles_x * p.tiles_y);
    const int oy0 = ty * kTR, ox0 = tx * kTC;
    // The input patch, transformed to int8 on load, zero outside the frame.
    const int r0 = 2 * oy0 - 4, c0 = 2 * ox0 - 4;
    for (int i = tid; i < kPR * kPC; i += kThreads) {
      const int pr = i / kPC, pc = i - pr * kPC;
      const int gr = r0 + pr, gc = c0 + pc;
      uint32_t word = 0;
      if (gr >= 0 && gr < p.h && gc >= 0 && gc < p.w) {
        const size_t o = (((size_t)nb * p.h + gr) * p.w + gc) * 3;
        word = load_q<kIn>(p.x, o) | (load_q<kIn>(p.x, o + 1) << 8) |
               (load_q<kIn>(p.x, o + 2) << 16);
      }
      patch[i] = word;
    }
    __syncthreads();  // the patch is in (and last tile's out_s is read)

    int acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
#pragma unroll
    for (int kk = 0; kk < F::kRows; ++kk) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* r =
            patch + (2 * (2 * wm + mt) + kk + F::kRowOff) * kPC + 2 * g + t;
        a[mt][0] = r[0];
        a[mt][1] = r[16];
        a[mt][2] = r[4];
        a[mt][3] = r[20];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* r = w_s + (wn * 32 + nt * 8 + g) * kWLd + kk * 8 + t;
        b[nt][0] = r[0];
        b[nt][1] = r[4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }

    // Epilogue in registers, int8 staged in shared memory.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int px = g + 8 * hh;
        const int oy = oy0 + 2 * wm + mt, ox = ox0 + px;
        const bool in = oy < p.ho && ox < p.wo;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + 2 * t;
          float b0 = av[nt][0], b1 = av[nt][1];
          if (p.add_map && in) {
            const float2 m2 = __ldg(reinterpret_cast<const float2*>(
                p.add + ((size_t)oy * p.wo + ox) * kCout + c));
            b0 = m2.x;
            b1 = m2.y;
          }
          const uint32_t q0 = sat_s8(
              __fmaf_rn(__int2float_rn(acc[mt][nt][2 * hh]), mv[nt][0], b0),
              -127.f);
          const uint32_t q1 = sat_s8(
              __fmaf_rn(__int2float_rn(acc[mt][nt][2 * hh + 1]), mv[nt][1], b1),
              -127.f);
          *reinterpret_cast<uint16_t*>(
              out_s + ((2 * wm + mt) * kTC + px) * kOutLd + c) =
              static_cast<uint16_t>((q0 & 0xffu) | ((q1 & 0xffu) << 8));
        }
      }
    __syncthreads();  // out_s is complete (and the patch is read)
    // 16 bytes a thread: pixels tid / 4 and 64 + tid / 4, 16 channels.
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int q = pass * 64 + (tid >> 2), c = (tid & 3) * 16;
      const int oy = oy0 + q / kTC, ox = ox0 + q % kTC;
      if (oy < p.ho && ox < p.wo)
        *reinterpret_cast<uint4*>(
            p.out + (((size_t)nb * p.ho + oy) * p.wo + ox) * kCout + c) =
            *reinterpret_cast<const uint4*>(out_s + q * kOutLd + c);
    }
  }
}

struct PoolParams {
  const int8_t* x;
  int8_t* out;
  const float* pa;
  const float* pb;
  const float* ps;
  const float* pds;
  int pmode;  // -1: write the pooled map
  int n, h, w, c, ho, wo, pad_top, pad_left;
};

__global__ void __launch_bounds__(256) pool_kernel(const PoolParams p) {
  const int groups = p.c / 16;
  const long long total = (long long)p.n * p.ho * p.wo * groups;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % groups);
  const long long pix = idx / groups;
  const int ox = (int)(pix % p.wo);
  const int oy = (int)((pix / p.wo) % p.ho);
  const long long nb = pix / ((long long)p.wo * p.ho);
  uint4 best = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - p.pad_top + dy;
    if (iy < 0 || iy >= p.h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - p.pad_left + dx;
      if (ix < 0 || ix >= p.w) continue;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          p.x + ((nb * p.h + iy) * p.w + ix) * p.c + g * 16));
      best.x = __vmaxs4(best.x, v.x);
      best.y = __vmaxs4(best.y, v.y);
      best.z = __vmaxs4(best.z, v.z);
      best.w = __vmaxs4(best.w, v.w);
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(p.out + pix * p.c + g * 16);
  if (p.pmode < 0) {
    *dst = best;
    return;
  }
  const int8_t* bv = reinterpret_cast<const int8_t*>(&best);
  const float ps = preact_divides(p.pmode) ? __ldg(p.ps) : 1.f;
  const float py = div_recip(ps);
  const float ds = p.pmode == 3 ? __ldg(p.pds) : 1.f;
  uint2 half[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float v[8], a[8], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = g * 16 + hh * 8 + j;
      v[j] = preact_in_s8(__int2float_rn(bv[hh * 8 + j]), ds, p.pmode);
      a[j] = __ldg(p.pa + ch);
      b[j] = __ldg(p.pb + ch);
    }
    half[hh] = preact_q8(v, a, b, ps, py, p.pmode);
  }
  *dst = make_uint4(half[0].x, half[0].y, half[1].x, half[1].y);
}

template <int kIn>
int launch_root(const RootParams& p, int fold, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.tiles < sms * kBlocksPerSm ? p.tiles : sms * kBlocksPerSm;
  if (fold == kFoldS2d) {
    root_kernel<kIn, kFoldS2d><<<blocks, kThreads, 0, st>>>(p);
  } else if (fold == kFoldWfold) {
    root_kernel<kIn, kFoldWfold><<<blocks, kThreads, 0, st>>>(p);
  } else {
    return kErrArgs;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, h, w, 3): f32 for kinds kInF32 and kInU8F32, uint8 for kInU8; wt
// (64, K) int8, K = 192 (s2d) or 168 (wfold), 16-byte aligned; out (n, ho,
// wo, 64) int8; mul (64,) f32; add (64,) f32, or (ho, wo, 64) f32 with
// add_map. Returns 0, a cudaError_t or kErrArgs. The wrapper checks shapes
// (H, W even for s2d, W even for wfold), types and devices.
int int8_root_launch(const void* x, int kind, const void* wt, void* out,
                     const float* mul, const float* add, int add_map, int n,
                     int h, int w, int ho, int wo, int fold, void* stream) {
  if (n <= 0 || ho <= 0 || wo <= 0) return (int)cudaSuccess;
  RootParams p;
  p.x = x;
  p.wt = static_cast<const int8_t*>(wt);
  p.out = static_cast<int8_t*>(out);
  p.mul = mul;
  p.add = add;
  p.add_map = add_map;
  p.n = n; p.h = h; p.w = w; p.ho = ho; p.wo = wo;
  p.tiles_x = (wo + kTC - 1) / kTC;
  p.tiles_y = (ho + kTR - 1) / kTR;
  p.tiles = n * p.tiles_x * p.tiles_y;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kInF32: return launch_root<kInF32>(p, fold, st);
    case kInU8F32: return launch_root<kInU8F32>(p, fold, st);
    case kInU8: return launch_root<kInU8>(p, fold, st);
    default: return kErrArgs;
  }
}

// x (n, h, w, c) int8, c % 16 == 0, 16-byte aligned; out (n, ho, wo, c)
// int8: the pooled map (pmode -1) or its pre-activation (pmode 2 or 3, pa /
// pb (c,) f32, ps (1,) f32 for mode 3 with pds (1,) f32).
int int8_pool_launch(const void* x, void* out, const float* pa,
                     const float* pb, const float* ps, const float* pds,
                     int pmode, int n, int h, int w, int c, int ho, int wo,
                     int pad_top, int pad_left, void* stream) {
  if (pmode != -1 && pmode != 2 && pmode != 3) return kErrArgs;
  const long long total = (long long)n * ho * wo * (c / 16);
  if (total <= 0) return (int)cudaSuccess;
  PoolParams p;
  p.x = static_cast<const int8_t*>(x);
  p.out = static_cast<int8_t*>(out);
  p.pa = pa;
  p.pb = pb;
  p.ps = ps;
  p.pds = pds;
  p.pmode = pmode;
  p.n = n; p.h = h; p.w = w; p.c = c; p.ho = ho; p.wo = wo;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  pool_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* int8_root_error_string(int code) {
  if (code == kErrArgs) return "no kernel for this fold, input kind or mode";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fold and input codes and the channel count, so the Python wrapper can
// check that it matches.
int int8_root_layout(int which) {
  switch (which) {
    case 0: return kFoldS2d;
    case 1: return kFoldWfold;
    case 2: return kInF32;
    case 3: return kInU8F32;
    case 4: return kInU8;
    case 5: return kCout;
    default: return -100;
  }
}

}  // extern "C"
