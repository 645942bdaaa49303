// The int8 root stem and the int8 max pool of the static-scale int8 ResNet-50
// v2 trunk, fused into one kernel for Hopper (sm_90a).
//
// Replaces, together with the wrapper human_dynamics_tpu_torch/ops/int8_root_cuda.py
// (root_stem_pool), the int8_root stems and the max pool of
// human_dynamics_tpu/models/resnet_int8.py (apply_int8, :371-462), which XLA
// runs as an elementwise input pass, an integer convolution over a
// space-to-depth or width-folded view with a requant epilogue, and an int8
// reduce_window. Not a Pallas kernel.
//
// Stem: y[n, oy, ox, co] = clip(rint(fma(acc, mul[co], add)), -127, 127),
//   acc = sum_k A[n, oy, ox, k] * Wt[co, k] in int32, K = 192 (s2d: the 7x7/2
//   Cin=3 conv as a 4x4/1 conv over the (H/2, W/2, 12) view) or 168 (wfold:
//   a (7, 4)/(2, 1) conv over the (H, W/2, 6) view). Index k maps to input
//   pixel (2 oy + drow, 2 ox + dcol), channel c, with drow, dcol in [-4, 3]
//   (the wrapper's root_taps; fold_k below is its inverse); pixels outside
//   the frame read 0, as the views' zero padding. The input transform is done
//   on the way into shared memory: f32 x -> clip(rint(x*127), -127, 127); f32
//   x -> clip(rint(fma(x, 127.5, 127.5)), 0, 255) - 128 (the "u8" stem on
//   float frames; XLA contracts it); uint8 u -> u ^ 0x80. add is per channel;
//   the "u8" stem's border-correction map (add_map) is read only for the stem
//   pixels whose 8 x 8 tap window leaves the frame (the wrapper's
//   border_mask), where it differs from the interior's per-channel add.
//   XLA contracts the epilogue's multiply-add on the CPU: one __fmaf_rn here.
// Pool: the 3x3/2 max with XLA's "SAME" padding (pad_top / pad_left before,
//   the rest after; -128 pads never win: y is clipped to [-127, 127]). With a
//   pre-activation (mode 2 or 3 of int8_epilogue.cuh) the kernel writes that
//   of the pooled values instead of them.
//
// What bounds it: the stem's int8 map never leaves the chip, so what has to
// move is the frames (18 MB of uint8 or 72 MB of f32 per 120 frames of
// 224x224) and the pooled map (24 MB): 0.013-0.029 ms at 3.35 TB/s. The
// stem's 7x7x3 taps are 28 GOP, 0.014 ms at the int8 tensor cores' dense
// peak; the folds pad K to 168 (wfold) or 192 (s2d), 32 to 37 GOP of MMAs,
// of which mma.sync reaches about two thirds of the peak. So the MMAs and
// the instructions around them bound it. Design:
// - A tile is R = 4 pooled rows of a band of pooled columns (the whole
//   width up to 16 kMCMax stem columns; wider frames in bands of
//   8 kMCMax - 1 pooled columns): 2R + 1 stem rows, the top one the pool's
//   halo, recomputed (1/8 more MMAs), so that tiles are independent.
//   Persistent blocks, one an SM, walk the tiles.
// - Input: the tile's 4R + 8 input rows are copied by 16-byte cp.async into
//   a two-stage ring of raw rows in shared memory; the last warp pair, whose
//   MMA share is the smallest at 224x224, issues the next tile's copies
//   after its MMAs. The rows are then transformed into the pixel-word
//   patch, one 32-bit word a pixel (3 int8 channels and a zero byte), a
//   warp a row.
// - MMA: mma.sync m16n8k32 s8 with the weights as A, held in registers for
//   the whole launch (a warp's 32 channels), and the pixels as B, one k32
//   step per patch row of 8 pixel words, no im2col. The k order inside a
//   step is permuted (k word t <- tap column 2t, k word t + 4 <- 2t + 1), so
//   that a B fragment is one 8-byte load into an aligned register pair. Two
//   stem rows are contracted together: their patch rows overlap, so each B
//   load serves both.
// - Epilogue and pool: a warp takes 16 stem columns down all 2R + 1 rows,
//   so the pool's vertical max is taken in registers on the epilogue's f32
//   values before the rounding (rint and the clip are monotone, so this
//   equals the max of the rounded values); only the R vertically pooled
//   rows are rounded and staged in shared memory as int8. The horizontal
//   max (__vmaxs4, 16 channels a thread) and the 16-byte stores follow. A
//   pre-activation (modes 2 and 3) is a function of the pooled int8 value
//   in each channel: a 64 x 256 table in shared memory, made once a block
//   by int8_epilogue's quantiser, replaces its arithmetic by a lookup.

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

constexpr int kErrArgs = -1;   // a fold, input kind or mode the library lacks
constexpr int kErrShape = -2;  // sizes that disagree with the fold's geometry
constexpr int kErrSmem = -3;   // more shared memory than the device has

constexpr int kCout = 64;
constexpr int kWarps = 8;           // 2 channel halves x 4 column workers
constexpr int kThreads = 32 * kWarps;
// The warps that issue the next tile's copies: the last pair, whose share
// of 16-column tiles is the smallest at 224x224 (7 tiles over 4 pairs).
constexpr int kIssueWarps = 2;
constexpr int kR = 4;               // pooled rows a tile
constexpr int kPRows = 4 * kR + 8;  // input rows a tile (patch rows)
constexpr int kMCMax = 7;           // 16-column stem tiles a band at most
constexpr int kVLd = kCout + 16;    // bytes a staged stem column (banks)

template <int kFold>
struct Fold {
  static constexpr int K = kFold == kFoldS2d ? 192 : 168;
  static constexpr int kRows = kFold == kFoldS2d ? 8 : 7;   // k32 steps
  static constexpr int kRowOff = kFold == kFoldS2d ? 0 : 1;  // patch row - 2 i - kk
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
struct Pixel {
  static constexpr int kBytes = kIn == kInU8 ? 3 : 12;
};

// One input pixel's 3 channels, from the raw ring, as a pixel word.
template <int kIn>
__device__ __forceinline__ uint32_t pixel_word(const uint8_t* src) {
  if constexpr (kIn == kInU8) {
    return (static_cast<uint32_t>(src[0]) | (static_cast<uint32_t>(src[1]) << 8) |
            (static_cast<uint32_t>(src[2]) << 16)) ^ 0x808080u;
  } else {
    const float* f = reinterpret_cast<const float*>(src);
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t q;
      if constexpr (kIn == kInF32) {
        q = sat_s8(__fmul_rn(f[c], 127.f), -127.f);
      } else {
        // rint(clip(v, 0, 255)) in the low byte, then - 128 is ^ 0x80.
        const float v = __fmaf_rn(f[c], 127.5f, 127.5f);
        q = __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.f), 255.f), 12582912.f)) ^
            0x80u;
      }
      word |= (q & 0xffu) << (8 * c);
    }
    return word;
  }
}

// float(y) for |y| < 2^22 (the stem's |acc| <= 192 * 128 * 128): two
// full-rate operations where I2F issues at a quarter of the rate.
__device__ __forceinline__ float exact_float(int y) {
  return __fsub_rn(__int_as_float(y + 0x4B400000), 12582912.f);
}

struct Params {
  const uint8_t* x;
  const int8_t* wt;
  int8_t* out;
  const float* mul;
  const float* add;
  const float* add_map;  // (ho, wo, 64) or null
  const float* pa;
  const float* pb;
  const float* ps;
  const float* pds;
  int pmode;  // -1: write the pooled map
  int n, h, w, ho, wo, po, qo, pad_top, pad_left;
  int mc;      // 16-column stem tiles a band
  int qb;      // pooled columns a band
  int bands, strips, tiles;
  int raw_ld;  // bytes a row slot of the raw ring (a multiple of 16)
  long long x_bytes;
};

// Shared memory, in bytes from the start: the raw ring (2 stages of kPRows
// row slots), each slot's offset of its first pixel, the patch, the staged
// vertically pooled rows, with a pre-activation its table (byte (c, q +
// 128) the pre-activation of int8 q in channel c), and with a border map
// the map's rows of the tile at the border columns 0, 1 and wo - 1, two
// stages as the raw ring.
struct Layout {
  int pld;  // patch words a row
  int raw, roff, patch, vstage, table, bmap, bytes;
};

constexpr int kBorderCols = 3;

__host__ __device__ inline Layout layout(int mc, int raw_ld, int pmode,
                                         bool map) {
  Layout l;
  l.pld = 32 * mc + 8;
  l.raw = 0;
  l.roff = l.raw + 2 * kPRows * raw_ld;
  l.patch = l.roff + 2 * kPRows * 4;
  l.vstage = l.patch + kPRows * l.pld * 4;
  l.table = l.vstage + kR * 16 * mc * kVLd;
  l.bmap = l.table + (pmode >= 0 ? kCout * 256 : 0);
  l.bytes = l.bmap + (map ? 2 * (2 * kR + 1) * kBorderCols * kCout * 4 : 0);
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulators.
// Fragments (PTX m16n8k32 .s8): lane = 4 g + t; a0 / a2 hold row g, k words
// t / t + 4 of the step, a1 / a3 the same of row g + 8; b0 / b1 column g,
// the same k words; d0, d1 row g, columns 2t, 2t+1, d2, d3 row g + 8. Here
// the rows are output channels (the weights are A) and the columns pixels.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Where a tile lies: frame nb, pooled rows py0 .. py0 + kR - 1, pooled
// columns q0 .. q0 + qb - 1; stem rows s0 .. s0 + 2 kR and columns c0 ..
// c0 + 16 mc - 1; patch rows from input row r_in0, columns from gc_lo.
struct Tile {
  int nb, py0, q0, s0, c0, r_in0, gc_lo;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int tile) {
  Tile t;
  const int band = tile % p.bands;
  const int rest = tile / p.bands;
  t.nb = rest / p.strips;
  t.py0 = (rest - t.nb * p.strips) * kR;
  t.q0 = band * p.qb;
  t.s0 = 2 * t.py0 - p.pad_top;
  t.c0 = 2 * t.q0 - p.pad_left;
  t.r_in0 = 2 * t.s0 - 4;
  t.gc_lo = 2 * t.c0 - 4;
  return t;
}

// Start the cp.async copies of a tile's input rows (the in-frame columns of
// the patch) into one stage of the raw ring, by the kIssueWarps issuing
// warps (w their index): each row from its 16-byte aligned start, the last
// chunk of the tensor cut to its bytes. roff[pr] is where the row's first
// copied pixel lies in its slot.
template <int kIn>
__device__ __forceinline__ void issue_rows(const Params& p, const Tile& t,
                                           int pld, int w, uint8_t* raw,
                                           int* roff) {
  constexpr int pb = Pixel<kIn>::kBytes;
  const int lane = threadIdx.x & 31;
  const int cl = max(t.gc_lo, 0);
  const int span = (min(t.gc_lo + pld, p.w) - cl) * pb;
  for (int pr = w; pr < kPRows; pr += kIssueWarps) {
    const int gr = t.r_in0 + pr;
    if (gr < 0 || gr >= p.h) continue;
    const long long start = (((long long)t.nb * p.h + gr) * p.w + cl) * pb;
    const long long a0 = start & ~15ll;
    const int chunks = static_cast<int>((start + span - a0 + 15) >> 4);
    if (lane == 0) roff[pr] = static_cast<int>(start - a0);
    const uint8_t* src = p.x + a0;
    const long long left = p.x_bytes - a0;
    for (int c = lane; c < chunks; c += 32) {
      const long long rest = left - 16 * c;
      cp_async16(raw + pr * p.raw_ld + 16 * c, src + 16 * c,
                 rest < 16 ? static_cast<int>(rest) : 16);
    }
  }
}

// Start the cp.async copies of the border map's entries that a tile's
// border columns need: stem rows s0 .. s0 + 2 kR at columns 0, 1 and wo - 1
// (2 ox + 3 >= w only there, w being even), 64 floats each, into one stage.
__device__ __forceinline__ void issue_border(const Params& p, const Tile& t,
                                             int w, float* bmap) {
  constexpr int kChunks = kCout * 4 / 16;
  for (int i = w * 32 + (threadIdx.x & 31);
       i < (2 * kR + 1) * kBorderCols * kChunks; i += kIssueWarps * 32) {
    const int r = i / (kBorderCols * kChunks);
    const int j = (i / kChunks) % kBorderCols, c = i % kChunks;
    const int s = t.s0 + r, col = j < 2 ? j : p.wo - 1;
    if (s < 0 || s >= p.ho || col >= p.wo) continue;
    cp_async16(bmap + (r * kBorderCols + j) * kCout + 4 * c,
               p.add_map + ((size_t)s * p.wo + col) * kCout + 4 * c, 16);
  }
}

// A persistent block: its warps' weights into registers once, pa / pb into
// shared memory once, then one tile after another (see the design above).
template <int kIn, int kFold>
__global__ void __launch_bounds__(kThreads, 1)
    root_pool_kernel(const Params p) {
  using F = Fold<kFold>;
  constexpr int pb = Pixel<kIn>::kBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(p.mc, p.raw_ld, p.pmode, p.add_map != nullptr);
  uint8_t* raw = smem + L.raw;
  int* roff = reinterpret_cast<int*>(smem + L.roff);
  uint32_t* patch = reinterpret_cast<uint32_t*>(smem + L.patch);
  int8_t* vstage = reinterpret_cast<int8_t*>(smem + L.vstage);
  uint8_t* table = smem + L.table;
  float* bmap = reinterpret_cast<float*>(smem + L.bmap);
  constexpr int kBmapStage = (2 * kR + 1) * kBorderCols * kCout;  // floats
  const int pld = L.pld;
  const int vrow = 16 * p.mc * kVLd;  // bytes a staged pooled row

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int half = warp & 1, wq = warp >> 1;
  // This warp's channels 32 half + 16 mt + g (+ 8): the weights as A, in
  // registers for the whole launch, k word t <- tap column 2t and k word
  // t + 4 <- 2t + 1 of the step's tap row.
  uint32_t a[F::kRows][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < F::kRows; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int co = half * 32 + mt * 16 + g + 8 * (r & 1);
        const int j = 2 * t + (r >> 1);
        uint32_t word = 0;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          word |= (static_cast<uint32_t>(
                       __ldg(p.wt + (size_t)co * F::K + fold_k<kFold>(kk, j, c))) &
                   0xffu) << (8 * c);
        a[kk][mt][r] = word;
      }
  // mul and add of this thread's channels 32 half + 16 mt + g + 8 u.
  float mv[2][2], av[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = half * 32 + mt * 16 + g + 8 * u;
      mv[mt][u] = __ldg(p.mul + c);
      av[mt][u] = __ldg(p.add + c);
    }
  // The pre-activation is a function of the pooled int8 value in each
  // channel: its table, 8 values a call of int8_epilogue's quantiser.
  if (p.pmode >= 0) {
    const float ps = preact_divides(p.pmode) ? __ldg(p.ps) : 1.f;
    const float recip = div_recip(ps);
    const float ds = p.pmode == 3 ? __ldg(p.pds) : 1.f;
    for (int i = tid; i < kCout * 32; i += kThreads) {
      const int c = i >> 5, q0 = ((i & 31) << 3) - 128;
      float v[8], pa[8], pb[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = preact_in_s8(static_cast<float>(q0 + j), ds, p.pmode);
        pa[j] = __ldg(p.pa + c);
        pb[j] = __ldg(p.pb + c);
      }
      *reinterpret_cast<uint2*>(table + c * 256 + q0 + 128) =
          preact_q8(v, pa, pb, ps, recip, p.pmode);
    }
  }

  const float neg_inf = __int_as_float(0xff800000);
  const int issuer = warp - (kWarps - kIssueWarps);  // >= 0: an issuing warp
  int stage = 0;
  if (issuer >= 0 && blockIdx.x < p.tiles)
    issue_rows<kIn>(p, tile_at(p, blockIdx.x), pld, issuer, raw, roff);
  if (issuer >= 0 && blockIdx.x < p.tiles && p.add_map != nullptr)
    issue_border(p, tile_at(p, blockIdx.x), issuer, bmap);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, stage ^= 1) {
    const Tile T = tile_at(p, tile);
    cp_async_wait_all();  // this tile's rows, issued a tile ahead, are in
    __syncthreads();      // ... for every thread; vstage is read

    // The patch, transformed to int8, zero outside the frame.
    {
      const uint8_t* rs = raw + stage * kPRows * p.raw_ld;
      const int* ro = roff + stage * kPRows;
      const int cl = max(T.gc_lo, 0);
      // A warp a patch row, the lanes along it: a fixed trip count, so that
      // the loads of a row are independent.
      for (int pr = warp; pr < kPRows; pr += kWarps) {
        const int gr = T.r_in0 + pr;
        const bool row_in = gr >= 0 && gr < p.h;
        const uint8_t* row = rs + pr * p.raw_ld + (row_in ? ro[pr] : 0);
#pragma unroll
        for (int k = 0; k < (32 * kMCMax + 8 + 31) / 32; ++k) {
          const int pc = lane + 32 * k, gc = T.gc_lo + pc;
          if (pc < pld) {
            uint32_t word = 0;
            if (row_in && gc >= 0 && gc < p.w)
              word = pixel_word<kIn>(row + (gc - cl) * pb);
            patch[pr * pld + pc] = word;
          }
        }
      }
    }
    __syncthreads();  // the patch is in

    // Stem rows through the MMAs and the epilogue, the vertical max in
    // registers, the R pooled rows staged as int8.
    for (int mc = wq; mc < p.mc; mc += kWarps / 2) {
      // B of patch row r: pixel 8 nt + g's k words t and t + 4, one 8-byte
      // load.
      const uint32_t* col = patch + 2 * (16 * mc + g + t);
      auto b_row = [&](int r, uint32_t (&b)[2][2]) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint2 w = *reinterpret_cast<const uint2*>(col + r * pld + 16 * nt);
          b[nt][0] = w.x;
          b[nt][1] = w.y;
        }
      };
      // This thread's pixels 16 mc + 8 nt + 2 t + e: the columns where the
      // "u8" map is read in every row (the window leaves the frame).
      bool col_border[2][2];
      bool any_col_border = false;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ox = T.c0 + 16 * mc + 8 * nt + 2 * t + e;
          col_border[nt][e] = ox >= 0 && ox < p.wo && (ox < 2 || 2 * ox + 3 >= p.w);
          any_col_border |= col_border[nt][e];
        }
      // The epilogue's f32 value of local stem row i (-inf outside the
      // frame: the pool's padding) at each of this thread's channels
      // (mt, u) and pixels (nt, e), handed to use(mt, nt, u, e, value).
      auto epilogue = [&](int i, const int (&acc)[2][2][4], auto&& use) {
        const int s = T.s0 + i;
        if (s < 0 || s >= p.ho) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) use(mt, nt, r >> 1, r & 1, neg_inf);
          return;
        }
        const bool row_border = s < 2 || 2 * s + 3 >= p.h;
        if (p.add_map == nullptr || !row_border) {
          float v[2][2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                v[mt][nt][r] = __fmaf_rn(exact_float(acc[mt][nt][r]),
                                         mv[mt][r >> 1], av[mt][r >> 1]);
          // The border columns' values again with the map's add, from the
          // copy in shared memory (a few lanes of two column tiles).
          if (p.add_map != nullptr && any_col_border) {
            const float* brow = bmap + stage * kBmapStage +
                                i * kBorderCols * kCout + half * 32 + g;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const int u = r >> 1, e = r & 1;
                  const int ox = T.c0 + 16 * mc + 8 * nt + 2 * t + e;
                  if (col_border[nt][e])
                    v[mt][nt][r] = __fmaf_rn(
                        exact_float(acc[mt][nt][r]), mv[mt][u],
                        brow[(ox < 2 ? ox : 2) * kCout + mt * 16 + 8 * u]);
                }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                use(mt, nt, r >> 1, r & 1, v[mt][nt][r]);
          return;
        }
        // A border row: the map's add wherever the window leaves the frame.
        const float* map_row =
            p.add_map + (size_t)s * p.wo * kCout + half * 32 + g;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int u = r >> 1, e = r & 1;
              const int ox = T.c0 + 16 * mc + 8 * nt + 2 * t + e;
              float add = av[mt][u];
              if (ox >= 0 && ox < p.wo)
                add = __ldg(map_row + ox * kCout + mt * 16 + 8 * u);
              use(mt, nt, u, e,
                  __fmaf_rn(exact_float(acc[mt][nt][r]), mv[mt][u], add));
            }
      };

      float m[2][2][2][2];  // [mt][nt][u][e]
      {
        int acc[2][2][4] = {};
#pragma unroll
        for (int kk = 0; kk < F::kRows; ++kk) {
          uint32_t b[2][2];
          b_row(F::kRowOff + kk, b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma_s8(acc[mt][nt], a[kk][mt], b[nt]);
        }
        epilogue(0, acc, [&](int mt, int nt, int u, int e, float v) {
          m[mt][nt][u][e] = v;
        });
      }
      for (int pr = 0; pr < kR; ++pr) {
        if (T.py0 + pr >= p.po) break;
        // Stem rows 2 pr + 1 and 2 pr + 2: patch rows base + kk and
        // base + 2 + kk, so that each B row read serves both.
        const int base = 2 * (2 * pr + 1) + F::kRowOff;
        int acc1[2][2][4] = {}, acc2[2][2][4] = {};
#pragma unroll
        for (int r = 0; r < F::kRows + 2; ++r) {
          uint32_t b[2][2];
          b_row(base + r, b);
          if (r < F::kRows) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                mma_s8(acc1[mt][nt], a[r][mt], b[nt]);
          }
          if (r >= 2) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                mma_s8(acc2[mt][nt], a[r - 2][mt], b[nt]);
          }
        }
        epilogue(2 * pr + 1, acc1, [&](int mt, int nt, int u, int e, float v) {
          m[mt][nt][u][e] = fmaxf(m[mt][nt][u][e], v);
        });
        // The pooled row: max(rows 2 pr, 2 pr + 1, 2 pr + 2), rounded, a
        // byte a store; row 2 pr + 2 starts the next.
        int8_t* dst = vstage + pr * vrow + (16 * mc + 2 * t) * kVLd +
                      half * 32 + g;
        epilogue(2 * pr + 2, acc2, [&](int mt, int nt, int u, int e, float v) {
          dst[(8 * nt + e) * kVLd + 16 * mt + 8 * u] = static_cast<int8_t>(
              sat_s8(fmaxf(m[mt][nt][u][e], v), -127.f));
          m[mt][nt][u][e] = v;
        });
      }
    }
    // The next tile's rows, into the other stage of the ring (its last
    // reader, the transform of the tile before, is behind two barriers).
    const int next = tile + gridDim.x;
    if (issuer >= 0 && next < p.tiles) {
      const Tile N = tile_at(p, next);
      issue_rows<kIn>(p, N, pld, issuer, raw + (stage ^ 1) * kPRows * p.raw_ld,
                      roff + (stage ^ 1) * kPRows);
      if (p.add_map != nullptr)
        issue_border(p, N, issuer, bmap + (stage ^ 1) * kBmapStage);
    }
    cp_async_commit();
    __syncthreads();  // vstage is complete (and the patch is read)

    // The horizontal max, the optional pre-activation, 16 bytes a thread.
    // A fixed trip count (a band has at most 8 kMCMax pooled columns).
    const int items = kR * p.qb * 4;
#pragma unroll
    for (int k = 0; k < (kR * 8 * kMCMax * 4 + kThreads - 1) / kThreads; ++k) {
      const int it = tid + k * kThreads;
      const int grp = it & 3, pq = it >> 2;
      const int pr = pq / p.qb, q = pq - pr * p.qb;
      const int py = T.py0 + pr, qx = T.q0 + q;
      if (it >= items || py >= p.po || qx >= p.qo) continue;
      uint4 best = make_uint4(0x80808080u, 0x80808080u, 0x80808080u,
                              0x80808080u);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int col = T.c0 + 2 * q + dx;
        if (col < 0 || col >= p.wo) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(
            vstage + pr * vrow + (2 * q + dx) * kVLd + grp * 16);
        best.x = __vmaxs4(best.x, v.x);
        best.y = __vmaxs4(best.y, v.y);
        best.z = __vmaxs4(best.z, v.z);
        best.w = __vmaxs4(best.w, v.w);
      }
      uint4* dst = reinterpret_cast<uint4*>(
          p.out + (((size_t)T.nb * p.po + py) * p.qo + qx) * kCout + grp * 16);
      if (p.pmode < 0) {
        *dst = best;
        continue;
      }
      // The table's byte (channel, q + 128) for each of the 16 values.
      const uint32_t in[4] = {best.x, best.y, best.z, best.w};
      uint32_t outw[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint8_t* row = table + (grp * 16 + 4 * w) * 256;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= static_cast<uint32_t>(
                      row[j * 256 + (((in[w] >> (8 * j)) & 0xffu) ^ 0x80u)])
                  << (8 * j);
        outw[w] = word;
      }
      *dst = make_uint4(outw[0], outw[1], outw[2], outw[3]);
    }
  }
  // Nothing is left in flight: the last tile issued no copies.
}

// What a launch of one instance needs: its dynamic shared memory, the
// blocks an SM holds with it and the SMs; with `report`, also its
// registers and its local (spilled) bytes a thread.
struct Fit {
  int smem, per_sm, sms, regs, local;
};

template <int kIn, int kFold>
int fit(const Params& p, Fit* f, bool report) {
  auto kernel = root_pool_kernel<kIn, kFold>;
  f->smem = layout(p.mc, p.raw_ld, p.pmode, p.add_map != nullptr).bytes;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&f->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (f->smem > max_smem) return kErrSmem;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           f->smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f->per_sm, kernel,
                                                      kThreads, f->smem);
  if (e == cudaSuccess && report) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    f->regs = attr.numRegs;
    f->local = (int)attr.localSizeBytes;
  }
  return (int)e;
}

template <int kIn, int kFold>
int launch(const Params& p, cudaStream_t st) {
  Fit f;
  const int code = fit<kIn, kFold>(p, &f, false);
  if (code != 0) return code;
  const long long cap = (long long)f.sms * (f.per_sm > 0 ? f.per_sm : 1);
  const int blocks = (int)(p.tiles < cap ? p.tiles : cap);
  root_pool_kernel<kIn, kFold><<<blocks, kThreads, f.smem, st>>>(p);
  return (int)cudaGetLastError();
}

// launch<kIn, fold>(p, st) (st non-null or not) or fit<kIn, fold>(p, f).
template <int kIn>
int dispatch_fold(const Params& p, int fold, cudaStream_t st, Fit* f) {
  if (fold == kFoldS2d)
    return f ? fit<kIn, kFoldS2d>(p, f, true) : launch<kIn, kFoldS2d>(p, st);
  if (fold == kFoldWfold)
    return f ? fit<kIn, kFoldWfold>(p, f, true)
             : launch<kIn, kFoldWfold>(p, st);
  return kErrArgs;
}

int dispatch(const Params& p, int kind, int fold, cudaStream_t st, Fit* f) {
  switch (kind) {
    case kInF32: return dispatch_fold<kInF32>(p, fold, st, f);
    case kInU8F32: return dispatch_fold<kInU8F32>(p, fold, st, f);
    case kInU8: return dispatch_fold<kInU8>(p, fold, st, f);
    default: return kErrArgs;
  }
}

// XLA's "SAME" window of 3, stride 2: (output size, leading pad).
void same_pool(int size, int* out, int* lead) {
  *out = (size + 1) / 2;
  const int total = (*out - 1) * 2 + 3 - size;
  *lead = (total > 0 ? total : 0) / 2;
}

// The geometry of a launch on n frames of h x w: the stem's and the pool's
// sizes, the bands, strips and tiles, and the raw ring's row slots.
int make_params(Params* p, int kind, int n, int h, int w, int fold) {
  if (fold != kFoldS2d && fold != kFoldWfold) return kErrArgs;
  if (kind != kInF32 && kind != kInU8F32 && kind != kInU8) return kErrArgs;
  if (n < 0 || h < 1 || w < 2 || w % 2 || (fold == kFoldS2d && h % 2))
    return kErrShape;
  p->n = n; p->h = h; p->w = w;
  p->ho = fold == kFoldS2d ? h / 2 : (h - 1) / 2 + 1;
  p->wo = w / 2;
  same_pool(p->ho, &p->po, &p->pad_top);
  same_pool(p->wo, &p->qo, &p->pad_left);
  // One band when every stem column fits in kMCMax 16-column tiles; else
  // bands of 8 kMCMax - 1 pooled columns (2 qb + 1 stem columns each).
  if (p->wo + p->pad_left <= 16 * kMCMax) {
    p->qb = p->qo;
    p->mc = (p->wo + p->pad_left + 15) / 16;
  } else {
    p->qb = 8 * kMCMax - 1;
    p->mc = kMCMax;
  }
  p->bands = (p->qo + p->qb - 1) / p->qb;
  p->strips = (p->po + kR - 1) / kR;
  const long long tiles = (long long)n * p->strips * p->bands;
  if (tiles > 0x7fffffff) return kErrShape;
  p->tiles = (int)tiles;
  const int pix = kind == kInU8 ? 3 : 12;
  const int cols = 32 * p->mc + 8 < w ? 32 * p->mc + 8 : w;
  p->raw_ld = ((cols * pix + 15) / 16) * 16 + 16;
  p->x_bytes = (long long)n * h * w * pix;
  return 0;
}

}  // namespace

extern "C" {

// x (n, h, w, 3): f32 for kinds kInF32 and kInU8F32, uint8 for kInU8,
// 16-byte aligned; wt (64, K) int8, K = 192 (s2d) or 168 (wfold); out (n,
// po, qo, 64) int8, 16-byte aligned: the pooled map (pmode -1) or its
// pre-activation (pmode 2 or 3: pa / pb (64,) f32, ps (1,) f32 for mode 3
// with pds (1,) f32); mul, add (64,) f32; add_map null or (ho, wo, 64) f32,
// 16-byte aligned, read only at the stem pixels whose tap window leaves the
// frame. po, qo are the wrapper's pooled sizes, checked against the fold's
// geometry. Returns 0, a cudaError_t, kErrArgs, kErrShape or kErrSmem.
int int8_root_pool_launch(const void* x, int kind, const void* wt, void* out,
                          const float* mul, const float* add,
                          const float* add_map, const float* pa,
                          const float* pb, const float* ps, const float* pds,
                          int pmode, int n, int h, int w, int po, int qo,
                          int fold, void* stream) {
  if (pmode != -1 && pmode != 2 && pmode != 3) return kErrArgs;
  Params p;
  const int code = make_params(&p, kind, n, h, w, fold);
  if (code != 0) return code;
  if (p.po != po || p.qo != qo) return kErrShape;
  if (n == 0) return (int)cudaSuccess;
  p.x = static_cast<const uint8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.out = static_cast<int8_t*>(out);
  p.mul = mul;
  p.add = add;
  p.add_map = add_map;
  p.pa = pa;
  p.pb = pb;
  p.ps = ps;
  p.pds = pds;
  p.pmode = pmode;
  return dispatch(p, kind, fold, static_cast<cudaStream_t>(stream), nullptr);
}

// What a launch on h x w frames of this kind and fold takes: its dynamic
// shared memory in bytes, the blocks an SM holds, registers a thread and
// local (spilled) bytes a thread, into out[0..3]. Returns as the launcher.
int int8_root_pool_fit(int kind, int fold, int h, int w, int pmode,
                       int with_map, int* out) {
  Params p{};
  int code = make_params(&p, kind, 1, h, w, fold);
  p.pmode = pmode;
  // Only whether there is a map counts here: the layout reserves its copy.
  p.add_map = with_map ? reinterpret_cast<const float*>(16) : nullptr;
  if (code != 0) return code;
  Fit f;
  code = dispatch(p, kind, fold, nullptr, &f);
  if (code != 0) return code;
  out[0] = f.smem;
  out[1] = f.per_sm;
  out[2] = f.regs;
  out[3] = f.local;
  return 0;
}

const char* int8_root_error_string(int code) {
  if (code == kErrArgs) return "no kernel for this fold, input kind or mode";
  if (code == kErrShape) return "sizes that disagree with the fold's geometry";
  if (code == kErrSmem) return "more shared memory than the device has";
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
