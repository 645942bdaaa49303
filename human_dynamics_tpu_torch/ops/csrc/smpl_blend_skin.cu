// Fused SMPL blend shapes + linear blend skinning for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the Pallas TPU kernel _blend_skin_kernel
// (human_dynamics_tpu/ops/smpl_pallas.py). Per frame n and vertex v:
//
//   posed_c[n,v] = sum_k coeffs[n,k] * dirs[c,k,v] + vt[c,v]    c in x,y,z, k < 224
//   b_k[n,v]     = sum_j rt_t[k*32 + j, n] * weights_t[j,v]     k < 12, j < 24
//   out_x = b0*px + b1*py + b2*pz + b9   (y: b3..b5 + b10, z: b6..b8 + b11)
//
// Only the three vertex planes (N, V) are written to device memory; the
// (N, V, 3) posed vertices and the (N, V, 12) blended transforms of the
// composed version never leave registers.
//
// What bounds it: the TF32 tensor cores. fp32-class results need 3xTF32:
// each product a*b is taken as al*bh + ah*bl + ah*bh, with ah = tf32(a) and
// al = a - ah, which is as close as an fp32 product (a single TF32 product
// is ~1e3 times worse, above the vertex tolerance). At the main path's shape
// (N = 1536 frames x heads, V = 6890) the two contractions, 2 * (3 * 217 +
// 12 * 24) flop per frame and vertex, are 3 x 19.9 GFLOP of TF32 work:
// 0.120 ms at 495 TFLOP/s. The compulsory bytes (18.5 MB of dirs, 127 MB of
// output planes) take 0.044 ms at 3.35 TB/s; on the FP32 pipe the same work
// could not beat 0.300 ms. mma.sync reaches about 2/3 of the TF32 peak.
//
// Design:
// - Frames are the rows of mma.sync.m16n8k8 (TF32 in, fp32 accumulate),
//   vertices its columns. A block computes a 64 x 64 tile with 8 warps of
//   32 frames x 16 vertices; each thread holds 16 elements per plane, and an
//   accumulator pair is two adjacent vertices of one frame (a float2 store).
//   128 registers and 109 KB of shared memory: two blocks per SM.
// - Blend: K = 224 in 7 slices of 32. coeffs (64 x 32) and the three dirs
//   planes (3 x 32 x 64) of a slice are staged by cp.async in a 3-stage
//   ring, so a tile reads dirs once per 64 frames. Every fragment is split
//   into hi and lo in registers as it is loaded; the three products of a
//   k-step run as three passes over the warp's tile, so back-to-back mma
//   instructions write different accumulators.
// - Skin: after the blend the ring takes the tile's rt_t rows (12 channels x
//   24 joints x 64 frames) and weights_t rows (24 x 64). K = 24 in 3 steps
//   per channel, on the same tile, so the accumulators line up element by
//   element with posed. Per output plane and m16 tile, out is built from
//   b_{9+c}, then b_{3c+q} * p_q: only posed (3 planes), the weights
//   fragments (split once), a 16-row slice of the output plane and one b_k
//   are live.
// - Shared-memory rows are padded so fragment loads are free of bank
//   conflicts: coeffs [n][k] by 40 words, dirs [c][k][v] by 68, rt_t
//   [ch][j][n] and weights_t [j][v] by 72. In the blend the mma's k and k + 4
//   are the slice's columns 2k and 2k + 1 for both operands, so an A
//   fragment row is one 8-byte load.
// - No global row stride needs 16-byte alignment: a dirs / weights_t row of
//   V floats is copied in 16-, 8- or 4-byte pieces as V allows (a template
//   parameter; V = 6890 takes 8), an rt_t row of N floats in 16-byte pieces
//   when N % 4 == 0 and in 4-byte pieces otherwise. The ragged frame and
//   vertex edges are zero-filled on load and masked on store.
// - The frame tile is the fast grid axis, so blocks that run together read
//   the same columns of dirs and share them in L2; the output planes are
//   stored with the streaming hint so they do not evict dirs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCoef = 224;  // 10 betas + 207 pose features, zero-padded
constexpr int kRtCh = 12;   // 9 rotation + 3 translation channels
constexpr int kJp = 32;     // row stride of a channel in rt_t (24 joints padded)
constexpr int kJoints = 24;

constexpr int kBM = 64;                // frames per block (mma rows)
constexpr int kBN = 64;                // vertices per block (mma columns)
constexpr int kBK = 32;                // k-slice of the blend ring
constexpr int kSlices = kCoef / kBK;   // 7
constexpr int kStages = 3;
constexpr int kWM = 32;                // warp tile: frames
constexpr int kWN = 16;                //            vertices
constexpr int kMT = kWM / 16;          // m16 tiles per warp
constexpr int kNT = kWN / 8;           // n8 tiles per warp
constexpr int kWarpsN = kBN / kWN;
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;  // 256

// Shared-memory row strides (floats) and tile sizes.
constexpr int kCS = kBK + 8;  // coeffs [n][k]
constexpr int kDS = kBN + 4;  // dirs [c][k][v]
constexpr int kRS = kBM + 8;  // rt_t [ch][j][n]
constexpr int kWS = kBN + 8;  // weights_t [j][v]
constexpr int kCTile = kBM * kCS;
constexpr int kDTile = 3 * kBK * kDS;
constexpr int kStage = kCTile + kDTile;
constexpr int kRing = kStages * kStage;
constexpr int kSkinRt = 4 * kJoints * kRS;  // one plane's 4 rt_t channels
constexpr int kWTile = kJoints * kWS;
constexpr int kSmemBytes = kRing * 4;  // 109,056: two blocks per SM
static_assert(3 * kSkinRt + kWTile <= kRing, "the skin operands reuse the ring");
static_assert(kCoef % kBK == 0 && kJoints % 8 == 0, "whole k-steps");

// x = hi + lo with hi = tf32(x), rounded to nearest with ties away (the
// rounding of cvt.rna.tf32.f32, which sm_90 runs as four instructions; the
// integer add and mask here are two), and lo = x - hi, exact in fp32. The
// tensor cores read lo's top 10 mantissa bits, so hi + lo matches x to
// within 2^-22 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32 over M x kNT m16n8k8 tiles: the two small products
// first, then hi * hi. Each pass runs over all the tiles, so back-to-back
// mma instructions write different accumulators.
template <int M>
__device__ __forceinline__ void mma_3xtf32_tile(float (&c)[M][kNT][4],
                                                const uint32_t (&ah)[M][4],
                                                const uint32_t (&al)[M][4],
                                                const uint32_t (&bh)[kNT][2],
                                                const uint32_t (&bl)[kNT][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma_tf32(c[m][n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma_tf32(c[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma_tf32(c[m][n], ah[m], bh[n][0], bh[n][1]);
}

// Copies kBytes from global to shared memory, or zero-fills them when
// `in_bounds` is false (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in_bounds) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = in_bounds ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Where a thread's cp.async pieces of a blend slice come from and go to.
// Round r covers coeffs row tid / 8 + 32 r (16 bytes at column 4 (tid % 8))
// and the slice's dirs row row0 + r * kRows of its 3 x 32 [c][k] rows, at
// the same column `col` every round: kVec floats.
template <int kVec>
struct SliceCopy {
  static constexpr int kPerRow = kBN / kVec;        // pieces per dirs row
  static constexpr int kRows = kThreads / kPerRow;  // dirs rows per round
  static constexpr int kRounds = 3 * kBK / kRows;
  static constexpr int kCRounds = kBM * kBK / 4 / kThreads;
  static_assert(kBK % kRows == 0 && kBM * kBK / 4 % kThreads == 0,
                "whole rounds");

  const float* c_src;  // coeffs row n0 + tid / 8, piece tid % 8
  const float* d_src;  // dirs row row0 of plane 0, column v0 + col
  int c_dst, d_dst;    // offsets in a ring stage
  bool c_ok[kCRounds], d_ok;

  __device__ SliceCopy(const float* coeffs, const float* dirs, int n0, int v0,
                       int n_frames, int n_verts, int tid) {
    const int n = tid / (kBK / 4), q = tid % (kBK / 4);
    const int row0 = tid / kPerRow, col = (tid % kPerRow) * kVec;
#pragma unroll
    for (int r = 0; r < kCRounds; ++r) {
      c_ok[r] = n0 + n + r * (kThreads * 4 / kBK) < n_frames;
    }
    d_ok = v0 + col < n_verts;
    c_src = coeffs + (size_t)(n0 + n) * kCoef + 4 * q;
    d_src = dirs + (size_t)row0 * n_verts + v0 + col;
    c_dst = n * kCS + 4 * q;
    d_dst = kCTile + row0 * kDS + col;
  }

  // Stages slice s (k in [32 s, 32 s + 32)) into `stage`.
  __device__ __forceinline__ void operator()(float* stage, const float* coeffs,
                                             const float* dirs, int n_verts,
                                             int s) const {
#pragma unroll
    for (int r = 0; r < kCRounds; ++r) {
      constexpr int kStep = kThreads * 4 / kBK;  // rows between rounds
      cp_async<16>(stage + c_dst + r * kStep * kCS,
                   c_ok[r] ? c_src + r * kStep * kCoef + s * kBK : coeffs,
                   c_ok[r]);
    }
    const float* src = d_src + (size_t)s * kBK * n_verts;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int row = r * kRows;  // + row0: plane row / kBK, k row % kBK
      const int g_row = (row / kBK) * kCoef + row % kBK;
      cp_async<4 * kVec>(stage + d_dst + row * kDS,
                         d_ok ? src + (size_t)g_row * n_verts : dirs, d_ok);
    }
  }
};

// Stages what output plane c's skinning reads at `rs`: the rows ch * 32 + j
// (j < 24) of its four rt_t channels (9 + c, 3c, 3c + 1, 3c + 2) for the
// tile's frames, as [q][j][n]; for plane 0 also the tile's weights_t rows
// j < 24, as [j][v], at `ws`.
template <int kVec>
__device__ __forceinline__ void stage_skin(float* rs, float* ws, int c,
                                           const float* __restrict__ rt_t,
                                           const float* __restrict__ weights_t,
                                           int n0, int v0, int n_frames,
                                           int n_verts, int tid) {
  constexpr int kRows = 4 * kJoints;
  // An rt_t row is n_frames floats: 16-byte pieces need n_frames % 4 == 0.
  if (n_frames % 4 == 0) {
    constexpr int kPerRow = kBM / 4;
    static_assert(kRows * kPerRow % kThreads == 0, "whole rounds");
#pragma unroll
    for (int it = 0; it < kRows * kPerRow / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int row = i / kPerRow, col = (i % kPerRow) * 4;
      const int q = row / kJoints, j = row % kJoints;
      const int ch = q == 0 ? 9 + c : 3 * c + q - 1;
      const bool ok = n0 + col < n_frames;
      const float* src =
          ok ? rt_t + (size_t)(ch * kJp + j) * n_frames + n0 + col : rt_t;
      cp_async<16>(rs + row * kRS + col, src, ok);
    }
  } else {
    static_assert(kRows * kBM % kThreads == 0, "whole rounds");
#pragma unroll 1
    for (int it = 0; it < kRows * kBM / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int row = i / kBM, col = i % kBM;
      const int q = row / kJoints, j = row % kJoints;
      const int ch = q == 0 ? 9 + c : 3 * c + q - 1;
      const bool ok = n0 + col < n_frames;
      const float* src =
          ok ? rt_t + (size_t)(ch * kJp + j) * n_frames + n0 + col : rt_t;
      cp_async<4>(rs + row * kRS + col, src, ok);
    }
  }
  if (c == 0) {
    constexpr int kPerRow = kBN / kVec;
    for (int i = tid; i < kJoints * kPerRow; i += kThreads) {
      const int j = i / kPerRow, col = (i % kPerRow) * kVec;
      const bool ok = v0 + col < n_verts;
      const float* src =
          ok ? weights_t + (size_t)j * n_verts + v0 + col : weights_t;
      cp_async<4 * kVec>(ws + j * kWS + col, src, ok);
    }
  }
}

// The weights_t fragments of the warp's columns, split once for all 12
// channels: B[j][v] at (t, g) and (t + 4, g) for each k-step of 8 joints.
struct SkinWeights {
  uint32_t hi[kJoints / 8][kNT][2], lo[kJoints / 8][kNT][2];

  __device__ SkinWeights(const float* ws, int wn, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < kJoints / 8; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* w = ws + (8 * ks + t) * kWS + wn + nt * 8 + g;
        split(w[0], hi[ks][nt][0], lo[ks][nt][0]);
        split(w[4 * kWS], hi[ks][nt][1], lo[ks][nt][1]);
      }
    }
  }
};

// b += rt_ch^T @ weights_t over the 24 joints, for one m16 tile of the
// warp's rows. r points at the channel's [j][n] tile in shared memory,
// offset to the m16 tile's first frame.
__device__ __forceinline__ void skin_channel(float (&b)[1][kNT][4],
                                             const float* r,
                                             const SkinWeights& w, int g,
                                             int t) {
#pragma unroll
  for (int ks = 0; ks < kJoints / 8; ++ks) {
    // A[n][j] = r[j][n]: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
    const float* a = r + (8 * ks + t) * kRS + g;
    uint32_t ah[1][4], al[1][4];
    split(a[0], ah[0][0], al[0][0]);
    split(a[8], ah[0][1], al[0][1]);
    split(a[4 * kRS], ah[0][2], al[0][2]);
    split(a[4 * kRS + 8], ah[0][3], al[0][3]);
    mma_3xtf32_tile(b, ah, al, w.hi[ks], w.lo[ks]);
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 2) blend_skin_kernel(
    const float* __restrict__ coeffs,     // (N, kCoef)
    const float* __restrict__ rt_t,       // (kRtCh * kJp, N)
    const float* __restrict__ dirs,       // (3, kCoef, V)
    const float* __restrict__ vt,         // (3, V)
    const float* __restrict__ weights_t,  // (kJp, V)
    float* __restrict__ out_x,            // (N, V)
    float* __restrict__ out_y,
    float* __restrict__ out_z,
    int n_frames, int n_verts) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / kWarpsN) * kWM;  // the warp's rows in the tile
  const int wn = (warp % kWarpsN) * kWN;  // and its columns
  const int n0 = blockIdx.x * kBM, v0 = blockIdx.y * kBN;

  // 1. Blend shapes: posed_c = coeffs @ dirs_c over K = 224.
  float p[3][kMT][kNT][4] = {};
  const SliceCopy<kVec> copy(coeffs, dirs, n0, v0, n_frames, n_verts, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    copy(smem + s * kStage, coeffs, dirs, n_verts, s);
    cp_async_commit();
  }
  for (int s = 0; s < kSlices; ++s) {
    cp_async_wait<kStages - 2>();  // slice s has landed
    __syncthreads();               // for every thread; stage s - 1 is free
    if (s + kStages - 1 < kSlices) {
      copy(smem + ((s + kStages - 1) % kStages) * kStage, coeffs, dirs,
           n_verts, s + kStages - 1);
    }
    cp_async_commit();
    const float* cs = smem + (s % kStages) * kStage;
    const float* ds = cs + kCTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // A[n][k] at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), with
        // the mma's k = t and t + 4 taken as slice columns kk + 2t and
        // kk + 2t + 1 (B's rows below likewise): one 8-byte load a row.
        const float* a = cs + (wm + mt * 16 + g) * kCS + kk + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(a);
        const float2 r8 = *reinterpret_cast<const float2*>(a + 8 * kCS);
        split(r0.x, ah[mt][0], al[mt][0]);
        split(r8.x, ah[mt][1], al[mt][1]);
        split(r0.y, ah[mt][2], al[mt][2]);
        split(r8.y, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          // B[k][v] at (t, g), (t + 4, g): slice rows kk + 2t, kk + 2t + 1.
          const float* b =
              ds + (c * kBK + kk + 2 * t) * kDS + wn + nt * 8 + g;
          split(b[0], bh[nt][0], bl[nt][0]);
          split(b[kDS], bh[nt][1], bl[nt][1]);
        }
        mma_3xtf32_tile(p[c], ah, al, bh, bl);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  // 2. The ring takes the skinning operands: plane c's rt_t channels at
  //    c * kSkinRt, the weights after them.
  float* ws = smem + 3 * kSkinRt;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    stage_skin<kVec>(smem + c * kSkinRt, ws, c, rt_t, weights_t, n0, v0,
                     n_frames, n_verts, tid);
  }
  cp_async_commit();

  // The template, while the copies land: posed_c += vt_c.
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int v = v0 + wn + nt * 8 + 2 * t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t0 = v < n_verts ? vt[(size_t)c * n_verts + v] : 0.f;
      const float t1 = v + 1 < n_verts ? vt[(size_t)c * n_verts + v + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        p[c][mt][nt][0] += t0;
        p[c][mt][nt][1] += t1;
        p[c][mt][nt][2] += t0;
        p[c][mt][nt][3] += t1;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. Skinning, one output plane and 16 rows at a time:
  //    out_c = b_{3c} * px + b_{3c+1} * py + b_{3c+2} * pz + b_{9+c}.
  const SkinWeights w(ws, wn, g, t);
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const float* rs = smem + c * kSkinRt;
    float* out = c == 0 ? out_x : (c == 1 ? out_y : out_z);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* r = rs + wm + mt * 16;
      float o[1][kNT][4] = {};
      skin_channel(o, r, w, g, t);  // b_{9+c}
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float b[1][kNT][4] = {};
        skin_channel(b, r + (q + 1) * kJoints * kRS, w, g, t);  // b_{3c+q}
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[0][nt][e] = fmaf(b[0][nt][e], p[q][mt][nt][e], o[0][nt][e]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm + mt * 16 + g + 8 * h;
        if (n >= n_frames) continue;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int v = v0 + wn + nt * 8 + 2 * t;  // even
          float* dst = out + (size_t)n * n_verts + v;
          const float e0 = o[0][nt][2 * h], e1 = o[0][nt][2 * h + 1];
          if (n_verts % 2 == 0 && v < n_verts) {  // then v + 1 < V too
            __stcs(reinterpret_cast<float2*>(dst), make_float2(e0, e1));
          } else {
            if (v < n_verts) __stcs(dst, e0);
            if (v + 1 < n_verts) __stcs(dst + 1, e1);
          }
        }
      }
    }
  }
}

template <int kVec>
int launch(const float* coeffs, const float* rt_t, const float* dirs,
           const float* vt, const float* weights_t, float* out_x, float* out_y,
           float* out_z, int n_frames, int n_verts, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blend_skin_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(blend_skin_kernel<kVec>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kBM - 1) / kBM, (n_verts + kBN - 1) / kBN);
  blend_skin_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      coeffs, rt_t, dirs, vt, weights_t, out_x, out_y, out_z, n_frames,
      n_verts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers are device pointers to contiguous float32 arrays, 16-byte
// aligned.
int smpl_blend_skin_launch(const float* coeffs, const float* rt_t,
                           const float* dirs, const float* vt,
                           const float* weights_t, float* out_x, float* out_y,
                           float* out_z, int n_frames, int n_verts,
                           void* stream) {
  if (n_frames <= 0 || n_verts <= 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (n_verts % 4 == 0) {
    return launch<4>(coeffs, rt_t, dirs, vt, weights_t, out_x, out_y, out_z,
                     n_frames, n_verts, s);
  }
  if (n_verts % 2 == 0) {
    return launch<2>(coeffs, rt_t, dirs, vt, weights_t, out_x, out_y, out_z,
                     n_frames, n_verts, s);
  }
  return launch<1>(coeffs, rt_t, dirs, vt, weights_t, out_x, out_y, out_z,
                   n_frames, n_verts, s);
}

const char* smpl_blend_skin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Layout constants, so the Python wrapper can check that it matches.
int smpl_blend_skin_layout(int which) {
  switch (which) {
    case 0: return kCoef;
    case 1: return kRtCh;
    case 2: return kJp;
    case 3: return kJoints;
    default: return -1;
  }
}

}  // extern "C"
