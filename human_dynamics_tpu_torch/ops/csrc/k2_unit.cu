// K2 for Hopper (sm_90a): one launch computes one stride-1 pre-activation
// int8 bottleneck unit with static scales, on int8 tensor cores
// (mma.sync m16n8k32 s8 -> s32, operands by ldmatrix), with the unit's
// intermediates in shared memory.
//
// Replaces, together with the wrapper human_dynamics_tpu_torch/ops/resnet_int8_cuda.py
// (fused_block*), the Pallas TPU kernel _chained_block_kernel
// (human_dynamics_tpu/ops/resnet_int8_pallas.py: _unit_body, _conv3x3_planar).
// A chain of units is one launch per unit.
//
// One unit, x (N, H, W, Cin) bf16 -> out (N, H, W, Cout) bf16, per pixel:
//   pq  = clip(rint(max(fma(x, pa, pb), 0)), 0, 127)             int8, Cin
//   sc  = fma(pq . wsc, dscm, dsca) (projection) or x             f32,  Cout
//   h1  = clip(rint(fma(pq . w1, q1m, q1a)), 0, 127)             int8, Cb
//   h2  = clip(rint(fma(conv3x3_SAME(h1) . w2, q2m, q2a)), 0, 127)  int8, Cb
//   out = bf16(fma(h2 . w3, d3m, sc) + d3a)                      bf16, Cout
// and, for the last unit of a chain, the next unit's pre-activation of the
// stored out (int8_epilogue.cuh's preact, mode 0 or 1). The roundings are
// those of the conv kernel's epilogues (resnet_int8.cu), so a unit equals
// the plain version (fused_block_reference) bit for bit.
//
// What bounds it: int8 tensor-core operations for the chain as a whole
// (2 * M * (Cin*Cb + 9*Cb*Cb + Cb*Cout [+ Cin*Cout]) per unit: 0.633 TOP
// for a 120-frame chunk's 11 units, 0.32 ms at 1979 TOP/s); per unit, the
// bytes it must move are x read once and out written once (1.12 GB over
// the chunk's 11 units, 0.33 ms at 3.35 TB/s).
//
// Design:
// - One block (256 threads, 8 warps) computes the output rows
//   [r0, r0 + rows) of one frame (k2_plan in the wrapper picks `rows`):
//   7-row tiles at 28x28 and 14x14, the whole frame at 7x7.
// - Phase 0: the tile's x rows plus a one-row halo above and below (the
//   3x3's reach), contiguous in x, are read once with 16-byte loads and
//   quantised into pq in shared memory. pq never goes to device memory.
// - Phase A: h1 = requant(pq . w1) over the halo rows too (the recompute:
//   +2 rows per tile), into a zero-bordered (rows + 2) x (W + 2) plane in
//   shared memory; rows outside the image stay zero, which is the 3x3's
//   SAME padding (the masks of _conv3x3_planar).
// - Phase B: h2 = requant(conv3x3(h1) . w2): the nine taps are nine row
//   offsets into the resident h1 plane, each lane handing ldmatrix its own
//   shifted row address. h2 stays in shared memory (where pq was, when the
//   unit has no projection shortcut).
// - Phase C, per chunk of output channels: the projection shortcut
//   pq . wsc (pq of the tile's own rows, still resident) dequantised in
//   registers, then h2 . w3 and the residual epilogue straight to device
//   memory; an identity shortcut reads x's bf16 rows again.
// - Every GEMM has its A operand resident in shared memory; the weights,
//   (Cout, K) k-major, come from L2 as one stream of 64-byte K slices over
//   all the block's GEMMs, through a cp.async ring of 3-8 slots (what
//   shared memory leaves): the next GEMM's first slices load during this
//   one's last and its epilogue, phase A's during phase 0. Warp tile
//   64 x 32 (4 x 4 mma tiles); the block tile is (64 * WM) pixels x
//   (256 / WM) channels, WM = 1, 2 or 4 warps along M chosen so that one
//   pass covers the phase's pixels. The WM warps that share a slot's
//   channels copy and wait for them alone (a named barrier, or __syncwarp
//   at WM = 1): one block barrier a GEMM, none a slice.
// - Activation rows in shared memory are padded by 16 bytes, so ldmatrix's
//   eight rows of a matrix fall in eight different bank groups.
//
// Where its time goes (scripts/bench_k2.py --phases stamps each phase;
// PERF.md has the numbers): one 256-thread block fits an SM (151-232 KB of
// shared memory, 255 registers), so a block's phases run one after the
// other: x in, the MMAs, out; and the blocks of a wave reach their memory
// phases together. The MMA loop reaches about half of what mma.sync s8 does
// on this tile without a ring (scripts/probe_mma_s8.py). At 7x7 each of
// the 120 blocks streams the unit's 4.4 MB of weights from L2 for 49
// pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_s8.cuh"
#include "int8_epilogue.cuh"

namespace {

using namespace hopper;
using namespace int8_epilogue;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;            // bytes of K in one weight slice
constexpr int kBRow = kBK + 16;    // a weight slice row in shared memory
constexpr int kBC = kBK / 16;      // 16-byte chunks of a slice row
constexpr int kMinStages = 3, kMaxStages = 8;  // weight slices in the ring
constexpr int kMT = 4, kNT = 4;    // m16 and n8 tiles of one warp
constexpr int kPad = 16;           // bytes added to every activation row

#ifdef K2_PHASE_CLOCKS
// A build with -DK2_PHASE_CLOCKS (scripts/bench_k2.py --phases) stamps each
// block's phase boundaries here: (grid, 8) %globaltimer ns, the start and
// the ends of phases 0, A, B and C; then the SM's id, and warp 0's clock
// cycles waiting for weight slices (the cp.async wait and the barrier) and
// in all.
__device__ unsigned long long* k2_clocks;

__device__ __forceinline__ void stamp(int i, long long waited = 0) {
  __syncthreads();
  if (threadIdx.x == 0 && k2_clocks != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long* c = k2_clocks + blockIdx.x * 8;
    c[i] = t;
    if (i == 0) c[7] = clock64();
    if (i == 4) {
      unsigned int sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      c[5] = sm;
      c[6] = waited;
      c[7] = clock64() - c[7];
    }
  }
}
#else
__device__ __forceinline__ void stamp(int, long long = 0) {}
#endif

// Error codes of the launch function besides cudaError_t.
constexpr int kErrPlan = -1;       // the wrapper's plan is not the kernel's
constexpr int kErrShape = -2;      // a shape the kernel does not take

struct UnitParams {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int8_t* pq_out;  // the next unit's pre-activation of out, or null
  const float* pa;
  const float* pb;
  const int8_t* w1;
  const float* q1m;
  const float* q1a;
  const int8_t* w2;
  const float* q2m;
  const float* q2a;
  const int8_t* w3;
  const float* d3m;
  const float* d3a;
  const int8_t* wsc;
  const float* dscm;
  const float* dsca;
  const float* na;
  const float* nb;
  const float* ns;
  int nmode;
  int h, w, cin, cb, cout, rows, tiles, stages;
  int off_pq, off_h2, off_ring;  // byte offsets in shared memory; h1 at 0
};

__host__ __device__ constexpr int round128(int b) { return (b + 127) & ~127; }

// Shared memory of one block, as resnet_int8_cuda._k2_smem computes it.
struct Layout {
  int h1, pq, h2, ring, total;
};

inline Layout layout(int h, int w, int cin, int cb, int rows, int nc,
                     bool sc, int stages) {
  const int halo = rows + 2 < h ? rows + 2 : h;
  const int h1 = round128((rows + 2) * (w + 2) * (cb + kPad));
  const int pq = round128(halo * w * (cin + kPad));
  const int h2 = round128(rows * w * (cb + kPad));
  Layout l;
  l.h1 = 0;
  l.pq = h1;
  l.h2 = sc ? h1 + pq : h1;  // without a shortcut h2 takes pq's place
  l.ring = h1 + (sc ? pq + h2 : (pq > h2 ? pq : h2));
  l.total = l.ring + stages * nc * kBRow;
  return l;
}

template <int WM>
struct Tiling {
  static constexpr int WN = kWarps / WM;
  static constexpr int NC = WN * kNT * 8;   // output channels per chunk
  static constexpr int MC = WM * kMT * 16;  // pixels per pass
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Where this thread sits in the block tile: warp (wm, wn), the first row
// of its m16 tiles, its fragment row (lane / 4) and column pair.
template <int WM>
struct Place {
  int lane, wm, wn;
  __device__ __forceinline__ Place() {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    wm = warp / Tiling<WM>::WN;
    wn = warp % Tiling<WM>::WN;
  }
  // First pixel of m16 tile mt of this warp in a pass starting at m0.
  __device__ __forceinline__ int mrow(int m0, int mt) const {
    return m0 + (wm * kMT + mt) * 16;
  }
  // The pixel whose A row this lane hands ldmatrix for m16 tile mt.
  __device__ __forceinline__ int arow(int m0, int mt, int m) const {
    const int r = mrow(m0, mt) + (lane & 7) + ((lane >> 3) & 1) * 8;
    return r < m ? r : m - 1;
  }
  // The lane's 16-byte half of an A row's 32-byte k step.
  __device__ __forceinline__ uint32_t akoff() const { return (lane >> 4) * 16; }
  // Output channel (even) of n8 tile nt in a chunk starting at n0.
  __device__ __forceinline__ int col(int n0, int nt) const {
    return n0 + (wn * kNT + nt) * 8 + (lane & 3) * 2;
  }
};

// The A offset of each successive k32 step of a GEMM (k = 0, 32, ...).
struct PlainK {
  uint32_t k = 0;
  __device__ __forceinline__ uint32_t next() {
    k += 32;
    return k - 32;
  }
};

// The 3x3's k = tap * Cb + channel: tap (dy, dx) is the h1 row dy*(W+2) +
// dx after the output pixel's top-left neighbour. Stepped, not divided:
// a division a step sits between the k position and the ldmatrix.
struct TapK {
  int cb, w2, stride;
  int t = 0, ch = 0;
  uint32_t base = 0;  // the A offset of tap t
  __device__ __forceinline__ uint32_t next() {
    const uint32_t off = base + ch;
    ch += 32;
    if (ch == cb) {
      ch = 0;
      ++t;
      const int dy = t / 3;
      base = (dy * w2 + t - 3 * dy) * stride;
    }
    return off;
  }
};

// cp.async.wait_group takes an immediate: at most n groups pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// The weights of a unit's GEMMs, in the order the block runs them, as one
// stream of 64-byte K slices through a ring of `stages` slots: phase A's
// (w1 chunks) for each pixel pass, phase B's (w2), phase C's (wsc then w3
// per chunk of output channels). A GEMM consumes its slices and each
// consumed slice frees a slot for the slice stages - 1 ahead, which may
// belong to the next GEMM: the next GEMM's first slices load during this
// one and its epilogue, and phase A's during phase 0.
//
// Only the WM warps of one column group (wn) read a slot's rows of that
// group's 32 channels, so each group copies its own rows and waits on its
// own barrier (named barrier 1 + wn over WM warps; a warp alone at WM = 1
// needs only __syncwarp): the groups run apart, their ldmatrix bursts and
// MMAs interleaving, instead of all eight warps meeting every slice.
template <int WM, bool SC>
struct WeightStream {
  static constexpr int NC = Tiling<WM>::NC;
  // A group's 32 rows of kBC chunks over its WM warps: kEach chunks a
  // thread, kStep rows apart.
  static constexpr int kEach = kBC / WM, kStep = WM * 32 / kBC;
  const UnitParams& p;
  uint8_t* ring;
  int n_a, n_b, n_jobs;     // jobs (GEMMs) of phases A and B, and in all
  int ch_b, ch_c;           // output-channel chunks of Cb and Cout
  // This thread's chunks of the next slice to issue, slice s of job j
  // (k_len bytes a row): rows src + i * step (those in `rows`), 16 bytes
  // at s * 64 + col.
  int j, s, slices, k_len, col, rows;
  const int8_t* src;
  const int8_t* any;        // an address in the weight, for masked chunks
  size_t step;
  int put, take;            // ring slots of the next issue and the front
#ifdef K2_PHASE_CLOCKS
  long long waited = 0;
#endif

  __device__ __forceinline__ WeightStream(const UnitParams& prm, uint8_t* r,
                                          int m1, int m)
      : p(prm), ring(r), j(0), s(0), put(0), take(0) {
    ch_b = (p.cb + NC - 1) / NC;
    ch_c = (p.cout + NC - 1) / NC;
    const int mc = Tiling<WM>::MC;
    n_a = (m1 + mc - 1) / mc * ch_b;
    n_b = (m + mc - 1) / mc * ch_b;
    n_jobs = n_a + n_b + (m + mc - 1) / mc * ch_c * (SC ? 2 : 1);
    job(0);
  }

  __device__ __forceinline__ void job(int jj) {
    if (jj >= n_jobs) return;
    if (jj < n_a) {
      set(p.w1, p.cin, p.cb, jj % ch_b);
    } else if (jj < n_a + n_b) {
      set(p.w2, 9 * p.cb, p.cb, (jj - n_a) % ch_b);
    } else {
      const int q = jj - n_a - n_b;
      const int chunk = (SC ? q / 2 : q) % ch_c;
      if (SC && q % 2 == 0)
        set(p.wsc, p.cin, p.cout, chunk);
      else
        set(p.w3, p.cb, p.cout, chunk);
    }
  }

  // Job: rows [chunk * NC, chunk * NC + NC) of the k-major (n, k) weight w;
  // this thread copies chunk column `col` of rows r0 + i * kStep.
  __device__ __forceinline__ void set(const int8_t* w, int k, int n,
                                      int chunk) {
    const int gt = group_thread();
    const int r0 = chunk * NC + group() * 32 + gt / kBC;
    k_len = k;
    col = gt % kBC * 16;
    slices = (k + kBK - 1) / kBK;
    step = (size_t)kStep * k;
    src = w + (size_t)r0 * k + col;
    any = w;
    rows = 0;
#pragma unroll
    for (int i = 0; i < kEach; ++i) rows |= (r0 + i * kStep < n) << i;
  }

  // Issues the next slice's rows of this thread's column group into slot
  // `put` (if any is left) and commits a cp.async group either way, so
  // that group g holds slice g.
  __device__ __forceinline__ void issue() {
    if (j < n_jobs) {
      // The group's 32 rows of 4 16-byte chunks over its WM warps.
      const int gt = group_thread();
      uint8_t* dst = ring + put * NC * kBRow +
                     (group() * 32 + gt / kBC) * kBRow + col;
      const bool k_ok = s * kBK + col < k_len;
#pragma unroll
      for (int i = 0; i < kEach; ++i) {
        const bool ok = k_ok && (rows >> i & 1);
        cp_async16(dst + i * kStep * kBRow,
                   ok ? src + i * step + s * kBK : any, ok);
      }
      put = put + 1 == p.stages ? 0 : put + 1;
      if (++s == slices) {
        s = 0;
        job(++j);
      }
    }
    cp_async_commit();
  }

  // Warps wm * WN + wn share column group wn (Place's layout).
  __device__ __forceinline__ int group() const {
    return (threadIdx.x >> 5) % Tiling<WM>::WN;
  }
  __device__ __forceinline__ int group_thread() const {
    return (threadIdx.x >> 5) / Tiling<WM>::WN * 32 + (threadIdx.x & 31);
  }

  // Waits for the front slice (and for the group's warps to be done with
  // the slot before it, which the next issue refills); returns the front
  // slot.
  __device__ __forceinline__ uint8_t* front() {
#ifdef K2_PHASE_CLOCKS
    const long long t0 = clock64();
#endif
    cp_async_wait_n(p.stages - 2);
    if constexpr (WM == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group()), "n"(WM * 32)
                   : "memory");
    }
#ifdef K2_PHASE_CLOCKS
    waited += clock64() - t0;
#endif
    uint8_t* f = ring + take * NC * kBRow;
    take = take + 1 == p.stages ? 0 : take + 1;
    issue();
    return f;
  }
};

// acc = A . B^T for this warp's 64 x 32 tile of a chunk: A rows resident in
// shared memory (arow: this lane's row addresses, koff.next() the offset of
// each k32 step), B the next K slices of the weight stream (K bytes). m16
// tiles with mok false are skipped.
template <int WM, bool SC, class KOff>
__device__ __forceinline__ void gemm(int (&acc)[kMT][kNT][4],
                                     const uint32_t (&arow)[kMT],
                                     const bool (&mok)[kMT], KOff koff, int K,
                                     WeightStream<WM, SC>& ws,
                                     const Place<WM>& pl) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  // ldmatrix.x4 of B: lanes 0-7 / 8-15 / 16-23 / 24-31 address channels
  // 0-7 k 0-15 / 0-7 k 16-31 / 8-15 k 0-15 / 8-15 k 16-31 of an n16 pair.
  const int bn = (pl.wn * kNT) * 8 + (pl.lane & 7) + (pl.lane >> 4) * 8;
  const uint32_t b_lane = bn * kBRow + ((pl.lane >> 3) & 1) * 16;
  // What the caller's previous epilogue wrote (h1, h2) is visible to every
  // warp; the weight ring needs no block barrier (WeightStream).
  __syncthreads();
  // The warp's m16 tiles that hold pixels are a prefix: when all do, the
  // MMAs are issued unpredicated (a predicated mma.sync costs a WARPSYNC).
  const bool full = mok[kMT - 1];
  const int slices = (K + kBK - 1) / kBK;
  for (int s = 0; s < slices; ++s) {
    const uint32_t b_s = smem_u32(ws.front()) + b_lane;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const int k = s * kBK + kk * 32;
      if (k >= K) break;
      // The step's fragments first, then its 16 MMAs (the asm statements
      // keep their order).
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        ldmatrix_x4(b_s + np * 16 * kBRow + kk * 32, b[2 * np][0],
                    b[2 * np][1], b[2 * np + 1][0], b[2 * np + 1][1]);
      const uint32_t ko = koff.next();
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(arow[mt] + ko, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
      if (full) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
      } else {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (!mok[mt]) continue;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
        }
      }
    }
  }
}

// v[c], v[c + 1] of this thread's columns in a chunk (0 past n).
template <int WM>
__device__ __forceinline__ void col_pairs(const float* __restrict__ v, int n,
                                          int n0, const Place<WM>& pl,
                                          float2 (&out)[kNT]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = pl.col(n0, nt);
    out[nt] = c < n ? __ldg(reinterpret_cast<const float2*>(v + c))
                    : make_float2(0.f, 0.f);
  }
}

// clip(rint(fma(y, m, a)), 0, 127) of a column pair, as two int8 bytes.
__device__ __forceinline__ uint16_t requant2(int y0, int y1, float2 m,
                                             float2 a) {
  const uint32_t q0 = sat_s8(__fmaf_rn(__int2float_rn(y0), m.x, a.x), 0.f);
  const uint32_t q1 = sat_s8(__fmaf_rn(__int2float_rn(y1), m.y, a.y), 0.f);
  return (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
}

// The requant epilogue of phases A and B: acc -> int8 rows of `dst` (row
// stride `stride`) at the row index map(pixel), with the chunk's
// multipliers mv, av (col_pairs, loaded before the GEMM so that their
// latency hides behind it).
template <int WM, class Map>
__device__ __forceinline__ void store_requant(const int (&acc)[kMT][kNT][4],
                                              const bool (&mok)[kMT], int m0,
                                              int m, int n0, int n,
                                              const float2 (&mv)[kNT],
                                              const float2 (&av)[kNT],
                                              uint8_t* dst, int stride,
                                              Map map, const Place<WM>& pl) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (!mok[mt]) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = pl.mrow(m0, mt) + (pl.lane >> 2) + half * 8;
      if (r >= m) continue;
      uint8_t* row = dst + (size_t)map(r) * stride;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = pl.col(n0, nt);
        if (c >= n) continue;
        *reinterpret_cast<uint16_t*>(row + c) =
            requant2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                     mv[nt], av[nt]);
      }
    }
  }
}

// Phase 0: the pre-activation of `count` contiguous x rows (Cin channels)
// into pq rows of Cin + kPad bytes. Thread t takes 16-byte chunks t,
// t + 256, ...; where 256 is a multiple of Cin / 8 its chunks share one
// channel group, whose pa / pb are loaded once.
__device__ __forceinline__ void quantise_rows(const UnitParams& p,
                                              const __nv_bfloat16* x,
                                              int count, uint8_t* pq) {
  const int groups = p.cin >> 3;
  const int total = count * groups;
  const int stride = p.cin + kPad;
  const int tid = threadIdx.x;
  const bool fixed = kThreads % groups == 0;
  float a[8], b[8];
  auto load8 = [](const float* src, float (&v)[8]) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  };
  if (fixed) {
    load8(p.pa + (tid % groups) * 8, a);
    load8(p.pb + (tid % groups) * 8, b);
  }
  constexpr int kU = 8;  // loads in flight per thread
  for (int base = 0; base < total; base += kU * kThreads) {
    uint4 raw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int idx = base + u * kThreads + tid;
      if (idx < total)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(x) + idx);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int idx = base + u * kThreads + tid;
      if (idx >= total) break;
      const int row = idx / groups, g = idx - row * groups;
      if (!fixed) {
        load8(p.pa + g * 8, a);
        load8(p.pb + g * 8, b);
      }
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(xv[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
      *reinterpret_cast<uint2*>(pq + (size_t)row * stride + g * 8) =
          preact_q8(v, a, b, 1.f, 1.f, 0);
    }
  }
}

template <int WM, bool SC>
__global__ void __launch_bounds__(kThreads, 1)
    k2_unit_kernel(const __grid_constant__ UnitParams p) {
  using T = Tiling<WM>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* h1 = smem;
  uint8_t* pq = smem + p.off_pq;
  uint8_t* h2 = smem + p.off_h2;
  uint8_t* ring = smem + p.off_ring;
  const Place<WM> pl;

  const int frame = blockIdx.x / p.tiles;
  const int r0 = (blockIdx.x - frame * p.tiles) * p.rows;
  const int rows = min(p.rows, p.h - r0);
  const int ylo = max(r0 - 1, 0);
  const int halo = min(r0 + rows, p.h - 1) - ylo + 1;
  const int w = p.w, w2 = w + 2;
  const int m1 = halo * w;   // pixels of phase A (the halo rows too)
  const int m = rows * w;    // output pixels
  const int s_pq = p.cin + kPad, s_h = p.cb + kPad;
  const size_t px0 = ((size_t)frame * p.h + r0) * w;  // first output pixel

  stamp(0);
  // Phase A's first weight slices load while x is read.
  WeightStream<WM, SC> ws(p, ring, m1, m);
  for (int i = 0; i < p.stages - 1; ++i) ws.issue();
  // h1's border columns and the rows outside the image are the 3x3's zeros.
  for (int i = threadIdx.x * 16; i < p.off_pq; i += kThreads * 16)
    *reinterpret_cast<uint4*>(h1 + i) = make_uint4(0, 0, 0, 0);
  quantise_rows(p, p.x + ((size_t)frame * p.h + ylo) * w * p.cin, m1, pq);
  stamp(1);

  int acc[kMT][kNT][4];
  uint32_t arow[kMT];
  bool mok[kMT];
  auto rows_of = [&](int m0, int count, uint8_t* base, int stride,
                     int shift) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      mok[mt] = pl.mrow(m0, mt) < count;
      arow[mt] = smem_u32(base) + (pl.arow(m0, mt, count) + shift) * stride +
                 pl.akoff();
    }
  };

  // Phase A: h1 = requant(pq . w1) on the halo rows.
  for (int m0 = 0; m0 < m1; m0 += T::MC) {
    rows_of(m0, m1, pq, s_pq, 0);
    for (int n0 = 0; n0 < p.cb; n0 += T::NC) {
      float2 mv[kNT], av[kNT];
      col_pairs<WM>(p.q1m, p.cb, n0, pl, mv);
      col_pairs<WM>(p.q1a, p.cb, n0, pl, av);
      gemm(acc, arow, mok, PlainK(), p.cin, ws, pl);
      // halo pixel j: image row ylo + j / w -> h1 plane row ylo + j/w - r0 + 1
      const int top = (ylo - r0 + 1) * w2 + 1;
      store_requant<WM>(acc, mok, m0, m1, n0, p.cb, mv, av, h1, s_h,
                        [=](int j) { return top + j + (j / w) * 2; }, pl);
    }
  }

  stamp(2);

  // Phase B: h2 = requant(conv3x3(h1) . w2). Output pixel i = (r, c) reads
  // tap (dy, dx) at h1 plane row (r + dy) * (W + 2) + c + dx.
  for (int m0 = 0; m0 < m; m0 += T::MC) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int i = pl.arow(m0, mt, m);
      mok[mt] = pl.mrow(m0, mt) < m;
      arow[mt] = smem_u32(h1) + (i + (i / w) * 2) * s_h + pl.akoff();
    }
    for (int n0 = 0; n0 < p.cb; n0 += T::NC) {
      float2 mv[kNT], av[kNT];
      col_pairs<WM>(p.q2m, p.cb, n0, pl, mv);
      col_pairs<WM>(p.q2a, p.cb, n0, pl, av);
      gemm(acc, arow, mok, TapK{p.cb, w2, s_h}, 9 * p.cb, ws, pl);
      store_requant<WM>(acc, mok, m0, m, n0, p.cb, mv, av, h2, s_h,
                        [](int i) { return i; }, pl);
    }
  }

  stamp(3);

  // Phase C: out = bf16(fma(h2 . w3, d3m, shortcut) + d3a) [+ next pq].
  const float ns = p.pq_out != nullptr && p.nmode == 1 ? __ldg(p.ns) : 1.f;
  const float ny = div_recip(ns);
  for (int m0 = 0; m0 < m; m0 += T::MC) {
    for (int n0 = 0; n0 < p.cout; n0 += T::NC) {
      // The shortcut of each accumulator pair: f32 for a projection, the
      // identity's bf16 pair of x as loaded (before the GEMM, so that the
      // loads are in flight during it).
      float sc[SC ? kMT : 1][kNT][4];
      __nv_bfloat162 xr[SC ? 1 : kMT][kNT][2];
      if constexpr (SC) {
        // pq of output pixel i is pq row i + (r0 - ylo) * W.
        rows_of(m0, m, pq, s_pq, (r0 - ylo) * w);
        float2 mv[kNT], av[kNT];
        col_pairs<WM>(p.dscm, p.cout, n0, pl, mv);
        col_pairs<WM>(p.dsca, p.cout, n0, pl, av);
        gemm(acc, arow, mok, PlainK(), p.cin, ws, pl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              sc[mt][nt][i] = __fmaf_rn(__int2float_rn(acc[mt][nt][i]),
                                        i & 1 ? mv[nt].y : mv[nt].x,
                                        i & 1 ? av[nt].y : av[nt].x);
      } else {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = pl.mrow(m0, mt) + (pl.lane >> 2) + half * 8;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const int c = pl.col(n0, nt);
              xr[mt][nt][half] = __floats2bfloat162_rn(0.f, 0.f);
              if (r < m && c < p.cout)
                xr[mt][nt][half] = *reinterpret_cast<const __nv_bfloat162*>(
                    p.x + (px0 + r) * p.cin + c);
            }
          }
      }
      rows_of(m0, m, h2, s_h, 0);
      float2 mv[kNT], av[kNT], na[kNT], nb[kNT];
      col_pairs<WM>(p.d3m, p.cout, n0, pl, mv);
      col_pairs<WM>(p.d3a, p.cout, n0, pl, av);
      if (p.pq_out != nullptr) {
        col_pairs<WM>(p.na, p.cout, n0, pl, na);
        col_pairs<WM>(p.nb, p.cout, n0, pl, nb);
      }
      gemm(acc, arow, mok, PlainK(), p.cb, ws, pl);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (!mok[mt]) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = pl.mrow(m0, mt) + (pl.lane >> 2) + half * 8;
          if (r >= m) continue;
          const size_t o = (px0 + r) * p.cout;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int c = pl.col(n0, nt);
            if (c >= p.cout) continue;
            float2 res;
            if constexpr (SC) {
              res = make_float2(sc[mt][nt][2 * half], sc[mt][nt][2 * half + 1]);
            } else {
              res = __bfloat1622float2(xr[mt][nt][half]);
            }
            const float v0 = __fadd_rn(
                __fmaf_rn(__int2float_rn(acc[mt][nt][2 * half]), mv[nt].x,
                          res.x),
                av[nt].x);
            const float v1 = __fadd_rn(
                __fmaf_rn(__int2float_rn(acc[mt][nt][2 * half + 1]),
                          mv[nt].y, res.y),
                av[nt].y);
            const __nv_bfloat162 ob = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(p.out + o + c) = ob;
            if (p.pq_out != nullptr) {
              const float2 st = __bfloat1622float2(ob);
              const uint2 q = preact_q2(st.x, st.y, na[nt].x, na[nt].y,
                                        nb[nt].x, nb[nt].y, ns, ny, p.nmode);
              *reinterpret_cast<uint16_t*>(p.pq_out + o + c) =
                  (uint16_t)((q.x & 0xFF) | ((q.y & 0xFF) << 8));
            }
          }
        }
      }
    }
  }
#ifdef K2_PHASE_CLOCKS
  stamp(4, ws.waited);
#endif
}

template <int WM, bool SC>
int launch(const UnitParams& p, int n, int smem, cudaStream_t st) {
  auto kernel = k2_unit_kernel<WM, SC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n * p.tiles, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool SC>
int launch_wm(const UnitParams& p, int n, int wm, int smem, cudaStream_t st) {
  switch (wm) {
    case 1: return launch<1, SC>(p, n, smem, st);
    case 2: return launch<2, SC>(p, n, smem, st);
    case 4: return launch<4, SC>(p, n, smem, st);
  }
  return kErrPlan;
}

}  // namespace

extern "C" {

// Launches one unit on `stream`; returns 0, a cudaError_t or a kErr code.
// x (n, h, w, cin) bf16; out (n, h, w, cout) bf16; pq_out (n, h, w, cout)
// int8 or null, with na / nb (cout,) f32 and ns (1,) f32 for nmode 1;
// pa / pb (cin,); w1 (cb, cin), w2 (cb, 9 cb), w3 (cout, cb), wsc (cout,
// cin) or null, all int8 k-major; q1m / q1a / q2m / q2a (cb,), d3m / d3a /
// dscm / dsca (cout,) f32. rows, warp_rows, stages and smem_bytes come from
// the wrapper's k2_plan and are checked against the kernel's own layout. The
// wrapper checks dtypes, devices and 16-byte alignment.
int k2_unit_launch(const void* x, void* out, void* pq_out, const float* pa,
                   const float* pb, const void* w1, const float* q1m,
                   const float* q1a, const void* w2, const float* q2m,
                   const float* q2a, const void* w3, const float* d3m,
                   const float* d3a, const void* wsc, const float* dscm,
                   const float* dsca, const float* na, const float* nb,
                   const float* ns, int nmode, int n, int h, int w, int cin,
                   int cb, int cout, int rows, int warp_rows, int stages,
                   int smem_bytes, void* stream) {
  const bool sc = wsc != nullptr;
  if (cin <= 0 || cb <= 0 || cout <= 0 || cin % 32 || cb % 32 || cout % 32 ||
      h <= 0 || w <= 0 || (!sc && cin != cout) || nmode < 0 || nmode > 1)
    return kErrShape;
  if (rows < 1 || rows > h || stages < kMinStages || stages > kMaxStages ||
      (warp_rows != 1 && warp_rows != 2 && warp_rows != 4))
    return kErrPlan;
  const Layout l = layout(h, w, cin, cb, rows, 256 / warp_rows, sc, stages);
  if (l.total != smem_bytes) return kErrPlan;
  if (n <= 0) return (int)cudaSuccess;
  UnitParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.pq_out = static_cast<int8_t*>(pq_out);
  p.pa = pa;
  p.pb = pb;
  p.w1 = static_cast<const int8_t*>(w1);
  p.q1m = q1m;
  p.q1a = q1a;
  p.w2 = static_cast<const int8_t*>(w2);
  p.q2m = q2m;
  p.q2a = q2a;
  p.w3 = static_cast<const int8_t*>(w3);
  p.d3m = d3m;
  p.d3a = d3a;
  p.wsc = static_cast<const int8_t*>(wsc);
  p.dscm = dscm;
  p.dsca = dsca;
  p.na = na;
  p.nb = nb;
  p.ns = ns;
  p.nmode = nmode;
  p.h = h; p.w = w; p.cin = cin; p.cb = cb; p.cout = cout; p.rows = rows;
  p.tiles = (h + rows - 1) / rows;
  p.stages = stages;
  p.off_pq = l.pq;
  p.off_h2 = l.h2;
  p.off_ring = l.ring;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sc ? launch_wm<true>(p, n, warp_rows, smem_bytes, st)
            : launch_wm<false>(p, n, warp_rows, smem_bytes, st);
}

#ifdef K2_PHASE_CLOCKS
// Points the phase stamps at a (grid, 8) uint64 device buffer (or null).
int k2_unit_set_clocks(void* buf) {
  return (int)cudaMemcpyToSymbol(k2_clocks, &buf, sizeof(buf));
}
#endif

const char* k2_unit_error_string(int code) {
  switch (code) {
    case kErrPlan: return "the wrapper's k2_plan disagrees with the kernel";
    case kErrShape: return "a shape the K2 kernel does not take";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
