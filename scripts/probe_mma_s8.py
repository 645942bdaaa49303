#!/usr/bin/env python3
"""The rate of int8 mma.sync (m16n8k32, s32 accumulate) on one NVIDIA GPU:
the ceiling of K2's kernel (csrc/k2_unit.cu), which is built on it.

    python3 scripts/probe_mma_s8.py

Each warp issues independent mma.sync chains, either on register operands
(no memory traffic) or with K2's warp tile: per k32 step, four A and two B
ldmatrix.x4 from shared memory, then 4 x 4 mma.sync on 16 accumulators.
The grid is 132 SMs x 1, 2 or 4 blocks of 8 warps. Then K2's GEMM loop as
a whole: the warp tile with B through a cp.async ring, a wait and a
barrier every 64-byte slice, at its three tilings. Prints TOP/s per
configuration, by CUDA events, beside the card's name and power limit. The
kernel source is written into ops/_build/ and built with the package's
nvcc flags.
"""

import ctypes
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldm(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Register operands: kChains independent accumulators per warp.
template <int kChains>
__global__ void __launch_bounds__(256) mma_regs(int* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x01010101u * (threadIdx.x + i);
  for (int i = 0; i < 2; ++i) b[i] = 0x01020304u + i;
  int c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) mma(c[j], a, b);
  }
  int s = 0;
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// K2's warp tile: per k32 step 4 A + 2 B ldmatrix.x4 (80-byte rows), then
// 16 mma.sync on a 64 x 32 tile of accumulators.
__global__ void __launch_bounds__(256) mma_tile(int* out, int iters) {
  __shared__ __align__(128) uint8_t tile[2][64 * 80];
  for (int i = threadIdx.x; i < 2 * 64 * 80; i += 256)
    (&tile[0][0])[i] = (uint8_t)(i * 7);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(&tile[0][0]);
  const uint32_t a_row = base + ((lane & 7) + ((lane >> 3) & 1) * 8) * 80 + (lane >> 4) * 16;
  const uint32_t b_row = base + 64 * 80 + ((lane & 7) + (lane >> 4) * 8) * 80 + ((lane >> 3) & 1) * 16;
  int c[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
    const uint32_t k = (it & 1) * 32;
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldm(b_row + np * 16 * 80 + k, r);
      b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) ldm(a_row + mt * 16 * 80 + k, a[mt]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma(c[mt][nt], a[mt], b[nt]);
  }
  int s = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) s += c[i][j][0] + c[i][j][1] + c[i][j][2] + c[i][j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// K2's GEMM loop: the warp tile above with B from a ring of kStages slots of
// 64-byte K slices (kNc rows of 80 bytes), each slice a cp.async of 16-byte
// chunks from a weight in L2, a cp.async.wait_group and a __syncthreads
// per slice of two k32 steps.
template <int kNc, int kStages>
__global__ void __launch_bounds__(256) mma_ring(int* out, const uint8_t* w,
                                                int iters, int a_stride) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  uint8_t* a_tile = smem + kStages * kNc * 80;
  for (int i = threadIdx.x; i < 256 * a_stride; i += 256) a_tile[i] = (uint8_t)(i * 7);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWn = kNc / 32, kWm = 8 / kWn;
  const int wm = warp / kWn, wn = warp % kWn;
  const uint32_t a_row = (uint32_t)__cvta_generic_to_shared(a_tile) +
      (wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8) * a_stride + (lane >> 4) * 16;
  const uint32_t b_lane = (wn * 32 + (lane & 7) + (lane >> 4) * 8) * 80 +
                          ((lane >> 3) & 1) * 16;
  constexpr int kChunks = kNc * 4 / 256;
  auto issue = [&](int s) {
    uint8_t* dst = ring + (s % kStages) * kNc * 80;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = threadIdx.x + i * 256, r = idx >> 2, c = idx & 3;
      const uint8_t* src = w + ((size_t)r * 4096 + (s % 64) * 64 + c * 16);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(dst + r * 80 + c * 16)),
                   "l"(src) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int c[4][4][4] = {};
  for (int s = 0; s < iters; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    issue(s + kStages - 1);
    const uint32_t b_s = (uint32_t)__cvta_generic_to_shared(ring + (s % kStages) * kNc * 80) + b_lane;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldm(b_s + np * 16 * 80 + kk * 32, r);
        b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldm(a_row + mt * 16 * a_stride + ((s * 64 + kk * 32) % (a_stride - 16)), a[mt]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(c[mt][nt], a[mt], b[nt]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  int t = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) t += c[i][j][0] + c[i][j][1] + c[i][j][2] + c[i][j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t + kWm;
}

template <int kNc, int kStages>
int ring_launch(int* out, const uint8_t* w, int blocks, int iters,
                int a_stride, int smem) {
  smem = max(smem, kStages * kNc * 80 + 256 * a_stride);
  auto k = mma_ring<kNc, kStages>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<blocks, 256, smem>>>(out, w, iters, a_stride);
  return (int)cudaGetLastError();
}

// K2's GEMM loop at its three tilings (64, 128 or 256 channels a chunk),
// A rows a_stride bytes apart, smem bytes of shared memory at least.
extern "C" int probe_ring(int* out, const uint8_t* w, int blocks, int nc,
                          int stages, int iters, int a_stride, int smem) {
  if (nc == 64) return stages == 3 ? ring_launch<64, 3>(out, w, blocks, iters, a_stride, smem)
                                   : ring_launch<64, 8>(out, w, blocks, iters, a_stride, smem);
  if (nc == 128) return stages == 3 ? ring_launch<128, 3>(out, w, blocks, iters, a_stride, smem)
                                    : ring_launch<128, 6>(out, w, blocks, iters, a_stride, smem);
  return stages == 3 ? ring_launch<256, 3>(out, w, blocks, iters, a_stride, smem)
                     : ring_launch<256, 4>(out, w, blocks, iters, a_stride, smem);
}

extern "C" int probe_launch(int* out, int blocks, int chains, int iters) {
  if (chains == 0) mma_tile<<<blocks, 256>>>(out, iters);
  else if (chains == 4) mma_regs<4><<<blocks, 256>>>(out, iters);
  else if (chains == 8) mma_regs<8><<<blocks, 256>>>(out, iters);
  else mma_regs<16><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_mma_s8: no CUDA device")
    sys.path.insert(0, HERE)
    from human_dynamics_tpu_torch.ops import _build as build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    key = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    src = os.path.join(build.BUILD_DIR, f"probe_mma_s8_{key}.cu")
    lib_path = src[:-3] + ".so"
    if not os.path.exists(lib_path):
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                        src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.probe_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.probe_launch.restype = ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for per_sm in (1, 2, 4):
        for chains in (4, 8, 16, 0):
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
            launch = lambda: lib.probe_launch(out.data_ptr(), blocks, chains,
                                              iters)
            check = launch()
            if check:
                raise RuntimeError(f"probe launch failed: {check}")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            per_iter = 16 if chains == 0 else chains
            ops = blocks * 8 * iters * per_iter * 2 * 16 * 8 * 32
            what = ("K2's warp tile (6 ldmatrix.x4 + 16 mma a k32 step)"
                    if chains == 0 else f"{chains} register chains per warp")
            print(f"mma.sync m16n8k32 s8: {per_sm} block(s) of 8 warps per "
                  f"SM, {what}: {ops / ms / 1e9:.1f} TOP/s ({ms:.4f} ms) "
                  f"[{card}]")
    # K2's GEMM loop: B through the cp.async ring, one block per SM; A rows
    # 80 bytes apart, or 528 (a pq row of Cin 512) in a block that takes
    # 200 KB of shared memory, as K2's do.
    lib.probe_ring.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    lib.probe_ring.restype = ctypes.c_int
    w = torch.randint(-127, 128, (256, 4096), dtype=torch.int8, device="cuda")
    out = torch.empty(sms * 256, dtype=torch.int32, device="cuda")
    slices = 2048
    for nc, stages in ((64, 3), (64, 8), (128, 3), (128, 6), (256, 3),
                       (256, 4)):
        for a_stride, smem in ((80, 0), (80, 200 * 1024), (528, 0),
                               (528, 200 * 1024)):
            launch = lambda: lib.probe_ring(out.data_ptr(), w.data_ptr(), sms,
                                            nc, stages, slices, a_stride, smem)
            check = launch()
            if check:
                raise RuntimeError(f"probe launch failed: {check}")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            ops = sms * 8 * slices * 32 * 2 * 16 * 8 * 32
            print(f"mma.sync m16n8k32 s8, K2's GEMM loop (B through a "
                  f"{stages}-slot cp.async ring of {nc} x 64-byte slices, a "
                  f"barrier a slice; A rows {a_stride} bytes apart; "
                  f"{max(smem, stages * nc * 80 + 256 * a_stride)} bytes of "
                  f"shared memory), 1 block of 8 warps per SM: "
                  f"{ops / ms / 1e9:.1f} TOP/s, {ms / slices * 1e6:.1f} ns a "
                  f"slice [{card}]")


if __name__ == "__main__":
    main()
