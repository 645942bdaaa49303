#!/usr/bin/env python3
"""The rate of TF32 mma.sync (m16n8k8, fp32 accumulate) on one NVIDIA GPU:
the ceiling of a kernel built on it, such as K1.

    python3 scripts/probe_mma_tf32.py

Each warp issues chains of independent mma.sync on register operands (no
memory traffic); the grid is 132 SMs x 1, 2 or 4 blocks of 8 warps. Prints
TFLOP/s per configuration, by CUDA events, beside the card's name and
power limit. The kernel source is written into ops/_build/ and built with
the package's nvcc flags.
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

template <int kChains>
__global__ void __launch_bounds__(256) mma_tf32_probe(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-6f * (i + 1));
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int probe_launch(float* out, int blocks, int chains, int iters) {
  if (chains == 4) mma_tf32_probe<4><<<blocks, 256>>>(out, iters);
  else if (chains == 8) mma_tf32_probe<8><<<blocks, 256>>>(out, iters);
  else mma_tf32_probe<12><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_mma_tf32: no CUDA device")
    sys.path.insert(0, HERE)
    from human_dynamics_tpu_torch.ops import _build as build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    key = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    src = os.path.join(build.BUILD_DIR, f"probe_mma_tf32_{key}.cu")
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
        for chains in (4, 8, 12):
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, device="cuda")
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
            flop = blocks * 8 * iters * chains * 2 * 16 * 8 * 8
            print(f"mma.sync m16n8k8 TF32: {per_sm} block(s) of 8 warps per "
                  f"SM, {chains} chains per warp: {flop / ms / 1e9:.1f} "
                  f"TFLOP/s ({ms:.4f} ms) [{card}]")


if __name__ == "__main__":
    main()
