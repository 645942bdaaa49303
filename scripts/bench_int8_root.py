#!/usr/bin/env python3
"""chip_smoke.py's phase 20 alone: the int8 root stems and the int8
residual stream, every new kernel against its plain version and timed, and
the bench predictor with int8_root="u8".

    python3 scripts/bench_int8_root.py [--ptxas]

Needs one CUDA card and nvcc. It builds the kernels (one nvcc process per
source, started together), makes the full-width model, the 480-frame
uint8 clip, the calibration frames and the bench-config predictor as
chip_smoke.py's main does (seeded weights and frames), and runs
``chip_smoke.phase_int8_root``. ``--ptxas`` first prints nvcc's register,
shared-memory and spill report of csrc/int8_root.cu and csrc/resnet_int8.cu.
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def ptxas_report(name):
    from human_dynamics_tpu_torch.ops._build import CSRC_DIR, find_nvcc

    out = subprocess.run(
        [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull,
         os.path.join(CSRC_DIR, name + ".cu")],
        capture_output=True, text=True, timeout=600)
    print(out.stdout + out.stderr)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed ({out.returncode})")


def main():
    import numpy as np
    import torch

    import chip_smoke as S

    if not torch.cuda.is_available():
        raise SystemExit("bench_int8_root: no CUDA device; this script needs "
                         "one GPU")
    if "--ptxas" in sys.argv[1:]:
        for name in ("int8_root", "resnet_int8"):
            ptxas_report(name)
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.infer import HmmrPredictor
    from human_dynamics_tpu_torch.models import HmmrModel
    from human_dynamics_tpu_torch.ops import int8_root_cuda
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
    from human_dynamics_tpu_torch.ops import smpl_cuda
    from human_dynamics_tpu_torch.ops._build import load_kernel_libraries

    card = S.card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    S.build_all(load_kernel_libraries, [smpl_cuda.KERNEL_NAME, K.KERNEL_NAME,
                                        K.K2_KERNEL_NAME,
                                        int8_root_cuda.KERNEL_NAME])
    dev = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(num_verts=S.SMPL_VERTS, num_kps=S.SMPL_KPS,
                                device=dev)
    model = HmmrModel(include_resnet=True, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (S.N_FRAMES, S.IMG, S.IMG, 3),
                           dtype=torch.uint8, device=dev, generator=gen)
    calib = torch.randint(0, 256, (S.N_CALIB, S.IMG, S.IMG, 3),
                          dtype=torch.uint8, device=dev, generator=gen)
    kw = dict(batch_size=8, seq_length=20, device=dev)
    bench = HmmrPredictor(model, None, smpl, int8_encoder=True,
                          int8_calibration=calib, bf16_temporal=True,
                          use_fused_smpl=True, **kw)
    t0 = time.perf_counter()
    out = S.phase_int8_root(torch, np, model, frames, calib, bench, smpl, kw,
                            K, smpl_cuda, card)
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    print(out)
    print(card)


if __name__ == "__main__":
    main()
