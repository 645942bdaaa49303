#!/usr/bin/env python3
"""chip_smoke.py's phase 20 alone: the int8 root stems (the stem and the
max pool in one kernel) and the int8 residual stream, every kernel against
its plain version and timed, and the bench predictor with int8_root="u8".

    python3 scripts/bench_int8_root.py [--ptxas]

Needs one CUDA card and nvcc. It builds the kernels (one nvcc process per
source, started together), makes the full-width model, the 480-frame
uint8 clip, the calibration frames and the bench-config predictor as
chip_smoke.py's main does (seeded weights and frames), and runs
``chip_smoke.phase_int8_root``. ``--ptxas`` first prints nvcc's register,
shared-memory and spill report of csrc/int8_root.cu and csrc/resnet_int8.cu,
then, for every input kind and fold of the fused stem + pool at 224x224 and
at 224x320 (column bands), with the mode-3 pre-activation and, for the u8
kinds, the border map, the dynamic shared memory its launcher asks for,
the blocks an SM holds with it, and its registers and spilled bytes a thread
as the loaded library reports them.
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


def fit_report():
    import ctypes

    from human_dynamics_tpu_torch.ops import int8_root_cuda as R

    lib = R._kernel_library()
    lib.int8_root_pool_fit.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.int8_root_pool_fit.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    for h, w in ((224, 224), (224, 320)):
        for kind, code in R.INPUTS.items():
            for fold, f in R.FOLDS.items():
                # As the trunk calls it: the mode-3 pre-activation, and
                # the "u8" stem's border map for the u8 kinds.
                rc = lib.int8_root_pool_fit(code, f, h, w, 3, kind != "f32",
                                            out)
                if rc != 0:
                    msg = lib.int8_root_error_string(rc).decode()
                    raise SystemExit(f"int8_root_pool_fit: {msg} ({rc})")
                print(f"stem + pool {kind} {fold} {h}x{w}: {out[0]} bytes of "
                      f"dynamic shared memory, {out[1]} blocks an SM, "
                      f"{out[2]} registers and {out[3]} local bytes a thread")


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
    if "--ptxas" in sys.argv[1:]:
        fit_report()
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
