#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

0. Device: a CUDA device must be present; print the card's name and power
   limit (nvidia-smi) and the torch and CUDA versions.
1. Build: compile the fused SMPL blend+skin kernel (K1) from
   human_dynamics_tpu_torch/ops/csrc with nvcc, or load it from the cache.
2. K1 against its plain PyTorch version on the card, at V=6890 and
   N = 1440, 21 and the predictor's own N, with matmul TF32 off: vertex
   planes, verts, joints, j_posed, and one gradient.
3. The predictor end to end: full-width HmmrModel(include_resnet=True)
   with seeded random weights, a 480-frame clip of 224x224 uint8 frames,
   use_fused_smpl=True against use_fused_smpl=False; shapes, finiteness,
   agreement, the kernel's launch count, and a smoke timing.

The last lines are a JSON line of per-kernel results, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_FRAMES = 480
SMPL_VERTS = 6890
SMPL_KPS = 25
TOL = {"verts": 2e-4, "joints": 2e-4, "j_posed": 1e-4}  # tests/test_ops_pallas.py
GRAD_ATOL, GRAD_RTOL = 5e-3, 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs(a, b):
    return float((a - b).abs().max())


def cuda_ms(fn, iters=20):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_k1(torch, np, dev, smpl, consts, main_n):
    from human_dynamics_tpu_torch.core import smpl_forward
    from human_dynamics_tpu_torch.ops import smpl_cuda

    rng = np.random.RandomState(0)

    def inputs(n):
        beta = rng.randn(n, 10).astype(np.float32) * 0.3
        theta = rng.randn(n, 72).astype(np.float32) * 0.3
        return (torch.from_numpy(beta).to(dev),
                torch.from_numpy(theta).to(dev))

    plane_err = 0.0
    for n in (1440, 21, main_n):
        beta, theta = inputs(n)
        fused = smpl_cuda.smpl_forward_fused(smpl, beta, theta, consts)
        plain = smpl_forward(smpl, beta, theta)
        errs = {k: max_abs(getattr(fused, k), getattr(plain, k)) for k in TOL}
        coeffs, rt_t, _, _ = smpl_cuda.blend_skin_operands(
            smpl, consts, beta, theta)
        ops = (coeffs, rt_t, consts.dirs, consts.v_template, consts.weights_t)
        planes = max(
            max_abs(k, p) for k, p in zip(
                smpl_cuda.blend_skin(*ops),
                smpl_cuda.blend_skin_reference(*ops))
        )
        torch.cuda.synchronize()
        print(f"K1 N={n} V={SMPL_VERTS}: max|kernel-plain| planes "
              f"{planes:.3e}, " + ", ".join(
                  f"{k} {v:.3e} (tol {TOL[k]:g})" for k, v in errs.items()))
        for k, v in errs.items():
            check(v <= TOL[k], f"K1 {k} error {v} > {TOL[k]} at N={n}")
        check(planes <= TOL["verts"], f"K1 planes error {planes} at N={n}")
        if n == main_n:
            plane_err = planes

    # One gradient through the autograd.Function against the plain path.
    beta, theta = inputs(21)
    grads = []
    for fn in (smpl_cuda.smpl_forward_fused, smpl_forward):
        b = beta.clone().requires_grad_(True)
        t = theta.clone().requires_grad_(True)
        loss = torch.sum(fn(smpl, b, t).joints ** 2)
        grads.append(torch.autograd.grad(loss, [b, t]))
    for name, g, w in zip(("beta", "theta"), *grads):
        err = max_abs(g, w)
        print(f"K1 grad d(sum joints^2)/d{name}: max abs diff {err:.3e}")
        check(torch.allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL),
              f"K1 gradient in {name} differs by {err}")

    # Kernel and plain version at the main path's shape, in turns.
    beta, theta = inputs(main_n)
    coeffs, rt_t, _, _ = smpl_cuda.blend_skin_operands(
        smpl, consts, beta, theta)
    ops = (coeffs, rt_t, consts.dirs, consts.v_template, consts.weights_t)
    kernel = lambda: smpl_cuda.blend_skin(*ops)
    plain = lambda: smpl_cuda.blend_skin_reference(*ops)
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    print(f"K1 N={main_n} V={SMPL_VERTS}: kernel {k1:.4f}/{k2:.4f} ms, "
          f"plain {p1:.4f}/{p2:.4f} ms (CUDA events, 20 launches each)")
    return plane_err, min(k1, k2), min(p1, p2)


def main():
    import numpy as np
    import torch

    # Phase 0: device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one GPU")
    sys.path.insert(0, HERE)
    import human_dynamics_tpu_torch as port

    check(os.path.dirname(os.path.abspath(port.__file__))
          == os.path.join(HERE, "human_dynamics_tpu_torch"),
          f"imported the port from {port.__file__}, not from this checkout")
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.infer import HmmrPredictor, WindowSchedule
    from human_dynamics_tpu_torch.models import HmmrModel
    from human_dynamics_tpu_torch.ops import smpl_cuda
    from human_dynamics_tpu_torch.ops._build import load_kernel_library

    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    print(f"TF32 in force: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    # Phase 1: build.
    info = load_kernel_library(smpl_cuda.KERNEL_NAME).info
    print(f"K1 build: {'built' if info.built else 'cache hit'} in "
          f"{info.seconds:.2f} s -> {os.path.relpath(info.path, HERE)}")

    # Phase 2: K1 against its plain version, TF32 off for the plain products.
    smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS,
                                device=dev)
    consts = smpl_cuda.prepare_fused_constants(smpl)
    b, t = 8, 20
    model = HmmrModel(include_resnet=True, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    sched = WindowSchedule(N_FRAMES, b, t, model.fov)
    heads = 1 + sum(1 for dt in model.delta_t_values if dt != 0)
    main_n = sched.count * b * sched.good_frames * heads
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        k1_err, k1_ms, k1_plain_ms = phase_k1(
            torch, np, dev, smpl, consts, main_n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32

    # Phase 3: the predictor end to end.
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (N_FRAMES, 224, 224, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    kw = dict(batch_size=b, seq_length=t, device=dev)
    fused = HmmrPredictor(model, None, smpl, use_fused_smpl=True, **kw)
    unfused = HmmrPredictor(model, None, smpl, use_fused_smpl=False, **kw)

    smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] = 0
    out = fused.predict_all_images(frames, as_numpy=False)
    torch.cuda.synchronize()
    launches = smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]
    print(f"predictor (fused): K1 launched {launches} time(s) for "
          f"{N_FRAMES} frames")
    check(launches > 0, "the main path did not launch K1")

    want_shapes = {
        "verts": (N_FRAMES, SMPL_VERTS, 3),
        "verts_delta": (N_FRAMES, 2, SMPL_VERTS, 3),
        "kps": (N_FRAMES, SMPL_KPS, 2),
        "omegas": (N_FRAMES, 85),
    }
    print("predictor shapes: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in sorted(out.items())))
    for k, shape in want_shapes.items():
        check(tuple(out[k].shape) == shape,
              f"{k} has shape {tuple(out[k].shape)}, want {shape}")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} has non-finite values")

    ref = unfused.predict_all_images(frames, as_numpy=False)
    torch.cuda.synchronize()
    check(smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] == launches,
          "the unfused predictor launched K1")
    check(set(ref) == set(out), "fused and unfused outputs have other keys")
    for k in ("omegas", "omegas_delta"):
        check(torch.equal(out[k], ref[k]), f"{k} differ between fused and "
              "unfused SMPL")
    for k in ("verts", "joints", "kps", "verts_delta", "joints_delta",
              "kps_delta"):
        err = max_abs(out[k], ref[k])
        print(f"predictor fused vs unfused: {k} max abs diff {err:.3e} "
              f"(tol 2e-4)")
        check(err <= 2e-4, f"{k} fused vs unfused differs by {err}")
    del out, ref

    # Smoke timing, in turns, after the runs above warmed everything up.
    times = {"fused": [], "unfused": []}
    for name in ("fused", "unfused", "unfused", "fused", "fused", "unfused"):
        pred = fused if name == "fused" else unfused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_all_images(frames, as_numpy=False)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = float(np.median(ts))
        print(f"smoke timing (not a benchmark) [{card}]: predictor "
              f"use_fused_smpl={name == 'fused'}: {med * 1e3:.2f} ms/clip of "
              f"{N_FRAMES} frames, {N_FRAMES / med:.1f} frames/s (median of "
              f"{len(ts)}; all ms {[round(x * 1e3, 2) for x in ts]})")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    print(json.dumps({"kernels": [{
        "name": smpl_cuda.KERNEL_NAME,
        "route": "cuda",
        "source": "human_dynamics_tpu_torch/ops/csrc/smpl_blend_skin.cu",
        "replaces": "human_dynamics_tpu/ops/smpl_pallas.py:108",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
