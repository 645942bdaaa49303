#!/usr/bin/env python3
"""chip_smoke.py's phase 4 alone: the int8 trunk, its int8 conv, its
pre-activation and K2, each kernel against its plain version and timed.

    python3 scripts/bench_k2.py [--ptxas] [--phases [--source SRC.cu ...]]

Needs one CUDA card and nvcc. It builds the int8 kernels (one nvcc process
per source, started together), makes the full-width model and the 120-frame
chunk as chip_smoke.py's main does (seeded weights and frames), and runs
``chip_smoke.phase_int8_kernels``: K2's launch counts, every K2 chain
against fused_block_reference and timed in turns with its plain version and
with the same units as int8 conv launches, per geometry beside its chain
bound and its per-unit byte floor. ``--ptxas`` first prints nvcc's register,
shared-memory and spill report of csrc/k2_unit.cu. ``--phases`` then builds
csrc/k2_unit.cu with -DK2_PHASE_CLOCKS (each block stamps %globaltimer at
its phase boundaries) and runs one unit of each of the trunk's six K2 unit
geometries at 120 frames, seeded random operands: the unit's time by CUDA
events and, from the stamps, each phase's median time per block, the
blocks a SM ran and the kernel's span. ``--source`` adds other versions of
the kernel's source (built the same way, with csrc/ on the include path,
e.g. the parent's from ``git archive`` into the gitignored .parent/),
measured in turns with the tree's: tree, others, others, tree.
"""

import ctypes
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def ptxas_report():
    from human_dynamics_tpu_torch.ops._build import CSRC_DIR, find_nvcc

    out = subprocess.run(
        [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull,
         os.path.join(CSRC_DIR, "k2_unit.cu")],
        capture_output=True, text=True, timeout=600)
    print(out.stdout + out.stderr)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed ({out.returncode})")


# The trunk's K2 units: (map, Cin, Cb, Cout, projection shortcut).
UNITS = [(28, 256, 128, 512, True), (28, 512, 128, 512, False),
         (14, 512, 256, 1024, True), (14, 1024, 256, 1024, False),
         (7, 1024, 512, 2048, True), (7, 2048, 512, 2048, False)]


def random_unit(torch, dev, gen, cin, cb, cout, sc):
    """One unit's K2 operands (prepare_pallas_unit's layout), random."""
    def f(n, scale, low=0.0):
        v = torch.randn(n, generator=gen, device=dev) * scale
        return v.abs() + low if low else v

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    u = {"pA": f(cin, 1.0, 0.5), "pB": f(cin, 0.3), "w1": i8(cb, cin),
         "q1m": f(cb, 1e-5, 1e-6), "q1a": f(cb, 0.3), "w2": i8(cb, 9 * cb),
         "q2m": f(cb, 1e-5, 1e-6), "q2a": f(cb, 0.3), "w3": i8(cout, cb),
         "d3m": f(cout, 1e-4, 1e-5), "d3a": f(cout, 0.1)}
    if sc:
        u.update(wsc=i8(cout, cin), dscm=f(cout, 1e-3, 1e-4),
                 dsca=f(cout, 0.1))
    return u


def clocked_library(K, src, tag):
    """``src`` built with -DK2_PHASE_CLOCKS into ops/_build/, loaded, with
    the K2 launch's C signature."""
    from human_dynamics_tpu_torch.ops._build import (
        BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc)

    path = os.path.join(BUILD_DIR, f"libk2_unit_clocks_{tag}.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-DK2_PHASE_CLOCKS",
                    "-I", CSRC_DIR, "-o", path, src], check=True, timeout=600)
    lib = ctypes.CDLL(path)
    plain = K._k2_library()
    for name in ("k2_unit_launch", "k2_unit_error_string"):
        getattr(lib, name).argtypes = getattr(plain, name).argtypes
        getattr(lib, name).restype = getattr(plain, name).restype
    lib.k2_unit_set_clocks.argtypes = [ctypes.c_void_p]
    return lib


def unit_phases(torch, S, K, lib, h, cin, cb, cout, sc, x, unit):
    """One unit on ``lib``: ms by CUDA events, then one stamped run."""
    run = lambda: K.fused_block(x, [unit], h=h, w=h, unit_specs=(sc,))
    plan = K.k2_plan(S.CHUNK, h, h, cin, cb, cout, sc)
    clocks = torch.zeros(plan.grid, 8, dtype=torch.int64, device=x.device)
    plain = K._k2_library
    K._k2_library = lambda: lib
    try:
        ms = S.cuda_ms(run, 20)
        check = lib.k2_unit_set_clocks(clocks.data_ptr())
        S.check(check == 0, f"k2_unit_set_clocks failed ({check})")
        run()
        torch.cuda.synchronize()
        lib.k2_unit_set_clocks(None)
    finally:
        K._k2_library = plain
    c = clocks.cpu().double()
    per = (c[:, 1:5] - c[:, 0:4]) / 1e3
    waited = float((c[:, 6] / c[:, 7]).median()) * 100
    sms = torch.bincount(clocks[:, 5].cpu().long())
    span = float(c[:, 4].max() - c[:, 0].min()) / 1e3
    med = per.median(dim=0).values.tolist()
    return (f"{ms:.4f} ms; phases {', '.join(f'{v:.2f}' for v in med)} us "
            f"(block total {float(per.sum(1).median()):.2f}, {waited:.1f}% "
            f"of warp 0's cycles waiting for weight slices); {plan.grid} "
            f"blocks, {int(sms.max())} at most on one SM of "
            f"{int((sms > 0).sum())}; span {span:.2f} us")


def phases(torch, S, K, others):
    """Per-phase times of one unit of each geometry, from the stamps, for
    the tree's source and each of ``others``, in turns."""
    from human_dynamics_tpu_torch.ops._build import CSRC_DIR

    tree = os.path.join(CSRC_DIR, K.K2_KERNEL_NAME + ".cu")
    libs = [("tree", clocked_library(K, tree, "tree"))]
    libs += [(src, clocked_library(K, os.path.abspath(src), f"other{i}"))
             for i, src in enumerate(others)]
    order = libs + libs[1:] + libs[:1] if others else libs
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    print("  unit (map, Cin -> Cout, Cb, shortcut) [source]: ms (CUDA "
          "events); per block, median us of phase 0 (x -> pq), A (1x1), B "
          "(3x3), C (1x1 + out), and the share of warp 0's cycles in the "
          "weight ring's wait and barrier; blocks per SM; span us")
    for h, cin, cb, cout, sc in UNITS:
        unit = random_unit(torch, dev, gen, cin, cb, cout, sc)
        x = (torch.randn(S.CHUNK, h, h, cin, generator=gen, device=dev)
             * 0.5).to(torch.bfloat16)
        for name, lib in order:
            line = unit_phases(torch, S, K, lib, h, cin, cb, cout, sc, x,
                               unit)
            print(f"  {h}x{h} {cin} -> {cout}, Cb {cb}, "
                  f"{'projection' if sc else 'identity'} [{name}]: {line}")


def main():
    import torch

    import chip_smoke as S

    if not torch.cuda.is_available():
        raise SystemExit("bench_k2: no CUDA device; this script needs one GPU")
    if "--ptxas" in sys.argv[1:]:
        ptxas_report()
    from human_dynamics_tpu_torch.models import HmmrModel
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
    from human_dynamics_tpu_torch.ops._build import load_kernel_libraries

    print(f"card: {S.card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    S.build_all(load_kernel_libraries, [K.KERNEL_NAME, K.K2_KERNEL_NAME])
    dev = torch.device("cuda", 0)
    model = HmmrModel(include_resnet=True, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (S.N_FRAMES, S.IMG, S.IMG, 3),
                           dtype=torch.uint8, device=dev, generator=gen)
    t0 = time.perf_counter()
    result = S.phase_int8_kernels(torch, model, frames)
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s")
    print({k: v for k, v in result["k2"].items()})
    if "--phases" in sys.argv[1:]:
        args = sys.argv[1:]
        others = [a for i, a in enumerate(args)
                  if i and args[i - 1] == "--source"]
        phases(torch, S, K, others)
    print(S.card_line())


if __name__ == "__main__":
    main()
