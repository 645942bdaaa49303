#!/usr/bin/env python3
"""K1, the fused SMPL blend+skin kernel, on one NVIDIA GPU: what the
compiler made of it, whether it is right, and its time against another
version of its source, in turns.

    python3 scripts/bench_k1.py [--other PATH/smpl_blend_skin.cu ...]
                                [--rounds 2] [--sass-out FILE]

1. ptxas's report (registers, shared memory, spills) for every kernel of
   human_dynamics_tpu_torch/ops/csrc/smpl_blend_skin.cu, and the tensor-core
   (HMMA) instructions in the SASS of the built library (cuobjdump).
2. The vertex planes of the kernel against the plain fp32 version (matmul
   TF32 off) on synthetic_smpl_model(6890) with seeded inputs, at N = 1536
   (the predictor's N for a 480-frame clip) and N = 37; the other
   versions' too (printed, not checked).
3. CUDA-event times at N = 1536: for each other version, other, this, this, other, for --rounds
   rounds, 20 launches each, beside the plain version's.

An other version is any source with the same C interface
(smpl_blend_skin_launch), e.g. the parent commit's, unpacked with
git archive into a directory .gitignore lists. It is built with the same
nvcc flags into ops/_build/.
"""

import argparse
import collections
import ctypes
import hashlib
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_PLANES = 1e-5
N_MAIN = 1536  # frames x heads of a 480-frame clip (chip_smoke.py's main_n)


def cuda_ms(torch, fn, iters=20):
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


def ptxas_report(build, src):
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    obj = os.path.join(build.BUILD_DIR, "k1_ptxas.o")
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    out = subprocess.run(
        [build.find_nvcc(), *flags, "-Xptxas", "-v", "-c", src, "-o", obj],
        capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"bench_k1: nvcc failed:\n{out.stdout}{out.stderr}")
    os.unlink(obj)
    for line in (out.stdout + out.stderr).splitlines():
        if re.search(r"Compiling entry|registers|spill|smem", line):
            print("ptxas: " + line.split("info    : ")[-1].strip())


def sass_report(build, lib_path, sass_out=None):
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    if sass_out:
        os.makedirs(os.path.dirname(os.path.abspath(sass_out)), exist_ok=True)
        with open(sass_out, "w") as f:
            f.write(sass)
    func, counts = None, collections.defaultdict(collections.Counter)
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
        m = re.search(r"\b(HMMA\.\S+|FFMA|LDL|STL)\b", line)
        if m and func:
            counts[func][m.group(1)] += 1
    for func, c in counts.items():
        print(f"sass {func}: " + ", ".join(f"{k} x{v}" for k, v in
                                           sorted(c.items())))


def load_other(build, src):
    """Builds another source of the kernel; returns its launch function."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, f"libsmpl_blend_skin_other_{key}.so")
    if not os.path.exists(path):
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", path, src],
                       check=True)
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.smpl_blend_skin_launch.argtypes = [ptr] * 8 + [i32, i32, ptr]
    lib.smpl_blend_skin_launch.restype = i32
    return lib


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        help="another smpl_blend_skin.cu to time (repeatable)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--sass-out", help="write the kernel's SASS here")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k1: no CUDA device")
    sys.path.insert(0, HERE)
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.ops import _build as build
    from human_dynamics_tpu_torch.ops import smpl_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    src = os.path.join(build.CSRC_DIR, smpl_cuda.KERNEL_NAME + ".cu")
    ptxas_report(build, src)
    info = build.load_kernel_library(smpl_cuda.KERNEL_NAME).info
    sass_report(build, info.path, args.sass_out)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(num_verts=6890, num_kps=25, device=dev)
    consts = smpl_cuda.prepare_fused_constants(smpl)
    rng = np.random.RandomState(0)

    def operands(n):
        beta = rng.randn(n, 10).astype(np.float32) * 0.3
        theta = rng.randn(n, 72).astype(np.float32) * 0.3
        coeffs, rt_t, _, _ = smpl_cuda.blend_skin_operands(
            smpl, consts, torch.from_numpy(beta).to(dev),
            torch.from_numpy(theta).to(dev))
        return (coeffs, rt_t, consts.dirs, consts.v_template,
                consts.weights_t)

    def runner(lib):
        def run(ops):
            n, v = ops[0].shape[0], ops[2].shape[2]
            out = torch.empty((3, n, v), device=dev)
            code = lib.smpl_blend_skin_launch(
                *(t.data_ptr() for t in ops), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), n, v,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"an other kernel failed to launch: {code}")
            return out
        return run

    versions = {"this": lambda ops: smpl_cuda.blend_skin(*ops)}
    for path in args.other:
        versions[os.path.relpath(path, HERE)] = runner(load_other(build, path))
    for n in (N_MAIN, 37):
        ops = operands(n)
        want = smpl_cuda.blend_skin_reference(*ops)
        for name, fn in versions.items():
            got = fn(ops)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"K1 {name} N={n} V=6890: max|kernel-plain| planes "
                  f"{err:.3e}")
            if name == "this" and err > TOL_PLANES:
                raise SystemExit(f"bench_k1: planes error {err} > "
                                 f"{TOL_PLANES}")

    ops = operands(N_MAIN)
    others = [name for name in versions if name != "this"]
    for r in range(args.rounds):
        for order in ([[o, "this", "this", o] for o in others] or [["this"]]):
            times = [(name, cuda_ms(torch, lambda: versions[name](ops)))
                     for name in order]
            plain = cuda_ms(torch,
                            lambda: smpl_cuda.blend_skin_reference(*ops))
            print(f"K1 N={N_MAIN} V=6890 round {r}: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in times)
                  + f", plain {plain:.4f} ms (CUDA events, 20 launches "
                  f"each) [{card}]")


if __name__ == "__main__":
    main()
