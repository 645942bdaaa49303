#!/usr/bin/env python3
"""Run one cell of the benchmark of human_dynamics_tpu_torch once.

    python3 hmmr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's inputs and weights on the GPU from the seed, warms up the
cell's shapes, measures for ``--seconds`` (``--trace 1``: a traced window
of the traffic's own length instead), checks what the timed path produced
against the plain reference, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each compared number beside its
limit (also the last lines of standard error).

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package imported, it prints no result and exits with 2.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

HOST_THREADS = 4
# Every build and kernel cache at a fixed path inside the checkout (the
# port's kernels build into human_dynamics_tpu_torch/ops/_build/).
CACHE_DIRS = (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
              ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_DIRS:
        os.environ[var] = os.path.join(ROOT, ".hmmr_bench_cache", sub)
    from hmmr_bench.harness import core

    start = core.process_start_boottime()
    try:
        chips = core.load_json("workloads", args.workload)["chips"]
        import torch

        core.require_cuda(chips)
        torch.set_num_threads(HOST_THREADS)
        run = core.Run(args.workload, args.seed, args.seconds, args.trace == 1, start)
        run.device = torch.device("cuda", 0)
        torch.cuda.set_device(run.device)
        e2e, layers = core.end_to_end_specs(), core.per_layer_modules()
        core.load_module("traffic", run.mix["kind"]).run(run)
        core.check_no_jax()
        core.emit(core.result_line(run, e2e, layers), run.marks)
        return 0
    except core.BenchError as exc:
        print(f"hmmr_bench: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
