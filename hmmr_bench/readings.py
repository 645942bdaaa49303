#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process (set-up is long: one process reads many seeds).

    python3 hmmr_bench/readings.py --workload <cell> --seeds 11 12 ... \
        [--seconds 3] [--control | --fault <name>[@<step>]] [--out chiprun_out/r.jsonl]

For each seed it makes the cell's inputs, runs the cell's traffic for a
short window (``--seconds``) at the cell's own sizes and prints the
numbers ``correct`` compares, as one JSON line: the program's (the lower
readings), with ``--fault`` the program with that fault planted
(``harness.faults``), or with ``--control`` the control's (the reference
computed in the next precision down, put in the program's place).
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from hmmr_bench.harness import core, faults

    core.require_cuda(core.load_json("workloads", args.workload)["chips"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        run = core.Run(args.workload, seed, args.seconds, False)
        run.device = torch.device("cuda", 0)
        torch.cuda.set_device(run.device)
        traffic = core.load_module("traffic", run.mix["kind"])
        t0 = time.perf_counter()
        if args.control:
            values = traffic.control(run)
        else:
            with (faults.planted(args.fault) if args.fault else contextlib.nullcontext()):
                traffic.run(run)
            values = run.compared
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "what": "control" if args.control else (args.fault or "program"),
                           "values": values, "limits": run.limits(),
                           "seconds": time.perf_counter() - t0,
                           "card": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
