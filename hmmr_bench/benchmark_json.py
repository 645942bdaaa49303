#!/usr/bin/env python3
"""BENCHMARK.json from this folder's files.

    python3 hmmr_bench/benchmark_json.py           # write it at the root
    python3 hmmr_bench/benchmark_json.py --check   # exit 1 if it differs

Configurations are ``configs/*.json`` (those a cell uses), cells
``workloads/*.json``, end-to-end metrics ``end_to_end/*.json`` and
per-layer metrics ``metrics/*.py``; each metric's "workloads" are the cells
whose files name it. One added file is one added cell, configuration or
metric.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from hmmr_bench.harness import core  # noqa: E402

OUT = os.path.join(core.ROOT, "BENCHMARK.json")
RUN_SECONDS = 20


def build() -> dict:
    cells = {n: core.load_json("workloads", n) for n in core.names("workloads", ".json")}
    used = sorted({c["config"] for c in cells.values()})
    configs = []
    for name in used:
        c = core.load_json("configs", name)
        configs.append({"name": name, "source": c["source"],
                        "file": f"hmmr_bench/configs/{name}.json",
                        "reduced": c["reduced"], "why": c["why"]})
    workloads = [{"name": n, "config": c["config"], "traffic": c["traffic"],
                  "chips": c["chips"], "why": c["why"]} for n, c in cells.items()]

    def reported(name, key):
        return [n for n, c in cells.items() if name in c[key]]

    end_to_end = []
    for name, spec in core.end_to_end_specs().items():
        entry = {"name": name, **spec}
        where = reported(name, "end_to_end")
        if not where:
            continue
        if len(where) < len(cells):
            entry["workloads"] = where
        end_to_end.append(entry)
    per_layer = []
    for name, mod in core.per_layer_modules().items():
        where = reported(name, "per_layer")
        if where:
            per_layer.append({"name": name, **mod.SPEC, "workloads": where})
    return {"command": ["python3", "hmmr_bench/run.py"], "paths": ["hmmr_bench"],
            "run_seconds": RUN_SECONDS, "configs": configs, "workloads": workloads,
            "end_to_end": end_to_end, "per_layer": per_layer}


def text() -> str:
    return json.dumps(build(), indent=2) + "\n"


def main() -> int:
    want = text()
    if sys.argv[1:] == ["--check"]:
        with open(OUT) as f:
            same = f.read() == want
        print("BENCHMARK.json matches the folder" if same
              else "BENCHMARK.json differs from the folder's files")
        return 0 if same else 1
    with open(OUT, "w") as f:
        f.write(want)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
