"""The harness's contract on the CPU: the result line, the refusal without a
card, discovery by file name, the check for JAX by whole top-level names,
and BENCHMARK.json against the folder."""

import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from hmmr_bench import benchmark_json
from hmmr_bench.harness import core
from hmmr_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_result_line_keys_and_compared_last():
    r = tiny.run("serve-clip480-f32", tiny.SERVE)
    r.setup_s, r.e2e = 12.5, {"clip_fps": 15000.0, "clip_ms_p95": 33.0}
    r.attempted, r.compared = 7, {"omega_gap": 0.001, "verts_gap": float("nan")}
    r.info = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    out = core.result_line(r, core.end_to_end_specs(), core.per_layer_modules())
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert out["correct"] is False          # a NaN is never within its limit
    assert set(out["metrics"]) == {"clip_fps", "clip_ms_p95", "setup_s"}
    assert out["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    line = io.StringIO()
    err = io.StringIO()
    with redirect_stdout(line), redirect_stderr(err):
        core.emit(out)
    parsed = json.loads(line.getvalue().strip().splitlines()[-1])
    assert parsed["compared"]["verts_gap"]["value"] == "nan"
    assert err.getvalue().strip().splitlines()[-1].startswith("compared verts_gap")


def test_judge_needs_every_limit():
    r = tiny.run("train-image-b8t20", tiny.TRAIN)
    r.compared = {k: 0.0 for k in r.limits() if k != "change_gap.last"}
    assert not core.judge(r)
    r.compared["change_gap.last"] = 0.0
    assert core.judge(r)
    r.compared["loss_gap.last"] = 2 * r.limits()["loss_gap.last"]
    assert not core.judge(r)


def test_no_card_fails_without_a_result():
    from hmmr_bench import run as bench_run

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench_run.main(["--workload", "serve-clip480-f32", "--seed", "5",
                             "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""
    assert "torch.cuda.is_available() is False" in err.getvalue()


def test_discovery_by_file_name():
    cells = core.names("workloads", ".json")
    assert cells == ["serve-clip480-f32", "train-image-b8t20"]
    assert core.names("configs", ".json") == ["hmmr-fp32-train", "hmmr-int8-serve"]
    kinds = {core.load_json("traffic", core.load_json("workloads", c)["traffic"])["kind"]
             for c in cells}
    assert kinds == {"clip_closed", "train_steps"}
    for kind in kinds:
        assert callable(core.load_module("traffic", kind).run)
        assert callable(core.load_module("traffic", kind).control)
    layers = core.per_layer_modules()
    e2e = core.end_to_end_specs()
    for c in cells:
        cell = core.load_json("workloads", c)
        assert set(cell["end_to_end"]) <= set(e2e) and "setup_s" in cell["end_to_end"]
        assert set(cell["per_layer"]) <= set(layers) and cell["per_layer"]
        for m in cell["per_layer"]:
            assert e2e and layers[m].SPEC["moves"] in cell["end_to_end"]
    with pytest.raises(core.BenchError):
        core.load_json("workloads", "no-such-cell")


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"human_dynamics_tpu_torch": 1, "human_dynamics_tpu_torch.core": 1,
            "jaxtyping": 1, "flaxen.x": 1, "torch": 1}
    assert core.forbidden_modules(mods) == []
    mods.update({"human_dynamics_tpu.core": 1, "jax.numpy": 1, "jaxlib": 1,
                 "optax": 1, "flax.linen": 1})
    assert core.forbidden_modules(mods) == [
        "flax.linen", "human_dynamics_tpu.core", "jax.numpy", "jaxlib", "optax"]


def test_the_run_imports_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from hmmr_bench.harness import core, faults, trace;"
            "from hmmr_bench.traffic import clip_closed, train_steps;"
            "import hmmr_bench.run, hmmr_bench.readings;"
            "import human_dynamics_tpu_torch.infer.predictor, human_dynamics_tpu_torch.train.trainer;"
            "core.load_module('metrics', 'mfu.serve');"
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_nothing_reads_the_jax_bench():
    literal = re.compile(r"""["'][^"'\n]*(bench\.py|BENCH_[^"'\n]*\.json)["']""")
    for dirpath, _, files in os.walk(core.BENCH):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not literal.search(fh.read()), f


def test_benchmark_json_matches_the_folder_and_the_contract():
    built = benchmark_json.build()
    with open(benchmark_json.OUT) as f:
        assert json.load(f) == built
    assert set(built) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in built["configs"]] + [w["name"] for w in built["workloads"]]
             + [m["name"] for m in built["end_to_end"] + built["per_layer"]])
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in built["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in built["workloads"]) <= 1
    for w in built["workloads"]:
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in built["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in built["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    run_s = built["run_seconds"]
    assert 2 + 14 * 24 * (run_s + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(built)) <= 64 * 1024
