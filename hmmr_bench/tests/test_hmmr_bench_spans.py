"""The program's phase spans as the benchmark reads them
(``harness/spans.py`` and the metrics that read it).

On the CPU: on a synthetic trace, each idle gap goes to the span around the
launch of the operation that ends it, and the spans' idle plus "outside" is
the window less ``busy_s``; a trace without the spans (an older program)
reads None; the tiny run of each cell gives every phase metric a number.
On the card, at the cells' own sizes, the traced run of each cell holds the
phases to the whole (device time, idle) and prints what it read:

    python -m pytest hmmr_bench/tests/test_hmmr_bench_spans.py -m cuda -s
"""

import json

import pytest

from hmmr_bench.harness import core, spans
from hmmr_bench.harness.trace import WINDOW, Reading
from hmmr_bench.tests import tiny

SERVE_METRICS = ("encode_ms.serve", "encode_idle_ms.serve", "window_ms.serve",
                 "window_idle_ms.serve", "smpl_ms.serve")
TRAIN_METRICS = ("forward_ms.train", "forward_idle_ms.train", "backward_ms.train",
                 "backward_idle_ms.train", "optimizer_ms.train",
                 "optimizer_idle_ms.train")
CELLS = {"serve-clip480-f32": SERVE_METRICS, "train-image-b8t20": TRAIN_METRICS}


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _op(corr, launched, ts, dur, cat="kernel"):
    """A device operation and, where ``launched`` is given, its launch."""
    out = [{"ph": "X", "cat": cat, "name": f"op{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr} if launched is not None else {}}]
    if launched is not None:
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                    "ts": launched, "dur": 1, "args": {"correlation": corr}})
    return out


def _synthetic(with_spans=True):
    """A 100 us window over two units: a copy with no launch record at
    5-8, work launched in "hmmr.encode" (10-30) at 15-25, work launched
    between the spans at 36-40, in "hmmr.smpl" (50-60, inside
    "hmmr.window", 40-80) at 60-70 and in "hmmr.window" at 75-90."""
    events = [_range(WINDOW, 0, 100)]
    if with_spans:
        events += [_range("hmmr.encode", 10, 20), _range("hmmr.window", 40, 40),
                   _range("hmmr.smpl", 50, 10)]
    events += (_op(0, None, 5, 3, "gpu_memcpy") + _op(1, 12, 15, 5) + _op(2, 14, 18, 7)
               + _op(3, 35, 36, 4) + _op(4, 55, 60, 10) + _op(5, 75, 75, 15))
    return Reading(events, 2, {}, {}, 100e-6)


def test_each_gap_goes_to_the_span_that_launched_what_ends_it():
    r = _synthetic()
    idle = spans.idle_by_span(r, spans.SERVE)
    # Outside: 0-5 (no launch), 8-10 (before encode began), 25-36 (launched
    # between the spans) and 90-100 (after the last operation). Encode takes
    # 10-15 of the gap 8-15; window 40-60 and 70-75.
    want = {"hmmr.encode": 5e-6, "hmmr.window": 25e-6, "outside": 28e-6}
    assert idle == pytest.approx(want, abs=1e-15)
    assert sum(idle.values()) == pytest.approx((r.t1 - r.t0) - r.busy_s, abs=1e-15)
    # Nested: smpl (from 50) takes 50-60 of the gap 40-60, window the rest.
    nested = spans.idle_by_span(r, spans.SERVE + ("hmmr.smpl",))
    assert nested == pytest.approx({**want, "hmmr.window": 15e-6, "hmmr.smpl": 10e-6},
                                   abs=1e-15)


def test_phase_metrics_on_a_synthetic_trace_and_none_without_spans():
    layers = core.per_layer_modules()
    r = _synthetic()
    got = {m: layers[m].read(r) for m in SERVE_METRICS}
    assert got == pytest.approx({"encode_ms.serve": 0.006, "encode_idle_ms.serve": 0.0025,
                                 "window_ms.serve": 0.0125,
                                 "window_idle_ms.serve": 0.0125,
                                 "smpl_ms.serve": 0.005}, abs=1e-12)
    bare = _synthetic(with_spans=False)
    assert all(layers[m].read(bare) is None for m in SERVE_METRICS + TRAIN_METRICS)


def _traced_run(cell, overrides, device, monkeypatch=None):
    import torch

    run = core.Run(cell, tiny.SEED, 1.0, True, overrides=overrides)
    run.device = device
    if monkeypatch is not None:     # the traced window synchronises the card
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    core.load_module("traffic", run.mix["kind"]).run(run)
    return run


@pytest.mark.parametrize("cell,overrides", [
    ("serve-clip480-f32", tiny.SERVE),
    # Image mode, as the cell runs: the full trunk at 32^2.
    ("train-image-b8t20", {"params": {**tiny.TRAIN["params"], "image_size": 32,
                                      "warmup_steps": 1},
                           "config": {"num_verts": 300, "seq_length": 8}}),
])
def test_every_phase_metric_reads_a_number_on_the_tiny_run(cell, overrides,
                                                           monkeypatch):
    import torch

    run = _traced_run(cell, overrides, torch.device("cpu"), monkeypatch)
    layers = core.per_layer_modules()
    got = {m: layers[m].read(run.reading) for m in CELLS[cell]}
    assert all(isinstance(v, float) for v in got.values()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_phases_hold_the_whole_on_the_card(cell, cuda_device):
    run = _traced_run(cell, None, cuda_device)
    r, layers = run.reading, core.per_layer_modules()
    got = {m: layers[m].read(r) for m in CELLS[cell] + tuple(run.cell["per_layer"])}
    names = spans.SERVE if cell.startswith("serve") else spans.TRAIN
    idle = spans.idle_by_span(r, names)
    device_ms = sum(d for _, d, _, _ in r.device_events) * 1e3 / r.units
    phases_ms = sum(spans.device_ms(r, n) for n in names)
    print(json.dumps({"cell": cell, "metrics": got, "device_ms": device_ms,
                      "outside_idle_ms": idle[spans.OUTSIDE] * 1e3 / r.units,
                      "trace_window_s": r.t1 - r.t0, "window_s": r.window_s,
                      "busy_s": r.busy_s, "wall_ms": r.window_s * 1e3 / r.units,
                      "untraced_ms": r.extra["untraced_unit_s"] * 1e3}))
    assert core.judge(run), run.compared
    assert all(isinstance(got[m], float) for m in CELLS[cell]), got
    assert phases_ms >= 0.95 * device_ms
    assert abs(sum(idle.values()) - (r.window_s - r.busy_s)) <= 0.01 * r.window_s
