"""Finding a cell's files by name, the run's checks and its result line.

Everything that belongs to one cell, configuration, traffic kind or metric
is a file of this folder, found by its name:

- ``workloads/<cell>.json``: config, traffic, chips, why, the end-to-end
  and per-layer metrics the cell reports, and the limits of the numbers
  ``correct`` compares;
- ``traffic/<mix>.json``: a traffic mix, the kind of traffic that drives
  it and its parameters;
- ``configs/<config>.json``: the model's sizes and precision path, source,
  assumed, reduced, why;
- ``traffic/<kind>.py``: ``run(ctx)`` drives the program (``Run``) with
  a mix's parameters, ``control(ctx)`` reads the control;
- ``end_to_end/<metric>.json`` and ``metrics/<metric>.py``: the metrics'
  entries of BENCHMARK.json but their cells, which the cells' files name;
  a per-layer metric's file also holds ``read(reading)``, which returns
  its value or None.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# Top-level module names that no run may hold: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "human_dynamics_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: no card, a forbidden module, a
    missing file."""


def _path(folder: str, name: str, ext: str) -> str:
    path = os.path.join(BENCH, folder, name + ext)
    if not os.path.isfile(path):
        raise BenchError(f"no {folder}/{name}{ext} in {BENCH}")
    return path


def names(folder: str, ext: str) -> List[str]:
    """The names of the files of ``folder`` with extension ``ext``."""
    d = os.path.join(BENCH, folder)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def load_json(folder: str, name: str) -> Dict:
    with open(_path(folder, name, ".json")) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` as a module (names may hold dots)."""
    path = _path(folder, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"hmmr_bench.{folder}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end_specs() -> Dict[str, Dict]:
    return {n: load_json("end_to_end", n) for n in names("end_to_end", ".json")}


def per_layer_modules() -> Dict:
    return {n: load_module("metrics", n) for n in names("metrics", ".py")}


def forbidden_modules(modules=None) -> List[str]:
    """Modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: the port's name begins with the JAX
    package's and is not one of them."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".", 1)[0] in FORBIDDEN)


def check_no_jax() -> None:
    found = forbidden_modules()
    if found:
        raise BenchError("the run imported " + ", ".join(found[:20]))


def require_cuda(chips: int):
    """The card count, or BenchError: a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is False: this benchmark "
                         "runs only on NVIDIA GPUs")
    count = torch.cuda.device_count()
    if count < chips:
        raise BenchError(f"the cell needs {chips} GPUs; {count} are visible")
    return count


def process_start_boottime(pid: Optional[int] = None) -> float:
    """When the process started, in seconds of CLOCK_BOOTTIME."""
    with open(f"/proc/{pid or os.getpid()}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def host_usage():
    """(process CPU seconds, main thread CPU seconds, involuntary context
    switches, the machine's CPU seconds stolen by its hypervisor) so far."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    with open("/proc/stat") as f:
        cpu = f.readline().split()
    steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK") if len(cpu) > 8 else 0.0
    return ru.ru_utime + ru.ru_stime, time.thread_time(), ru.ru_nivcsw, steal


def device_info(torch, device, count: int) -> Dict:
    """The result's "device": the card's name, the cards used and the peak
    allocation of this process's card. A run on the CPU (the tests' only)
    says so and reads no memory."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One run of a cell: its files, its arguments, its clock.

    A traffic module's ``run(ctx)`` makes its inputs, drives the program,
    calls ``setup_done()`` just before its first timed operation, and
    fills ``e2e`` (end-to-end values), ``reading`` (a ``trace.Reading`` of
    the traced window), ``compared`` (name -> value, compared against the
    cell's ``limits``), ``attempted``, ``failed`` and ``info`` (the
    result's "device")."""

    def __init__(self, cell_name: str, seed: int, seconds: float, trace: bool,
                 start: Optional[float] = None, overrides: Optional[Dict] = None):
        self.cell_name = cell_name
        self.cell = load_json("workloads", cell_name)
        self.config = load_json("configs", self.cell["config"])
        self.mix = load_json("traffic", self.cell["traffic"])
        self.params = dict(self.mix["params"])
        if overrides:   # tests: smaller sizes on the CPU
            self.params.update(overrides.get("params", {}))
            self.config = {**self.config, **overrides.get("config", {})}
        self.device = None     # the torch.device the run drives
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.start = process_start_boottime() if start is None else start
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.reading = None
        self.compared: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.info: Dict = {}   # the result's "device"
        self.marks: List = []  # (what, seconds since the process started)
        self.control = False   # read the control in the program's place

    def mark(self, what: str) -> None:
        """Note how far set-up has come; printed to standard error."""
        self.marks.append((what, boottime() - self.start))

    def mark_host(self, before, wall_s: float) -> None:
        """Note what the host did in a window of ``wall_s`` seconds that
        began at ``host_usage()`` = ``before``."""
        now = host_usage()
        self.mark(f"window of {wall_s:.3f} s: main thread CPU {now[1] - before[1]:.3f} s, "
                  f"process CPU {now[0] - before[0]:.3f} s, "
                  f"{now[2] - before[2]} involuntary context switches, "
                  f"{now[3] - before[3]:.2f} CPU s stolen from the machine")

    def setup_done(self) -> None:
        self.setup_s = boottime() - self.start
        self.marks.append(("set-up done", self.setup_s))

    def limits(self) -> Dict[str, float]:
        return self.cell["limits"]


def judge(run: Run) -> bool:
    """``correct``: every compared number is finite and within its limit,
    and every limit was compared."""
    limits = run.limits()
    if set(run.compared) != set(limits):
        return False
    return all(math.isfinite(v) and v <= limits[k] for k, v in run.compared.items())


def result_line(run: Run, e2e_specs: Dict, layer_modules: Dict) -> Dict:
    """The result's JSON object; "compared" comes last."""
    metrics = {}
    if run.trace:
        for name in run.cell["per_layer"]:
            mod = layer_modules[name]
            value = mod.read(run.reading)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.SPEC["unit"]}
    else:
        for name in run.cell["end_to_end"]:
            value = run.setup_s if name == "setup_s" else run.e2e[name]
            metrics[name] = {"value": value, "unit": e2e_specs[name]["unit"]}
    out = {"correct": judge(run), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": run.info}
    if run.trace and run.reading is not None:
        out["device"] = {**run.info, "busy_s": run.reading.busy_s,
                         "window_s": run.reading.window_s}
        out["breakdown"] = run.reading.breakdown()
    limits = run.limits()
    out["compared"] = {k: {"value": _number(run.compared.get(k)), "limit": lim}
                       for k, lim in limits.items()}
    return out


def _number(v):
    """A compared value as JSON can hold it: NaN and infinities as text."""
    return v if v is None or math.isfinite(v) else repr(v)


def emit(result: Dict, marks=()) -> None:
    """Set-up's marks, then the compared numbers beside their limits as the
    last lines of standard error, then the result as the last line of
    standard output."""
    sys.stdout.flush()
    for what, t in marks:
        print(f"hmmr_bench: {t:.3f} s {what}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
