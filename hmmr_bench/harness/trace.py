"""The traced window: torch.profiler on the card, its trace read back.

``traced(torch, fn)`` runs ``fn`` inside the profiler and a
"hmmr_bench.window" range, writes one Chrome trace under ``TMPDIR``,
reads it and deletes it. ``Reading`` holds what the per-layer metrics
read: every kernel with its device interval and the host time of its
launch, the host ranges the benchmark opened (``record_function``), the
units of work in the window, the traffic's parameters and the
configuration.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

WINDOW = "hmmr_bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def traced(torch, fn):
    """(fn's return, host seconds, the parsed trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="hmmr_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return out, wall, events


class Reading:
    """The parsed trace of one traced window (times in seconds)."""

    def __init__(self, events: List[Dict], units: int, params: Dict, config: Dict,
                 wall_s: float, extra: Optional[Dict] = None):
        self.units, self.params, self.config = units, params, config
        self.extra = extra or {}
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if not win:
            raise RuntimeError("the trace holds no benchmark window range")
        self.t0 = win[0]["ts"] * 1e-6
        self.t1 = self.t0 + win[0]["dur"] * 1e-6
        self.window_s = wall_s
        launch = {}
        self.cpu_ops: List[Tuple[float, float, str]] = []
        self.ranges: Dict[str, List[Tuple[float, float]]] = {}
        dev = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts, dur = e.get("ts", 0) * 1e-6, e.get("dur", 0) * 1e-6
            if cat in _DEVICE_CATS:
                dev.append((ts, dur, e.get("name", "?"),
                            (e.get("args") or {}).get("correlation"), cat))
            elif cat in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = ts
            elif cat in ("cpu_op", "user_annotation"):
                self.cpu_ops.append((ts, ts + dur, e.get("name", "?")))
                if cat == "user_annotation":
                    self.ranges.setdefault(e.get("name"), []).append((ts, ts + dur))
        dev.sort()
        self.kernels = [(ts, dur, name, launch.get(corr))
                        for ts, dur, name, corr, cat in dev if cat == "kernel"]
        self.device_events = [(ts, dur, name, launch.get(corr))
                              for ts, dur, name, corr, _ in dev]
        self.cpu_ops.sort()

    # -- sums ------------------------------------------------------------

    def launches(self) -> int:
        return len(self.kernels)

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(d for _, d, n, _ in self.kernels if match(n))

    def seconds_in_range(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside host ranges
        ``name``; None when there is no such range."""
        spans = sorted(self.ranges.get(name, []))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for _, d, _, at in self.device_events:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += d
        return total

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        busy, end = 0.0, self.t0
        for ts, d, _, _ in self.device_events:
            s, e = max(ts, end), min(ts + d, self.t1)
            if e > s:
                busy += e - s
            end = max(end, ts + d)
        return busy

    # -- the breakdown -----------------------------------------------------

    def _host_ops_at(self, times) -> Dict[float, str]:
        """The innermost host operation running at each host time (one
        sweep over the operations, sorted by start)."""
        labels, stack, i, ops = {}, [], 0, self.cpu_ops
        for t in sorted(set(times)):
            while i < len(ops) and ops[i][0] <= t:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            labels[t] = next((n for s, e, n in reversed(stack)
                              if e >= t and n != WINDOW), "no host op")
        return labels

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time in the window by what the host was doing:
        each gap named by the innermost host operation around the launch of
        the work after it, summed by name, the longest first."""
        gaps, end = [], self.t0
        for ts, d, _, at in self.device_events:
            if ts > end and ts > self.t0:
                gaps.append((min(ts, self.t1) - max(end, self.t0), at))
            end = max(end, ts + d)
        if self.t1 > end:
            gaps.append((self.t1 - end, None))
        names = self._host_ops_at([at for _, at in gaps if at is not None])
        by_op: Dict[str, float] = {}
        for dur, at in gaps:
            label = ("after the last device op" if at is None
                     else names.get(at, "unknown host op"))
            by_op[label] = by_op.get(label, 0.0) + dur
        return [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]]

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for _, d, name, _ in self.device_events:
            by[name[:160]] = by.get(name[:160], 0.0) + d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self) -> Dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}
