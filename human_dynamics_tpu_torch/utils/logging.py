"""Training observability: scalar logging, loss proportions, profiling.

Counterpart of ``human_dynamics_tpu/utils/logging.py``: scalars to
TensorBoard (when tensorboardX imports) and always to a CSV mirror, the
weighted-loss proportion report, a rolling step timer, and a
``torch.profiler`` trace scope in place of ``jax.profiler``. ``span``
names the program's phases in that trace (the predictor's encode, window
model and SMPL decode; the trainer's forward, backward and optimiser).
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class MetricLogger:
    """Scalars -> TensorBoard (tensorboardX) + CSV mirror."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv_file = None
        self._csv_writer = None
        self._csv_keys = None

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        if self._tb is not None:
            for key, value in scalars.items():
                group = "d_loss" if key.startswith("d") else "e_loss"
                self._tb.add_scalar(f"{group}/{key}", value, step)
        row = {"step": step, **scalars}
        if self._csv_writer is None or self._csv_keys != sorted(row):
            if self._csv_file is not None:
                self._csv_file.close()
            self._csv_keys = sorted(row)
            new = not os.path.exists(self._csv_path)
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(
                self._csv_file, fieldnames=self._csv_keys,
                extrasaction="ignore",
            )
            if new:
                self._csv_writer.writeheader()
        self._csv_writer.writerow(row)
        self._csv_file.flush()

    def log_histogram(self, step: int, tag: str, values) -> None:
        """Histogram to TensorBoard; mean/std/min/max mirrored into
        histograms.csv."""
        v = np.asarray(values).reshape(-1)
        if self._tb is not None:
            self._tb.add_histogram(tag, v, step)
        path = os.path.join(self.log_dir, "histograms.csv")
        new = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["step", "tag", "mean", "std", "min", "max"])
            w.writerow([
                step, tag, float(v.mean()), float(v.std()),
                float(v.min()), float(v.max()),
            ])

    def log_image(self, step: int, tag: str, image) -> None:
        """image: (H, W, 3) uint8 or [0, 1] float. Without TensorBoard the
        image is written as a png, which needs cv2."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")
        else:
            import cv2

            d = os.path.join(self.log_dir, "images")
            os.makedirs(d, exist_ok=True)
            cv2.imwrite(
                os.path.join(d, f"{tag.replace('/', '_')}_{step}.png"),
                cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
            )

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._csv_file is not None:
            self._csv_file.close()


def write_loss_proportions(
    model_dir: str,
    step: int,
    losses: Dict[str, float],
    weights: Dict[str, float],
) -> str:
    """Append the weighted-loss-percentage table to loss_proportions.txt."""
    e_items = {
        k: v * weights.get(k, 1.0)
        for k, v in losses.items()
        if k.startswith("e") and k != "e_loss"
    }
    total = sum(e_items.values()) or 1.0
    path = os.path.join(model_dir, "loss_proportions.txt")
    with open(path, "a") as f:
        f.write(f"step {step}\n")
        for k in sorted(e_items, key=e_items.get, reverse=True):
            f.write(
                f"  {k:>24}: {100.0 * e_items[k] / total:6.2f}% "
                f"(raw {losses[k]:.6f} w {weights.get(k, 1.0):g})\n"
            )
    return path


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the scope, host and (where there is
    one) CUDA device activity, written to ``log_dir``/trace.json; a no-op
    when log_dir is None. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a ``torch.profiler`` runs,
    else a shared no-op context.

    The range is ``record_function``'s, so it lands in the profiler's
    trace beside the kernels and their launch records, on the same clock;
    it keeps no clock of its own. With no profiler running,
    ``record_function`` would still cost ~15 us a call on the CPU; the
    check costs ~0.1 us.
    """
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepTimer:
    """Rolling per-step wall-clock over the last ``window`` steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1000.0 * sum(self.times) / len(self.times)
