"""The whole training step's share of the card's peak: the least time of
this card's step operations at each precision (``roofline.step.train_step``)
over the wall time per step of the same number of steps run untraced just
before the traced window (the profiler slows the host)."""

from hmmr_bench.roofline import step

SPEC = {"unit": "%", "better": "higher", "source": "host_clock",
        "layer": "whole step", "moves": "train_fps"}


def read(reading):
    if not reading.device_events:
        return None
    least_ms = step.train_step(reading.extra["rows"], reading.config,
                               reading.extra["image_size"])[0]
    return least_ms / (reading.extra["untraced_unit_s"] * 1e3) * 100.0
