"""The whole served clip's share of the card's peak: the least time of the
clip's operations at each precision (``roofline.step.serve_clip``) over
the wall time per clip of the same number of clips run untraced just
before the traced window (the profiler slows the host)."""

from hmmr_bench.roofline import step

SPEC = {"unit": "%", "better": "higher", "source": "host_clock",
        "layer": "whole clip", "moves": "clip_fps"}


def read(reading):
    if not reading.device_events:
        return None
    least_ms = step.serve_clip(reading.params["frames"], reading.config,
                               reading.params["image_size"])[0]
    return least_ms / (reading.extra["untraced_unit_s"] * 1e3) * 100.0
