"""Device time per served clip of the SMPL decode (``models/omega.compute_smpl``,
K1 and the projection): the device operations launched inside the
program's "hmmr.smpl" ranges, which lie inside "hmmr.window"."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "SMPL decode", "moves": "clip_fps"}


def read(reading):
    return spans.device_ms(reading, "hmmr.smpl")
