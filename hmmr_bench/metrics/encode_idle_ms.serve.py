"""The device's idle time per served clip charged to the predictor's
encoder: the gaps that end at work launched inside the program's
"hmmr.encode" range (``harness/spans.idle_by_span``)."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "predictor encode", "moves": "clip_fps"}


def read(reading):
    return spans.idle_ms(reading, spans.SERVE, "hmmr.encode")
