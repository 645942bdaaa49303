"""The device's idle time per training step charged to the two Adams:
the gaps that end at work launched inside the program's
"hmmr.train.optimizer" range (``harness/spans.idle_by_span``)."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "trainer optimiser", "moves": "train_fps"}


def read(reading):
    return spans.idle_ms(reading, spans.TRAIN, "hmmr.train.optimizer")
