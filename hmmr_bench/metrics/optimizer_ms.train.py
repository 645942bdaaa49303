"""Device time per training step of the two Adams' steps: the device
operations launched inside the program's "hmmr.train.optimizer" range."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "trainer optimiser", "moves": "train_fps"}


def read(reading):
    return spans.device_ms(reading, "hmmr.train.optimizer")
