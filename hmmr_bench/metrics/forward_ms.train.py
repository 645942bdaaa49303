"""Device time per training step of the forward pass and the losses
(``train/trainer.compute_losses``): the device operations launched inside
the program's "hmmr.train.forward" range."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "trainer forward", "moves": "train_fps"}


def read(reading):
    return spans.device_ms(reading, "hmmr.train.forward")
