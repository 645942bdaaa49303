"""Device time per training step of the backward pass and the zeroed
gradients (``train/trainer.train_step``): the device operations launched
inside the program's "hmmr.train.backward" range, autograd's device
thread's launches included (``.backward()`` blocks inside it)."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "trainer backward", "moves": "train_fps"}


def read(reading):
    return spans.device_ms(reading, "hmmr.train.backward")
