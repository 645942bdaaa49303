"""Kernel launches per training step on rank 0's card: kernel events in
the traced window over its steps (host dispatch, ``train/trainer.Trainer.step``)."""

SPEC = {"unit": "launches", "better": "lower", "source": "device_trace",
        "layer": "host dispatch", "moves": "train_fps"}


def read(reading):
    return reading.launches() / reading.units if reading.launches() else None
