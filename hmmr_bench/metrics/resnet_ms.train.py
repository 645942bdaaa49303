"""Device time per training step of the frozen ResNet
(``models/resnet.ResNetV2_50``): the kernels launched inside the
benchmark's "hmmr_bench.resnet" ranges, which a forward pre-hook and a
forward hook open and close around the module."""

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "frozen ResNet", "moves": "train_fps"}


def read(reading):
    s = reading.seconds_in_range("hmmr_bench.resnet")
    if not s:
        return None
    return s * 1e3 / reading.units
