"""Kernel launches per served clip: kernel events in the traced window
over its clips (host dispatch, ``infer/predictor.HmmrPredictor``)."""

SPEC = {"unit": "launches", "better": "lower", "source": "device_trace",
        "layer": "host dispatch", "moves": "clip_fps"}


def read(reading):
    return reading.launches() / reading.units if reading.launches() else None
