"""Device time per served clip of the predictor's encoder: the device
operations launched inside the program's "hmmr.encode" range
(``infer/predictor.HmmrPredictor.encode_frames``, every chunk and their
``cat``)."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "predictor encode", "moves": "clip_fps"}


def read(reading):
    return spans.device_ms(reading, "hmmr.encode")
