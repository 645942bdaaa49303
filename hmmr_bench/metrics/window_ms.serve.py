"""Device time per served clip of everything the predictor runs after the
encoder (``infer/predictor.HmmrPredictor.predict_all_images``): the
window gather, the bf16 window model, the SMPL decode, the stitch; the
device operations launched inside the program's "hmmr.window" range."""

from hmmr_bench.harness import spans

SPEC = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "predictor window model", "moves": "clip_fps"}


def read(reading):
    return spans.device_ms(reading, "hmmr.window")
