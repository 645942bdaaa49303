"""K1's share of its roofline in a training step (``ops/smpl_cuda``): the
least time of its call at N = 4 heads x this card's B*T rows over the
device time of ``blend_skin_kernel`` per step."""

from hmmr_bench.roofline import k1

SPEC = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "SMPL kernel K1", "moves": "train_fps"}


def read(reading):
    s = reading.kernel_seconds(lambda n: "blend_skin_kernel" in n)
    if not s:
        return None
    least_ms = k1.bound_ms(4 * reading.extra["rows"], reading.config["num_verts"])[0]
    return least_ms / (s * 1e3 / reading.units) * 100.0
