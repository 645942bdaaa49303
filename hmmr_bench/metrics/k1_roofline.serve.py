"""K1's share of its roofline in a served clip (``ops/smpl_cuda``): the
least time of its call at N = 3 heads x the window schedule's kept rows
(``roofline.k1``) over the device time of ``blend_skin_kernel`` per clip."""

from hmmr_bench.roofline import k1

SPEC = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "SMPL kernel K1", "moves": "clip_fps"}


def read(reading):
    s = reading.kernel_seconds(lambda n: "blend_skin_kernel" in n)
    if not s:
        return None
    cfg = reading.config
    g = cfg["seq_length"] - 4 * cfg["num_conv_layers"]
    rows = -(-reading.params["frames"] // (g * cfg["batch_size"])) * cfg["batch_size"] * g
    least_ms = k1.bound_ms(3 * rows, cfg["num_verts"])[0]
    return least_ms / (s * 1e3 / reading.units) * 100.0
