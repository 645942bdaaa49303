"""The int8 conv kernel's share of its roofline over a served clip
(``ops/resnet_int8_cuda`` -> ``ops/csrc/resnet_int8.cu``): the least time
of a clip's int8 convs (``roofline.int8_conv``, chunks of encode_chunk
frames) over the device time of the kernels named ``conv_wgmma_kernel``
per clip."""

from hmmr_bench.roofline import int8_conv

SPEC = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "int8 conv kernels", "moves": "clip_fps"}


def read(reading):
    s = reading.kernel_seconds(lambda n: "conv_wgmma_kernel" in n)
    if not s:
        return None
    frames = reading.params["frames"]
    ops, b = int8_conv.clip_work(frames, reading.config["encode_chunk"],
                                 reading.params["image_size"])
    from hmmr_bench.roofline import peaks

    least_ms = peaks.bound_ms(ops, peaks.INT8_OPS, b)[0]
    return least_ms / (s * 1e3 / reading.units) * 100.0
