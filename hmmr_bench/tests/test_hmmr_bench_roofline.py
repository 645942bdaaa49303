"""The frozen roofline arithmetic, pinned to the numbers the port's bring-up
measured against (PERF.md's kernel table)."""

import pytest

from hmmr_bench.roofline import int8_conv, k1, peaks, step, stem_pool
from hmmr_bench.roofline.resnet50 import convs


def test_k1_bound():
    products, _, _ = k1.work(1536, 6890)
    assert 3 * products / 1e9 == pytest.approx(59.62, abs=0.005)
    assert k1.bound_ms(1536) == (pytest.approx(0.1205, abs=5e-5), "operations")
    assert k1.bound_ms(640)[0] == pytest.approx(0.0502, abs=5e-5)
    assert k1.fp32_bound_ms(1536)[0] == pytest.approx(0.3000, abs=5e-4)


def test_int8_conv_chunk_bound():
    ops, b = int8_conv.chunk_work(120)
    assert b / 1e9 == pytest.approx(4.27, abs=0.005)
    assert int8_conv.chunk_bound_ms(120) == (pytest.approx(1.2733, abs=5e-5), "bytes")
    assert sum(c.name != "root" for c in convs()) == 52
    assert int8_conv.clip_work(480, 120) == (4 * ops, 4 * b)


def test_stem_pool_bound():
    ops, b = stem_pool.work(120)
    assert ops / 1e9 == pytest.approx(28.32, abs=0.005)
    assert b / 1e6 == pytest.approx(42.3, abs=0.05)
    assert stem_pool.bound_ms(120) == (pytest.approx(0.0143, abs=5e-5), "operations")
    assert stem_pool.work(120, kind="f32", fold="s2d")[1] / 1e6 == pytest.approx(96.4, abs=0.1)


def test_whole_clip_and_step_bounds():
    cfg = {"feature_dim": 2048, "num_conv_layers": 3, "batch_size": 8,
           "seq_length": 20, "num_verts": 6890}
    least, ops = step.serve_clip(480, cfg)
    assert set(ops) == {"int8", "bf16", "tf32"}
    # The int8 trunk alone: 3.23 TOP a clip.
    assert ops["int8"] / 1e12 == pytest.approx(3.228, abs=0.001)
    assert least == pytest.approx(2.0705, abs=1e-3)
    phi, _ = step.train_step(160, cfg)
    image, ops = step.train_step(160, cfg, 224)
    # The frozen fp32 ResNet's forward of 160 frames is most of an image step.
    assert image - phi == pytest.approx(1.11366e12 / peaks.FP32_OPS * 1e3, rel=1e-3)
    assert phi == pytest.approx(2.1344, abs=1e-3)
