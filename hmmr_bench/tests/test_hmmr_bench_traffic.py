"""The serving cell's traffic is the JAX package's benchmark workload in
PyTorch (f32 frames in [-1, 1], 10 distinct 480-frame clips, calibration
on the first clip's first 32 frames, outputs left on the device), not the
smoke test's uint8 clip; the training cells' pools hold distinct batches."""

import inspect

import torch

from hmmr_bench.harness import core, inputs
from hmmr_bench.traffic import clip_closed


def test_serving_cell_is_the_jax_benchmark_workload():
    cell = core.load_json("workloads", "serve-clip480-f32")
    mix = core.load_json("traffic", cell["traffic"])
    cfg = core.load_json("configs", cell["config"])
    assert mix["kind"] == "clip_closed"
    p = mix["params"]
    assert (p["frames"], p["clips"], p["image_size"]) == (480, 10, 224)
    assert cfg["int8_calibration_frames"] == 32
    assert cfg["int8_encoder"] and cfg["bf16_temporal"] and cfg["use_fused_smpl"]
    assert cfg["int8_root"] is False and cfg["int8_stream"] is False
    clips = inputs.uniform_clips(7, 3, 5, 8, "cpu")
    assert clips.dtype == torch.float32 and clips.shape == (3, 5, 8, 8, 3)
    assert float(clips.min()) >= -1.0 and float(clips.max()) <= 1.0
    assert float(clips.min()) < -0.9 and float(clips.max()) > 0.9
    assert not torch.equal(clips[0], clips[1])
    src = inspect.getsource(clip_closed.run)
    assert "as_numpy=False" in src
    assert "clips[0][:ctx.config[\"int8_calibration_frames\"]]" in src


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    a = inputs.train_batches(2**31 + 11, 3, 2, 4, 8, 0, 25, 32, "cpu")
    b = inputs.train_batches(2**31 + 11, 3, 2, 4, 8, 0, 25, 32, "cpu")
    c = inputs.train_batches(2**31 + 12, 3, 2, 4, 8, 0, 25, 32, "cpu")
    for k in a[0]:
        assert torch.equal(a[1][k], b[1][k])
    assert not torch.equal(a[0]["phis"], a[1]["phis"])
    assert not torch.equal(a[0]["phis"], c[0]["phis"])
