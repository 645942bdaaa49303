"""The port's closed training loop (human_dynamics_tpu_torch.scripts:
the synthetic data generator and the synthetic gauntlet) on the CPU.

- The generator against the JAX repo's scripts/stability_run.generate_data
  at a tiny size and the same seed, in phi and image mode, both trees read
  with the port's record reader. The numpy draws are the same, in the same
  order, so the SMPL npz, poses, shapes, cams, phis, the mocap pool and
  every other field not derived through SMPL are equal. The gt 3D joints
  and the keypoint labels go through each package's SMPL in float32:
  within LABEL_TOL of the labels' scale (max(1, max |label|): normalised
  coordinates, or pixels; measured 1.2e-7 normalised and 2.7e-5 px at a
  ~48 px scale). The rendered frames: each frame whose joints round to
  the same pixels in both trees is byte-equal, and at most
  MAX_PIXEL_SHARE of all pixels differ after decoding (measured: every
  frame byte-equal).
- The toy phi loop of the JAX repo's tests/test_synthetic_gauntlet.py
  with its arguments and assertions (150 steps, 8/2 tubes of 60 frames,
  feature 64, 48 vertices, B=2).
- The image loop's wiring: 2 steps at 64x64, T=16, on raw_u8 train
  records, with the narrow ResNet trunk of tests/test_torch_train_image.py
  (phi 64) in the port's HmmrModel; finite metrics and the demo pkl's
  schema, no improvement asserted.
"""

import functools
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.data.tfrecord import decode_example, read_tfrecord
from human_dynamics_tpu_torch.models import hmmr as PH
from human_dynamics_tpu_torch.models import resnet as PR
from human_dynamics_tpu_torch.scripts import synthetic_gauntlet as G
from human_dynamics_tpu_torch.scripts.stability_run import generate_data
from tests.test_torch_train_image import NARROW

torch.set_num_threads(1)

LABEL_TOL = 1e-5
MAX_PIXEL_SHARE = 1e-2
# Record fields computed through SMPL (and the projection).
SMPL_FIELDS = ("mosh/gt3ds", "image/xys", "image/face_pts", "image/toe_pts")
GEN = dict(num_tubes=2, frames_per_tube=24, feature_dim=16, num_verts=48,
           seed=0, num_test_tubes=1, crop_size=64)
DEMO_KEYS = {"cams", "joints", "kps", "poses", "shapes", "verts", "omegas",
             "joints_delta", "kps_delta", "poses_delta", "omegas_delta",
             "frame_range"}


def _records(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*.tfrecord"), recursive=True))


def _decode(jpegs):
    import cv2

    return [cv2.imdecode(np.frombuffer(bytes(j), np.uint8), cv2.IMREAD_COLOR)
            for j in jpegs]


def _check_frames(got, want, what):
    """Frames whose drawn joints round alike are byte-equal; few pixels
    differ over all."""
    n = len(want["image/encoded"])
    xy = [np.round(np.concatenate([
        np.asarray(f[k], np.float32).reshape(n, -1)
        for k in ("image/xys", "image/face_pts", "image/toe_pts")], 1))
        for f in (got, want)]
    differ = total = 0
    for i, (a, b) in enumerate(zip(_decode(got["image/encoded"]),
                                   _decode(want["image/encoded"]))):
        if np.array_equal(xy[0][i], xy[1][i]):
            assert bytes(got["image/encoded"][i]) == bytes(
                want["image/encoded"][i]), f"{what} frame {i}"
        differ += int((a != b).any(-1).sum())
        total += a.shape[0] * a.shape[1]
    assert differ <= MAX_PIXEL_SHARE * total, (what, differ, total)


@pytest.mark.parametrize("mode", ["phi", "image"])
def test_generator_matches_jax(tmp_path, mode):
    from scripts.stability_run import generate_data as jax_generate_data

    kw = dict(GEN, with_images=mode == "image")
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(out_j)
    data_j, smpl_j = jax_generate_data(out_j, **kw)
    data_p, smpl_p = generate_data(out_p, device="cpu", **kw)

    with np.load(smpl_j) as a, np.load(smpl_p) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    with open(os.path.join(out_j, "GENERATED.json")) as f, open(
            os.path.join(out_p, "GENERATED.json")) as g:
        assert json.load(g) == json.load(f)

    names = _records(data_j)
    assert _records(data_p) == names and len(names) == 4, names
    for name in names:
        got = [decode_example(r) for r in read_tfrecord(
            os.path.join(data_p, name))]
        want = [decode_example(r) for r in read_tfrecord(
            os.path.join(data_j, name))]
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w), name
            for k in w:
                what = f"{name} {k}"
                if k == "image/encoded":
                    _check_frames(g, w, what)
                elif k in SMPL_FIELDS:
                    a, b = (np.asarray(x, np.float32) for x in (g[k], w[k]))
                    scale = max(1.0, float(np.abs(b).max()))
                    np.testing.assert_allclose(a, b, rtol=0,
                                               atol=LABEL_TOL * scale,
                                               err_msg=what)
                else:
                    np.testing.assert_array_equal(np.asarray(g[k]),
                                                  np.asarray(w[k]),
                                                  err_msg=what)


def _args(tmp_path, name, *extra):
    return G.build_arg_parser().parse_args([
        "--out", str(tmp_path / name), "--device", "cpu",
        "--num_tubes", "8", "--num_test_tubes", "2", "--num_verts", "48",
        "--batch_size", "2", "--report", str(tmp_path / f"{name}.md"),
        *extra])


def test_gauntlet_tiny_closed_loop(tmp_path):
    """The JAX repo's toy phi loop (tests/test_synthetic_gauntlet.py) on
    the port: errors below the untrained floor after 150 steps, every
    artifact written."""
    args = _args(tmp_path, "g", "--num_steps", "150", "--save_step", "75",
                 "--frames_per_tube", "60", "--feature_dim", "64")
    result = G.run_gauntlet(args)

    table = {int(k): v for k, v in result["table"].items()}
    steps = sorted(table)
    assert steps == [0, 75, 150]
    for s in steps:
        for k in G.METRIC_KEYS:
            assert np.isfinite(table[s][k]), (s, k)
    assert table[150]["kp"] < table[0]["kp"]
    assert table[150]["joints"] < table[0]["joints"]

    assert result["gates"]["demo_pkl_schema_complete"]
    with open(os.path.join(args.out, "demo_out", "hmmr_output.pkl"),
              "rb") as f:
        preds = pickle.load(f)
    assert set(preds) >= DEMO_KEYS
    assert preds["omegas"].shape[1] == 85
    assert preds["frame_range"].tolist() == [0, preds["omegas"].shape[0]]

    with open(os.path.join(args.out, "gauntlet_results.json")) as f:
        saved = json.load(f)
    assert sorted(int(k) for k in saved["table"]) == steps
    with open(args.report) as f:
        report = f.read()
    assert "| step |" in report and "| 150 |" in report


def test_gauntlet_image_wiring(tmp_path, monkeypatch):
    """The image loop runs end to end: skeleton JPEGs re-encoded to raw_u8
    for training, a from-scratch trunk on the port's loader and augment,
    the evaluator on image test records, the demo pkl from uint8 frames."""
    monkeypatch.setattr(PH, "ResNetV2_50",
                        functools.partial(PR.ResNetV2_50, blocks=NARROW))
    args = _args(tmp_path, "gi", "--mode", "image", "--img_size", "64",
                 "--e_lr", "3e-4", "--raw_records", "--num_steps", "2",
                 "--save_step", "2", "--frames_per_tube", "20", "--T", "16",
                 "--feature_dim", str(NARROW[-1][1]))
    args.num_tubes, args.num_test_tubes = 2, 1
    result = G.run_gauntlet(args)

    table = {int(k): v for k, v in result["table"].items()}
    assert sorted(table) == [0, 2]
    for s, row in table.items():
        for k in ("kp", "kp_pck", "joints", "joints_pa"):
            assert np.isfinite(row[k]), (s, k)
    assert result["gates"]["demo_pkl_schema_complete"]
    with open(os.path.join(args.out, "demo_out", "hmmr_output.pkl"),
              "rb") as f:
        preds = pickle.load(f)
    assert set(preds) >= DEMO_KEYS
    assert preds["frame_range"].tolist() == [0, 20]
    raw = glob.glob(os.path.join(args.out, "data_raw", "*", "train",
                                 "*.tfrecord"))
    assert len(raw) == 2
