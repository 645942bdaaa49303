"""The port's demo slice (tracks, bboxes, crops, the SMPL pickle converter,
the track extractor and ``infer.demo``) against the JAX package's, on the
CPU.

The slice as a whole runs both packages' ``demo.main`` on the same PNG
directory, track JSON, npz weights and SMPL npz: 30 frames of 120x160, one
person with two frames of no detection, a 32-vertex synthetic SMPL model
with 25 keypoints, and the narrow ResNet-50 v2 trunk of
tests/test_torch_train_image_step.py (phi 64) patched into both packages'
HmmrModel. Tolerances:
- the crops: within 1e-6 of JAX's cv2 crops (float64 arithmetic in both;
  the float32 cast rounds the last bit);
- the pkl: the same keys, shapes and dtypes; values within atol/rtol 1e-4,
  2e-4 on the SMPL keys (tests/test_torch_predictor.py's bounds);
- ``--fast`` (bf16 encoder, fused SMPL): within 1.3e-2 (the bf16_encoder
  bound of tests/test_torch_predictor.py);
- the track reader, the bboxes and the converted SMPL npz: equal.
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from human_dynamics_tpu.infer import bbox as JB
from human_dynamics_tpu.infer import crop as JCrop
from human_dynamics_tpu.infer import tracks as JTracks
from human_dynamics_tpu.models import hmmr as JH
from human_dynamics_tpu.models import resnet as JR
from human_dynamics_tpu_torch.core import smpl as PSmpl
from human_dynamics_tpu_torch.infer import bbox as PB
from human_dynamics_tpu_torch.infer import crop as PCrop
from human_dynamics_tpu_torch.infer import demo as PD
from human_dynamics_tpu_torch.infer import tracks as PTracks
from human_dynamics_tpu_torch.models import hmmr as PH
from human_dynamics_tpu_torch.models import resnet as PR
from human_dynamics_tpu_torch.utils.checkpoint import save_checkpoint
from human_dynamics_tpu_torch.utils.weights import export_jax_variables
from tests.test_core_smpl import _make_chumpy_pkl
from tests.test_torch_train_image import NARROW, randomise

torch.set_num_threads(1)

N_FRAMES, H, W = 30, 120, 160
PHI = NARROW[-1][1]
NUM_VERTS, NUM_KPS = 32, 25
SMPL_KEYS = ("joints", "kps", "verts")
MISSING = (7, 19)   # frames with no detection


def _person(i, rng):
    """25 keypoints of one person walking right, (25, 3)."""
    kps = np.zeros((NUM_KPS, 3))
    kps[:, 0] = 60 + 2 * i + np.linspace(-15, 15, NUM_KPS)
    kps[:, 1] = 60 + np.linspace(-40, 40, NUM_KPS) + rng.randn(NUM_KPS)
    kps[:, 2] = rng.uniform(0.5, 1.0, NUM_KPS)
    return kps


def write_track_json(path, n=N_FRAMES, seed=0):
    """A PoseFlow JSON: track 0 walks through every frame but MISSING,
    track 1 is seen in 3 frames only (dropped by min_kp_count)."""
    rng = np.random.RandomState(seed)
    data = {}
    for i in range(n):
        people = []
        if i not in MISSING:
            people.append({"keypoints": _person(i, rng).ravel().tolist(),
                           "idx": 0})
        if 10 <= i < 13:
            people.append({"keypoints": _person(-i, rng).ravel().tolist(),
                           "idx": 1})
        data[f"frame{i:04d}.png"] = people
    with open(path, "w") as f:
        json.dump(data, f)
    return str(path)


def test_track_reader_and_bboxes_match_jax(tmp_path):
    """get_labels_poseflow and the smoothed bboxes (with interpolated gaps)
    equal JAX's."""
    path = write_track_json(tmp_path / "tracked.json")
    for min_kp in (20, 0):
        got = PTracks.get_labels_poseflow(path, N_FRAMES, min_kp)
        want = JTracks.get_labels_poseflow(path, N_FRAMES, min_kp)
        assert len(got) == len(want) == (1 if min_kp else 2)
        for g, w in zip(got, want):
            assert [k is None for k in g] == [k is None for k in w]
            for a, b in zip(g, w):
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    kps = PTracks.get_labels_poseflow(path, N_FRAMES)[0]
    assert all(kps[i] is None for i in MISSING)
    for vis in (0.1, 0.7):
        got = PB.get_smooth_bbox_params(kps, vis_thresh=vis)
        want = JB.get_smooth_bbox_params(kps, vis_thresh=vis)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert PB.kp_to_bbox_param(None, 0.1) is None


@pytest.mark.parametrize("scale", [0.37, 0.731, 1.3, 2.7])
def test_process_image_matches_jax(scale):
    """The crop (torch, float64) against JAX's cv2 crop within 1e-6, at the
    frame's centre and near its edges; the metadata equal."""
    rng = np.random.RandomState(int(scale * 100))
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    for cx, cy in ((W / 2, H / 2), (3.0, 4.0), (W - 2.5, H - 1.0),
                   (-10.0, H / 3)):
        param = np.array([cx, cy, scale])
        got = PCrop.process_image(img, param, device="cpu")
        want = JCrop.process_image(img, param)
        assert got["image"].dtype == torch.float32
        assert tuple(got["image"].shape) == want["image"].shape
        np.testing.assert_allclose(got["image"].numpy(), want["image"],
                                   atol=1e-6, rtol=0)
        assert got["im_shape"] == want["im_shape"]
        for k in ("center", "start_pt"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["scale"] == want["scale"]
    resized, factors = PCrop.resize_img(img / 255.0, scale)
    want_resized, want_factors = JCrop.resize_img(img / 255.0, scale)
    assert factors == want_factors
    np.testing.assert_allclose(resized, want_resized, atol=1e-12, rtol=0)


@pytest.mark.parametrize("sparse_jreg", [False, True])
def test_convert_smpl_pkl_matches_jax(tmp_path, sparse_jreg):
    """The chumpy pickle converts to the same npz as the JAX converter
    writes, without chumpy; load_smpl_model reads the pickle directly."""
    from human_dynamics_tpu.core.smpl import convert_smpl_pkl as jax_convert
    from human_dynamics_tpu.core.smpl import load_smpl_model as jax_load

    pkl = str(tmp_path / "neutral_smpl.pkl")
    _make_chumpy_pkl(pkl, np.random.RandomState(11), sparse_jreg=sparse_jreg)
    PSmpl.convert_smpl_pkl(pkl, str(tmp_path / "port.npz"))
    jax_convert(pkl, str(tmp_path / "jax.npz"))
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    model = PSmpl.load_smpl_model(pkl, joint_type="lsp")
    ref = jax_load(pkl, joint_type="lsp")
    assert model.parents == ref.parents
    np.testing.assert_array_equal(model.faces, ref.faces)
    for k in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights", "joint_regressor"):
        np.testing.assert_array_equal(getattr(model, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)


def test_compute_tracks_with_stub_trackers(tmp_path):
    """compute_tracks runs stub AlphaPose/PoseFlow scripts (their flags and
    output paths), is idempotent, and without AlphaPose asks for the
    tracked JSON."""
    from human_dynamics_tpu_torch.infer.extract_tracks import (
        TRACKED_JSON,
        compute_tracks,
    )

    out_dir = tmp_path / "out"
    img_dir = out_dir / "video_frames"
    img_dir.mkdir(parents=True)
    (img_dir / "frame0000000001.png").write_bytes(b"png")
    alphapose_dir = tmp_path / "AlphaPose"
    alphapose_dir.mkdir()
    (alphapose_dir / "demo.py").write_text(
        "import argparse, json, os\n"
        "p = argparse.ArgumentParser()\n"
        "p.add_argument('--indir'); p.add_argument('--outdir')\n"
        "p.add_argument('--sp', action='store_true')\n"
        "p.add_argument('--format')\n"
        "a = p.parse_args()\n"
        "assert os.path.isdir(a.indir) and a.format == 'cmu'\n"
        "open(os.path.join(a.outdir, 'alphapose-results.json'), 'w')"
        ".write(json.dumps({'frame0000000001.png': []}))\n"
    )
    poseflow_dir = tmp_path / "PoseFlow"
    poseflow_dir.mkdir()
    (poseflow_dir / "tracker-general.py").write_text(
        "import argparse, json, os\n"
        "p = argparse.ArgumentParser()\n"
        "p.add_argument('--imgdir'); p.add_argument('--in_json')\n"
        "p.add_argument('--out_json')\n"
        "a = p.parse_args()\n"
        "assert os.path.exists(a.in_json)\n"
        "assert a.out_json.endswith('-tracked.json')\n"
        "open(a.out_json, 'w').write(json.dumps(\n"
        "    {'frame0000000001.png': [{'keypoints': [1.0, 2.0, 0.9] * 25,"
        " 'idx': 0}]}))\n"
    )
    kw = dict(alphapose_dir=str(alphapose_dir),
              poseflow_dir=str(poseflow_dir))
    tracked, frames = compute_tracks(str(tmp_path / "missing.mp4"),
                                     str(out_dir), **kw)
    assert os.path.basename(tracked) == TRACKED_JSON
    assert frames == str(img_dir)
    tracks = PTracks.get_labels_poseflow(tracked, 1, min_kp_count=0)
    assert len(tracks) == 1 and tracks[0][0].shape == (25, 3)
    (alphapose_dir / "demo.py").unlink()
    (poseflow_dir / "tracker-general.py").unlink()
    assert compute_tracks(str(tmp_path / "missing.mp4"), str(out_dir),
                          **kw)[0] == tracked
    with pytest.raises(FileNotFoundError, match="tracked json"):
        compute_tracks(str(tmp_path / "missing.mp4"), str(tmp_path / "b"))


# ---------------------------------------------------------------------------
# The slice as a whole: demo.main in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def narrow_models():
    """Both packages' HmmrModel build the narrow trunk, with phi 64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JH, "ResNetV2_50",
                   functools.partial(JR.ResNetV2_50, blocks=NARROW))
        mp.setattr(PH, "ResNetV2_50",
                   functools.partial(PR.ResNetV2_50, blocks=NARROW))
        mp.setattr(JH, "HmmrModel",
                   functools.partial(JH.HmmrModel, feature_dim=PHI))
        mp.setattr(PH, "HmmrModel",
                   functools.partial(PH.HmmrModel, feature_dim=PHI))
        yield


@pytest.fixture(scope="module")
def demo_inputs(narrow_models, tmp_path_factory):
    """PNG frames, the track JSON, npz weights and an SMPL npz."""
    import cv2

    root = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(1)
    img_dir = root / "frames"
    img_dir.mkdir()
    for i in range(N_FRAMES):
        frame = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        cv2.imwrite(str(img_dir / f"frame{i:04d}.png"), frame)
    model = PH.HmmrModel(include_resnet=True, device="cpu",
                         generator=torch.Generator().manual_seed(2))
    weights = save_checkpoint(str(root / "weights.npz"),
                              randomise(export_jax_variables(model), 3))
    smpl = PSmpl.synthetic_smpl_model(num_verts=NUM_VERTS, num_kps=NUM_KPS)
    smpl_path = str(root / "smpl.npz")
    np.savez(smpl_path, parents=np.array(smpl.parents), faces=smpl.faces,
             cocoplus_regressor=smpl.joint_regressor.numpy(),
             **{k: getattr(smpl, k).numpy() for k in (
                 "v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights")})
    return dict(
        root=root,
        args=["--img_dir", str(img_dir),
              "--track_json", write_track_json(root / "tracked.json"),
              "--load_path", weights, "--smpl_model_path", smpl_path,
              "--batch_size", "2"],
    )


def _read_pkl(out_dir):
    with open(os.path.join(out_dir, "hmmr_output", "hmmr_output.pkl"),
              "rb") as f:
        return pickle.load(f)


def _assert_pkl_close(got, want, atol, smpl_atol):
    assert set(got) == set(want)
    for k in sorted(want):
        assert type(got[k]) is type(want[k]) is np.ndarray, k
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        tol = smpl_atol if k.split("_")[0] in SMPL_KEYS else atol
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("fast", [False, True], ids=["fp32", "fast"])
def test_demo_main_matches_jax(demo_inputs, fast):
    """The port's demo CLI (--device cpu) and the JAX package's write pkls
    with the same schema, dtypes and values; a second run reuses the pkl,
    and rendering writes the composite mp4."""
    from human_dynamics_tpu.infer import demo as JD

    root = demo_inputs["root"]
    tag = "fast" if fast else "fp32"
    flags = demo_inputs["args"] + (["--fast"] if fast else [])
    JD.main(flags + ["--out_dir", str(root / f"jax_{tag}"), "--no_render"])
    port_out = str(root / f"port_{tag}")
    PD.main(flags + ["--out_dir", port_out, "--no_render", "--device",
                     "cpu"])
    got, want = _read_pkl(port_out), _read_pkl(str(root / f"jax_{tag}"))
    n = N_FRAMES
    assert got["omegas"].shape == (n, 85)
    assert got["verts_delta"].shape == (n, 2, NUM_VERTS, 3)
    np.testing.assert_array_equal(got["frame_range"], [0, n])
    tol = 1.3e-2 if fast else 1e-4
    _assert_pkl_close(got, want, tol, 1.3e-2 if fast else 2e-4)

    pkl = os.path.join(port_out, "hmmr_output", "hmmr_output.pkl")
    mtime = os.path.getmtime(pkl)
    PD.main(flags + ["--out_dir", port_out, "--device", "cpu", "--trim"])
    assert os.path.getmtime(pkl) == mtime
    mp4 = os.path.join(port_out, "hmmr_output", "hmmr_output.mp4")
    assert os.path.getsize(mp4) > 1000


def test_demo_needs_a_device(demo_inputs, tmp_path):
    """Without --device the demo raises where there is no CUDA device, and
    a frame directory without a track JSON is refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: no --device means it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.main(demo_inputs["args"] + ["--out_dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        PD.main(["--load_path", "w.npz", "--smpl_model_path", "s.npz",
                 "--img_dir", str(tmp_path)])
