"""The port's evaluation path against the JAX package's: the copies of
data/tfrecord, data/schema and eval/metrics, the on-device metrics
(human_dynamics_tpu_torch.eval.metrics_device) and the Evaluator
(human_dynamics_tpu_torch.eval.harness), on the same records and weights.

Tolerances: the device metrics and the Evaluator's tables at rtol 2e-3,
atol 2e-4 (tests/test_eval_device_metrics.py's bound against the numpy
oracle); padding with num_frames at rtol 1e-5, atol 1e-6; the numpy paths
of the two packages at rtol 1e-5 (the same numpy code; the mesh decode
runs in torch and in JAX).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu import data as JD
from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.eval import harness as JH
from human_dynamics_tpu.eval.metrics_device import (
    make_compute_errors_device as jax_device_errors,
)
from human_dynamics_tpu.infer.predictor import HmmrPredictor as JaxPredictor
from human_dynamics_tpu_torch import data as PD
from human_dynamics_tpu_torch.core import rodrigues, synthetic_smpl_model
from human_dynamics_tpu_torch.eval import harness as PH
from human_dynamics_tpu_torch.eval import metrics as PM
from human_dynamics_tpu_torch.eval import metrics_device as MD
from human_dynamics_tpu_torch.infer import HmmrPredictor
from tests.test_torch_predictor import _models

torch.set_num_threads(1)

C = 64
DEV_TOL = dict(rtol=2e-3, atol=2e-4)


def record_fields(n, rng, phis=True, k=25):
    """convert_to_example_temporal's arguments for an n-frame tube: random
    visibility, one frame below min_visible, 3D labels and C-dim phis."""
    labels = rng.rand(n, 3, k).astype(np.float32) * 200
    labels[:, 2] = rng.rand(n, k) > 0.2
    labels[min(4, n - 1), 2, 3:] = 0
    return dict(
        image_datas=None,
        image_paths=[f"f{i}.png" for i in range(n)],
        image_shapes=np.full((n, 2), 224),
        labels=labels,
        centers=rng.randint(0, 224, (n, 2)),
        gt3ds=rng.randn(n, 14, 3).astype(np.float32) * 0.3,
        scale_factors=rng.rand(n, 2).astype(np.float32),
        start_pts=rng.randint(0, 50, (n, 2)),
        cams=rng.rand(n, 3).astype(np.float32),
        poses=rng.randn(n, 72).astype(np.float32) * 0.2,
        shape=rng.randn(10).astype(np.float32) * 0.3,
        phis=rng.randn(n, C).astype(np.float32) * 0.5 if phis else None,
        time_pts=np.array([0, n]),
    )


def test_copies_write_and_read_the_same_records(tmp_path):
    """The port's schema and tfrecord copies write byte-identical examples
    and files, and each package reads what the other wrote: phi records,
    JPEG records (cv2) and raw uint8 frames."""
    import cv2

    rng = np.random.RandomState(0)
    jpeg = [cv2.imencode(".jpg", rng.randint(0, 255, (16, 16, 3)).astype(
        np.uint8))[1].tobytes() for _ in range(3)]
    cases = [
        record_fields(3, rng),
        dict(record_fields(3, rng, phis=False), image_datas=jpeg),
        dict(record_fields(3, rng, k=19), image_datas=[b"\x01" * 12] * 3,
             image_format="raw_u8", gt3ds=None, poses=None),
    ]
    for i, kw in enumerate(cases):
        port = PD.convert_to_example_temporal(**kw)
        assert port == JD.convert_to_example_temporal(**kw), i
        for write, name in ((PD.TFRecordWriter, "port"),
                            (JD.TFRecordWriter, "jax")):
            with write(str(tmp_path / f"{name}{i}.tfrecord")) as w:
                w.write(port)
                w.write(port)
        files = [(tmp_path / f"{n}{i}.tfrecord").read_bytes()
                 for n in ("port", "jax")]
        assert files[0] == files[1]
        assert list(JD.read_tfrecord(str(tmp_path / f"port{i}.tfrecord"),
                                     check_crc=True)) == [port, port]
        assert list(PD.read_tfrecord(str(tmp_path / f"jax{i}.tfrecord"),
                                     check_crc=True)) == [port, port]
        assert PD.decode_example(port).keys() == JD.decode_example(port).keys()
        if kw.get("image_format") == "raw_u8":
            p, j = PD.parse_temporal_example(port), JD.parse_temporal_example(
                port)
            assert p.image_format == j.image_format == b"raw_u8"
            np.testing.assert_array_equal(p.kps, j.kps)
            continue
        p, j = PD.read_test_example(port), JD.read_test_example(port)
        assert p.keys() == j.keys()
        for key in p:
            if key == "images" and p[key] is not None:
                assert len(p[key]) == len(j[key]) == 3
                for a, b in zip(p[key], j[key]):
                    np.testing.assert_array_equal(a, b)
            elif isinstance(p[key], np.ndarray):
                np.testing.assert_array_equal(p[key], j[key], err_msg=key)
            else:
                assert p[key] == j[key], key


def make_tube(n=31, k=25, seed=29):
    rng = np.random.RandomState(seed)
    kps_gt = np.zeros((n, k, 3), np.float32)
    kps_gt[..., :2] = rng.rand(n, k, 2) * 224
    kps_gt[..., 2] = (rng.rand(n, k) > 0.2).astype(np.float32)
    # One frame below min_visible: the numpy path NaNs it, the device path
    # masks it.
    kps_gt[4, :, 2] = 0.0
    kps_gt[4, :3, 2] = 1.0
    joints_gt = rng.randn(n, 14, 3).astype(np.float32) * 0.3
    poses_gt = (rng.randn(n, 72) * 0.2).astype(np.float32)
    pose_noise = (poses_gt + rng.randn(n, 72) * 0.05).astype(np.float32)
    shape_gt = (rng.randn(10) * 0.3).astype(np.float32)
    return dict(
        kps_gt=kps_gt,
        kps_pred=(rng.rand(n, k, 2) * 2 - 1).astype(np.float32),
        joints_gt=joints_gt,
        joints_pred=(joints_gt + rng.randn(n, 14, 3) * 0.05).astype(
            np.float32),
        poses_gt=poses_gt,
        poses_pred=rodrigues(torch.from_numpy(
            pose_noise.reshape(n, 24, 3))).numpy(),
        shape_gt=shape_gt,
        shapes_pred=(shape_gt + rng.randn(n, 10) * 0.05).astype(np.float32),
    )


FLAGS = dict(img_size=224, has_3d=True, compute_mesh=True)


def port_device_errors(tube, smpl, num_frames=None):
    fn = MD.make_compute_errors_device(smpl)
    got = fn(**{k: torch.from_numpy(v) for k, v in tube.items()},
             num_frames=num_frames, **FLAGS)
    return {k: float(v) for k, v in got.items()}


def test_metrics_device_matches_jax_and_numpy_oracle():
    """Every tube scalar, mesh included, against the JAX device metrics and
    the numpy oracle; the port's numpy path against the JAX package's."""
    tube = make_tube()
    got = port_device_errors(tube, synthetic_smpl_model(48, 25))
    jsmpl = jax_smpl(num_verts=48, num_kps=25)
    want_dev = {k: float(v) for k, v in jax_device_errors(jsmpl)(
        **{k: jnp.asarray(v) for k, v in tube.items()}, **FLAGS).items()}
    f64 = {k: v.astype(np.float64) if k != "poses_pred" else v
           for k, v in tube.items()}
    oracle = {k: float(np.nanmean(v)) for k, v in JH.compute_errors_batched(
        **f64, smpl=jsmpl, **FLAGS).items()}
    port_np = {k: float(np.nanmean(v)) for k, v in PH.compute_errors_batched(
        **f64, smpl=synthetic_smpl_model(48, 25), **FLAGS).items()}
    assert set(got) == set(want_dev) == set(oracle) == set(port_np)
    assert len(got) == 9
    for k in sorted(oracle):
        np.testing.assert_allclose(got[k], oracle[k], err_msg=k, **DEV_TOL)
        np.testing.assert_allclose(got[k], want_dev[k], err_msg=k, **DEV_TOL)
        np.testing.assert_allclose(port_np[k], oracle[k], rtol=1e-5,
                                   err_msg=k)


def test_metrics_device_padding_is_exact():
    """Rows past num_frames (zero labels, identity rotations) move no
    aggregate."""
    tube = make_tube(n=31)
    smpl = synthetic_smpl_model(48, 25)
    padded = {}
    for k, v in tube.items():
        if k == "shape_gt":
            padded[k] = v
            continue
        fill = (np.broadcast_to(np.eye(3, dtype=np.float32), (17, 24, 3, 3))
                if k == "poses_pred" else np.zeros((17,) + v.shape[1:],
                                                   v.dtype))
        padded[k] = np.concatenate([v, fill])
    exact = port_device_errors(tube, smpl)
    got = port_device_errors(padded, smpl, num_frames=31)
    for k in sorted(exact):
        np.testing.assert_allclose(got[k], exact[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_similarity_align_ignores_svd_signs(monkeypatch):
    """Procrustes against the numpy oracle, reflections included, and
    unchanged when the SVD returns its singular vectors with other signs."""
    rng = np.random.RandomState(3)
    s1 = rng.randn(16, 14, 3).astype(np.float32)
    rot = rodrigues(torch.from_numpy(rng.randn(16, 3).astype(np.float32)))
    s2 = torch.einsum("nij,nkj->nki", rot, torch.from_numpy(s1)).numpy()
    s2 = s2 * 1.3 + rng.randn(16, 1, 3).astype(np.float32)
    s2[::2, :, 0] *= -1                 # half the targets are mirrored
    s2 += rng.randn(*s2.shape).astype(np.float32) * 0.05
    want = PM.compute_similarity_transform_batch(s1, s2)
    a, b = torch.from_numpy(s1), torch.from_numpy(s2)
    got = MD.similarity_align(a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    svd = torch.linalg.svd
    flips = torch.from_numpy(rng.choice([-1.0, 1.0], (16, 3)).astype(
        np.float32))

    def flipped(k):
        u, s, vh = svd(k)
        return u * flips[:, None, :], s, vh * flips[:, :, None]

    monkeypatch.setattr(torch.linalg, "svd", flipped)
    np.testing.assert_allclose(MD.similarity_align(a, b).numpy(), got,
                               rtol=1e-5, atol=1e-5)


def write_records(root, rng):
    """A tiny h36m set (a cam03 record of 2 tubes, a cam01 record the
    evaluator must skip) and a 3dpw set (two records of other lengths)."""
    specs = {
        ("h36m", "S9_cam03_walk"): (27, 33),
        ("h36m", "S9_cam01_walk"): (25,),
        ("3dpw", "downtown_0"): (29,),
        ("3dpw", "downtown_1"): (36,),
    }
    for (dataset, name), lengths in specs.items():
        d = root / dataset / "test"
        d.mkdir(parents=True, exist_ok=True)
        with PD.TFRecordWriter(str(d / f"{name}.tfrecord")) as w:
            for n in lengths:
                w.write(PD.convert_to_example_temporal(
                    **record_fields(n, rng)))


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    write_records(root, np.random.RandomState(5))
    jm, variables, tm = _models(feature_dim=C, example=jnp.zeros((1, 20, C)))
    kw = dict(batch_size=2, seq_length=20)
    jp = JaxPredictor(jm, variables, jax_smpl(num_verts=48, num_kps=25), **kw)
    tp = HmmrPredictor(tm, None, synthetic_smpl_model(num_verts=48,
                                                      num_kps=25),
                       device="cpu", **kw)
    return root, jp, tp, variables


def assert_tables_close(got, want):
    assert set(got) == set(want)
    for dataset in want:
        assert set(got[dataset]) == set(want[dataset]), dataset
        for k in sorted(want[dataset]):
            np.testing.assert_allclose(got[dataset][k], want[dataset][k],
                                       err_msg=f"{dataset} {k}", **DEV_TOL)


@pytest.mark.parametrize("device_metrics", [False, True])
def test_evaluator_matches_jax(eval_setup, tmp_path, device_metrics):
    """run() on h36m and 3dpw phi records: the same table and JSON as the
    JAX Evaluator; only h36m's cam03 record is read; device mode writes no
    prediction pkls, and a re-run reads the caches."""
    root, jp, tp, _ = eval_setup
    datasets = ["h36m", "3dpw"]
    port = PH.Evaluator(tp, str(tmp_path / "port"),
                        device_metrics=device_metrics)
    got = port.run(str(root), datasets)
    want = JH.Evaluator(jp, str(tmp_path / "jax"),
                        device_metrics=device_metrics).run(str(root), datasets)
    assert_tables_close(got, want)
    assert "mesh_posed" in got["3dpw"] and "mesh_posed" not in got["h36m"]
    name = "results_test_pred_h36m-3dpw.json"
    with open(tmp_path / "port" / name) as f:
        port_json = json.load(f)
    with open(tmp_path / "jax" / name) as f:
        assert json.load(f).keys() == port_json.keys()
    errs = tmp_path / "port" / "errors" / port.model_tag
    assert sorted(os.listdir(errs / "h36m")) == [
        "S9_cam03_walk_person0_pred.pkl", "S9_cam03_walk_person1_pred.pkl"]
    assert os.path.exists(tmp_path / "port" / "preds") != device_metrics
    assert port.run(str(root), datasets) == got


def test_evaluator_run_const_matches_jax(eval_setup, tmp_path):
    root, jp, tp, _ = eval_setup
    got = PH.Evaluator(tp, str(tmp_path / "port")).run_const(str(root),
                                                             ["3dpw"])
    want = JH.Evaluator(jp, str(tmp_path / "jax")).run_const(str(root),
                                                             ["3dpw"])
    assert len(got["3dpw"]) == 8
    assert_tables_close(got, want)


def test_restore_model_config_and_cli(eval_setup, tmp_path):
    """restore_model_config reads a params.json as the JAX one does; the CLI
    loads a JAX npz checkpoint on the CPU and prints the same table as an
    Evaluator on the same weights; an orbax directory is refused."""
    from human_dynamics_tpu.utils.checkpoint import save_checkpoint

    root, _, tp, variables = eval_setup
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    with open(run_dir / "params.json", "w") as f:
        json.dump({"feature_dim": C, "delta_t_values": [-5, 5],
                   "batch_size": 4, "num_stage": 3}, f)
    ckpt = str(run_dir / "model.npz")
    save_checkpoint(ckpt, variables)
    got = PH.restore_model_config(ckpt)
    assert got == JH.restore_model_config(ckpt)
    assert got == {"feature_dim": C, "delta_t_values": (-5, 5),
                   "num_stage": 3}

    smpl = synthetic_smpl_model(num_verts=48, num_kps=25)
    np.savez(str(tmp_path / "smpl.npz"), parents=np.array(smpl.parents),
             cocoplus_regressor=smpl.joint_regressor.numpy(),
             **{k: getattr(smpl, k).numpy() for k in (
                 "v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights")})
    args = ["--tf_dir", str(root), "--load_path", ckpt, "--smpl_model_path",
            str(tmp_path / "smpl.npz"), "--datasets", "3dpw",
            "--precomputed_phi", "--batch_size", "2", "--device", "cpu",
            "--device_metrics", "--out_dir", str(tmp_path / "cli")]
    want = PH.Evaluator(tp, str(tmp_path / "direct"),
                        device_metrics=True).run(str(root), ["3dpw"])
    assert PH.main(args) == want
    with pytest.raises(ValueError, match="npz"):
        PH.main(args[:3] + [str(run_dir)] + args[4:])
