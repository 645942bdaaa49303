"""The port's image-mode Trainer, its checkpoints across the two packages
and train.main on image records, on the CPU.

Sizes and the narrow ResNet trunk are those of
tests/test_torch_train_image_step.py (2 tubes of T=8 frames of 32x32, every
head, a 32-vertex synthetic SMPL model, phi 64). Checkpoints are compared
for equality.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from human_dynamics_tpu.utils.checkpoint import flatten_tree
from human_dynamics_tpu.utils.checkpoint import load_checkpoint as jax_load
from human_dynamics_tpu.utils.checkpoint import save_checkpoint as jax_save
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.train import main as train_main
from human_dynamics_tpu_torch.train import trainer as PT
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.weights import (
    export_jax_variables,
    load_jax_variables,
)
from tests.test_torch_train_image import _write_image_data, randomise
from tests.test_torch_train_image_step import (
    DIMS,
    NUM_VERTS,
    _batch_arrays,
    _port_batch,
    narrow_resnet,  # noqa: F401  (the module's autouse fixture)
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    smpl = synthetic_smpl_model(num_verts=NUM_VERTS, num_kps=DIMS["num_kps"])
    state = PT.create_train_state(Config(**DIMS), "cpu",
                                  torch.Generator().manual_seed(1))
    trees = {"e": randomise(export_jax_variables(state.hmmr), 2),
             "d": randomise(export_jax_variables(state.disc), 3)}
    return dict(smpl=smpl, trees=trees,
                batch=_port_batch(_batch_arrays(Config(**DIMS))))


def test_trainer_learns_with_remat(setup):
    """A tiny image-mode Trainer loop, the whole trunk trained with remat:
    every loss finite, e_loss falls over 6 steps on a fixed batch."""
    tr = PT.Trainer(Config(**DIMS, freeze_phi=False, remat_resnet=True),
                    setup["smpl"], device="cpu")
    load_jax_variables(tr.state.hmmr, setup["trees"]["e"])
    load_jax_variables(tr.state.disc, setup["trees"]["d"])
    batch = setup["batch"]
    losses = []
    for _ in range(6):
        m = tr.step(batch)
        assert all(np.isfinite(float(v)) for v in m.values())
        losses.append(float(m["e_loss"]))
    assert tr.state.step == 6
    assert losses[-1] < losses[0], losses


def test_image_checkpoints_cross_packages(setup, tmp_path):
    """An image-mode port checkpoint read by the JAX load_checkpoint has the
    port's params and batch_stats and Adam moments for the ResNet; a tree
    the JAX save_checkpoint writes (other weights and statistics) is
    restored by the port's Trainer with equal params, batch_stats and Adam
    moments."""
    config = Config(**DIMS, freeze_phi=False, model_dir=str(tmp_path / "a"))
    tr = PT.Trainer(config, setup["smpl"], device="cpu")
    batch = setup["batch"]
    tr.step(batch)
    tree = jax_load(tr.save())
    want = export_jax_variables(tr.state.hmmr)
    for part in ("params", "batch_stats"):
        got, ref = flatten_tree(tree["params_e"][part]), flatten_tree(
            want[part])
        assert set(got) == set(ref)
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    assert "resnet_v2_50" in tree["opt_state_e"]["mu"]

    # JAX -> port: other statistics and weights, saved by the JAX package.
    rng = np.random.RandomState(9)
    def shift(node):
        if isinstance(node, dict):
            return {k: shift(v) for k, v in node.items()}
        return (node + rng.uniform(0.1, 0.2, node.shape)).astype(np.float32)

    changed = shift(tree["params_e"])
    tree = dict(tree, params_e=changed, step=np.int32(7))
    os.makedirs(tmp_path / "b")
    jax_save(str(tmp_path / "b" / "ckpt-7.npz"), tree)
    back = PT.Trainer(dataclasses.replace(config,
                                          model_dir=str(tmp_path / "b")),
                      setup["smpl"], device="cpu")
    assert back.state.step == 7
    got = export_jax_variables(back.state.hmmr)
    for part in ("params", "batch_stats"):
        ref = flatten_tree(changed[part])
        assert all(np.array_equal(flatten_tree(got[part])[k], ref[k])
                   for k in ref)
    name, p = next((n, p) for n, p in back.state.hmmr.named_parameters()
                   if n.startswith("resnet_v2_50.block2"))
    q = dict(tr.state.hmmr.named_parameters())[name]
    assert torch.equal(back.state.opt_e.state[p]["exp_avg"],
                       tr.state.opt_e.state[q]["exp_avg"])


def test_train_main_image_mode(setup, tmp_path):
    """train.main on raw_u8 image records on the CPU: 2 steps with the
    ResNet frozen (freeze_phi, the default) write ckpt-2.npz with the
    advanced moving averages; the pipeline augments on the device asked
    for; the trained Trainer's render_summary strip matches JAX's."""
    data = tmp_path / "data"
    _write_image_data(str(data), "raw_u8")
    smpl = synthetic_smpl_model(num_verts=NUM_VERTS, num_kps=25)
    smpl_path = str(tmp_path / "smpl.npz")
    np.savez(smpl_path, parents=np.array(smpl.parents),
             cocoplus_regressor=smpl.joint_regressor.numpy(),
             **{k: getattr(smpl, k).numpy() for k in (
                 "v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights")})
    model_dir = str(tmp_path / "run")
    trainer = train_main.main([
        "--data_dir", str(data), "--model_dir", model_dir,
        "--smpl_model_path", smpl_path, "--batch_size", "2", "--T", "8",
        "--img_size", "32", "--precomputed_phi", "false",
        "--feature_dim", str(DIMS["feature_dim"]), "--num_kps", "25",
        "--datasets", "insta_variety", "h36m", "--mocap_datasets", "CMU",
        "--use_fused_smpl", "--log_step", "1", "--device", "cpu",
        "--num_steps", "2"])
    assert trainer.state.step == 2
    assert not trainer.config.precomputed_phi
    tree = jax_load(os.path.join(model_dir, "ckpt-2.npz"))
    stats = flatten_tree(tree["params_e"]["batch_stats"])
    assert stats and all(np.isfinite(v).all() for v in stats.values())
    assert "resnet_v2_50" not in tree["opt_state_e"]["mu"]
    # The rendered summary (K1's plain version here, the fused SMPL decode
    # of --use_fused_smpl) against the JAX Trainer's on the trained
    # weights; the SMPL npz has no faces, so the panels are skeletons and
    # must match exactly.
    from human_dynamics_tpu.core.smpl import load_smpl_model
    from human_dynamics_tpu.utils.config import Config as JaxConfig
    from tests.test_torch_train import _jax_strip, assert_strips_match

    strip = trainer.render_summary(setup["batch"])
    want = _jax_strip(JaxConfig(**dataclasses.asdict(trainer.config)),
                      load_smpl_model(smpl_path),
                      export_jax_variables(trainer.state.hmmr),
                      _batch_arrays(Config(**DIMS)), None)
    assert strip.shape == (32, 32 * DIMS["T"], 3)
    assert_strips_match(strip, want, max_differ=0)


def test_image_mode_entry_points_default_to_cuda(tmp_path):
    """No fallback: without a CUDA device, build_models and the image
    pipeline with no device raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    from human_dynamics_tpu_torch.data.loader import TrainDataPipeline

    _write_image_data(str(tmp_path), "raw_u8")
    config = Config(**DIMS, data_dir=str(tmp_path),
                    datasets=("insta_variety", "h36m"),
                    mocap_datasets=("CMU",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.build_models(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainDataPipeline(config)
