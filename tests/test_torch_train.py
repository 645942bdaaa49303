"""The port's phi-mode training (human_dynamics_tpu_torch.train) against the
JAX package's, on the CPU at the JAX tests' tiny dims: Config(batch_size=2,
T=20, feature_dim=64, num_kps=19), a 32-vertex synthetic SMPL model. The
weights come from the JAX ``create_train_state`` (every bias and
GroupNorm scale randomised) through ``utils.weights``; the JAX fused SMPL
runs its Pallas kernel in interpret mode, the port's on its plain blend.

Tolerances:
- each loss function and the losses of ``compute_losses``: rtol 1e-5
  (float32 sums in another order);
- gradients of e_loss + d_loss, per parameter: max|port - JAX| <= 1e-4 *
  max|JAX| (relative to the parameter's largest gradient element);
- the discriminator's outputs and a port checkpoint in the JAX model:
  rtol 1e-5, atol 1e-5 (atol for outputs near zero);
- two Adam steps against optax's: the updates within rtol 1e-5 plus two
  float32 ulps of the updated parameter (the rounding of p + update);
- the data pipeline's batches and the bridge's JAX -> port -> JAX tree:
  equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.data import loader as JL
from human_dynamics_tpu.models.discriminator import (
    PoseDiscriminator as JaxDisc,
)
from human_dynamics_tpu.train import losses as JLoss
from human_dynamics_tpu.train import trainer as JT
from human_dynamics_tpu.utils.checkpoint import load_checkpoint as jax_load
from human_dynamics_tpu.utils.config import Config as JaxConfig
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.data import (
    TFRecordWriter,
    convert_to_example_temporal,
    encode_example,
)
from human_dynamics_tpu_torch.data import loader as PL
from human_dynamics_tpu_torch.eval.harness import load_model_variables
from human_dynamics_tpu_torch.models import HmmrModel
from human_dynamics_tpu_torch.models.discriminator import PoseDiscriminator
from human_dynamics_tpu_torch.models.ief import dropout
from human_dynamics_tpu_torch.train import losses as PLoss
from human_dynamics_tpu_torch.train import main as train_main
from human_dynamics_tpu_torch.train import trainer as PT
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.logging import MetricLogger
from human_dynamics_tpu_torch.utils.weights import (
    export_jax_variables,
    jax_to_port,
    load_jax_variables,
)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(batch_size=2, T=20, feature_dim=64, num_kps=19)
NUM_VERTS = 32
# render_summary strips with meshes: pixels that may differ from JAX's (a
# vertex 1e-6 away moves a triangle's edge across a pixel centre; measured
# 0). Skeleton-only strips must match exactly.
STRIP_DIFF_PIXELS = 64


def _randomise(tree, seed):
    """Every bias and GroupNorm scale of a flax tree randomised (numpy)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if path[-1].key in ("bias", "per_joint_b"):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _batch_arrays(config, seed=3):
    """A batch as numpy arrays (make_batch of tests/test_train.py, with the
    mocap pool in axis-angle, as the data pipeline gives it)."""
    rng = np.random.RandomState(seed)
    b, t = config.batch_size, config.T
    kps = rng.randn(b, t, config.num_kps, 3).astype(np.float32)
    kps[..., 2] = (rng.rand(b, t, config.num_kps) > 0.2).astype(np.float32)
    return dict(
        phis=rng.randn(b, t, config.feature_dim).astype(np.float32),
        kps=kps,
        poses_gt=(rng.randn(b, t, 24, 3) * 0.2).astype(np.float32),
        shapes_gt=(rng.randn(b, 10) * 0.3).astype(np.float32),
        joints_gt=rng.randn(b, t, 14, 3).astype(np.float32),
        has_3d_joints=np.array([1.0] * (b // 2) + [0.0] * (b - b // 2),
                               np.float32),
        has_3d_smpl=np.ones((b,), np.float32),
        poses_real=(rng.randn(PT.fake_pool_size(config), 24, 3)
                    * 0.2).astype(np.float32),
    )


def _port_batch(arrays):
    return PT.Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _port_state(config, variables_e, variables_d):
    state = PT.create_train_state(config, "cpu",
                                  torch.Generator().manual_seed(0))
    load_jax_variables(state.hmmr, variables_e)
    load_jax_variables(state.disc, variables_d)
    return state


def _port_losses_and_grads(config, state, smpl, batch):
    e, d, metrics = PT.compute_losses(config, state.hmmr, state.disc, smpl,
                                      batch, train=False)
    named = (list(state.hmmr.named_parameters())
             + list(state.disc.named_parameters()))
    grads = torch.autograd.grad(e + d, [p for _, p in named])
    hmmr_n = len(list(state.hmmr.parameters()))
    ge = {n: g for (n, _), g in zip(named[:hmmr_n], grads[:hmmr_n])}
    gd = {n: g for (n, _), g in zip(named[hmmr_n:], grads[hmmr_n:])}
    return {k: float(v.detach()) for k, v in metrics.items()}, ge, gd


@pytest.fixture(scope="module")
def setup():
    """JAX state (randomised), a batch, and the JAX losses and gradients
    of e_loss + d_loss, fused and unfused, from one jitted program."""
    jconfig = JaxConfig(**DIMS)
    state, hmmr, disc = JT.create_train_state(jconfig, jax.random.PRNGKey(0))
    params_e = _randomise(state.params_e, 1)
    params_d = _randomise(state.params_d, 2)
    smpl_j = jax_smpl(num_verts=NUM_VERTS, num_kps=DIMS["num_kps"])
    arrays = _batch_arrays(Config(**DIMS))
    jbatch = JT.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def both(pe, pd):
        out = {}
        for fused in (False, True):
            c = JaxConfig(**DIMS, use_fused_smpl=fused)

            def total(a, b):
                e, d, m = JT.compute_losses(
                    c, hmmr, disc, smpl_j, {"params": a}, {"params": b},
                    jbatch, train=False)
                return e + d, m

            out[fused] = jax.grad(total, argnums=(0, 1), has_aux=True)(
                pe, pd)
        return out

    res = jax.jit(both)(params_e["params"], params_d["params"])
    jax_out = {
        fused: ({k: float(v) for k, v in m.items()},
                jax.tree_util.tree_map(np.asarray, ge),
                jax.tree_util.tree_map(np.asarray, gd))
        for fused, ((ge, gd), m) in res.items()
    }
    return dict(
        state=state, hmmr=hmmr, disc=disc, params_e=params_e,
        params_d=params_d, arrays=arrays, jax_out=jax_out,
        smpl=synthetic_smpl_model(num_verts=NUM_VERTS,
                                  num_kps=DIMS["num_kps"]),
    )


# ---------------------------------------------------------------------------
# Loss functions
# ---------------------------------------------------------------------------


def _loss_cases():
    rng = np.random.RandomState(0)
    kp_gt = rng.randn(2, 3, 19, 3).astype(np.float32)
    kp_gt[..., 2] = rng.rand(2, 3, 19) > 0.3
    kp_pred = rng.randn(2, 3, 19, 2).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    a, b = (rng.randn(6, 9).astype(np.float32) for _ in range(2))
    j = [rng.randn(2, 3, 14, 3).astype(np.float32) for _ in range(2)]
    out = rng.randn(5, 24).astype(np.float32)
    shapes = rng.randn(2, 5, 10).astype(np.float32)
    return {
        "keypoint_l1": ("keypoint_l1_loss", (kp_gt, kp_pred)),
        "keypoint_l1_optcam": ("keypoint_l1_loss_optcam", (kp_gt, kp_pred)),
        "masked_mse": ("masked_mse", (a, b, mask)),
        "masked_mse_all_masked": ("masked_mse", (a, b, np.zeros(6,
                                                                np.float32))),
        "align_by_pelvis": ("align_by_pelvis", (j[0],)),
        "loss_3d": ("loss_3d", (a.reshape(6, 9), b.reshape(6, 9),
                                a[:, :5], b[:, :5], j[0], j[1], mask,
                                mask[::-1].copy())),
        "beta_smoothness": ("beta_smoothness_loss", (shapes,)),
        "shape_prior": ("shape_prior_loss", (shapes,)),
        "lsgan_encoder": ("lsgan_encoder_loss", (out,)),
        "lsgan_disc_fake": ("lsgan_disc_fake_loss", (out,)),
        "lsgan_disc_real": ("lsgan_disc_real_loss", (out,)),
        "hallucinator_mse": ("hallucinator_mse", (shapes, shapes[::-1].copy())),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_functions_match_jax(case):
    """Every loss of train/losses.py, with TF's SUM_BY_NONZERO_WEIGHTS
    reduction (an all-masked loss is 0)."""
    name, args = _loss_cases()[case]
    want = getattr(JLoss, name)(*[jnp.asarray(x) for x in args])
    got = getattr(PLoss, name)(*[torch.from_numpy(x) for x in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_RTOL,
                                   atol=1e-6)
    if case == "masked_mse_all_masked":
        assert float(got[0]) == 0.0


def test_discriminator_matches_jax():
    """PoseDiscriminator with flax-initialised weights (biases randomised)
    gives the flax outputs, (N, 24)."""
    disc = JaxDisc()
    x = np.random.RandomState(4).randn(7, 23, 9).astype(np.float32)
    variables = _randomise(jax.jit(disc.init)(jax.random.PRNGKey(5),
                                              jnp.asarray(x)), 6)
    port = PoseDiscriminator(device="meta").to_empty(device="cpu")
    load_jax_variables(port, variables)
    got = port(torch.from_numpy(x).reshape(7, 23, 3, 3))
    assert got.shape == (7, 24)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(disc.apply(variables, x)),
                               **OUT_TOL)


def test_weights_roundtrip_is_identity(setup):
    """JAX create_train_state tree -> port -> JAX layout is the identity
    (params_e and params_d, every leaf equal)."""
    config = Config(**DIMS)
    st = _port_state(config, setup["params_e"], setup["params_d"])
    for port, tree in ((st.hmmr, setup["params_e"]),
                       (st.disc, setup["params_d"])):
        back = export_jax_variables(port)
        want = jax.tree_util.tree_leaves_with_path(tree)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], np.asarray(leaf))


# ---------------------------------------------------------------------------
# The objective and its gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_results(setup):
    out = {}
    for fused in (False, True):
        config = Config(**DIMS, use_fused_smpl=fused)
        st = _port_state(config, setup["params_e"], setup["params_d"])
        out[fused] = (st,) + _port_losses_and_grads(
            config, st, setup["smpl"], _port_batch(setup["arrays"]))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_compute_losses_match_jax(setup, port_results, fused):
    """compute_losses(train=False): the same keys, every loss within
    rtol 1e-5."""
    want = setup["jax_out"][fused][0]
    got = port_results[fused][1]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_gradients_match_jax(setup, port_results, fused):
    """d(e_loss + d_loss)/d(every parameter) against jax.grad."""
    _, ge_j, gd_j = setup["jax_out"][fused]
    st, _, ge, gd = port_results[fused]
    for module, want_tree, got in ((st.hmmr, ge_j, ge),
                                   (st.disc, gd_j, gd)):
        want = jax_to_port(module, {"params": want_tree}, list(got))
        for name, g in got.items():
            w = want[name].numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= GRAD_REL * np.abs(w).max(), (
                f"{name}: {err} vs {GRAD_REL} * {np.abs(w).max()}")


def test_adam_update_matches_optax(setup, port_results):
    """Two Adam steps on the JAX gradients (and 0.5x them) against
    optax.adam(e_lr) on the same parameters and gradients."""
    config = Config(**DIMS)
    st = _port_state(config, setup["params_e"], setup["params_d"])
    _, ge_j, _ = setup["jax_out"][False]
    names = list(port_results[False][2])
    params0 = {n: p.detach().clone() for n, p in st.hmmr.named_parameters()}
    opt, _ = PT.make_optimizers(config, st.hmmr.parameters(),
                                st.disc.parameters())
    tx = optax.adam(config.e_lr, b1=0.9, b2=0.999, eps=1e-8)
    jparams = setup["params_e"]["params"]

    @jax.jit
    def optax_steps(p, g):
        s = tx.init(p)
        for scale in (1.0, 0.5):
            u, s = tx.update(jax.tree_util.tree_map(lambda x: scale * x, g),
                             s, p)
            p = optax.apply_updates(p, u)
        return p

    want = jax_to_port(st.hmmr, {"params": optax_steps(jparams, ge_j)},
                       names)
    grads = jax_to_port(st.hmmr, {"params": ge_j}, names)
    named = dict(st.hmmr.named_parameters())
    for scale in (1.0, 0.5):
        for n in names:
            named[n].grad = scale * grads[n]
        opt.step()
    for n in names:
        new = named[n].detach().numpy()
        got = new - params0[n].numpy()
        w = want[n].numpy() - params0[n].numpy()
        # The updates agree to 1e-5 (optax's bias correction in float32
        # is 8.3e-6 from torch's), up to the rounding of the parameters
        # they are added to (two float32 ulps, before or after).
        ulp = np.maximum(np.spacing(np.abs(new)),
                         np.spacing(np.abs(params0[n].numpy())))
        bound = 1e-5 * np.abs(w) + 2 * ulp
        assert (np.abs(got - w) <= bound).all(), n


def test_gan_gradient_isolation(setup):
    """With every encoder weight zero the total is d_pose: the encoder's
    gradients are exactly zero (the fakes are detached), the
    discriminator's are not; with only e_pose on, the discriminator's are
    exactly zero (the frozen critic)."""
    off = dict(e_lw_kp=0, e_lw_joints=0, e_lw_smpl=0, e_lw_const=0,
               e_lw_shape=0, e_lw_hallucinate=0)
    batch = _port_batch(setup["arrays"])
    for weights, zero, nonzero in (
            (dict(off, e_lw_pose=0), 1, 2),
            (dict(off, d_lw_pose=0), 2, 1)):
        config = Config(**DIMS, **weights)
        st = _port_state(config, setup["params_e"], setup["params_d"])
        res = _port_losses_and_grads(config, st, setup["smpl"], batch)
        assert all(float(g.abs().max()) == 0.0 for g in res[zero].values())
        assert any(float(g.abs().max()) > 0.0 for g in res[nonzero].values())


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


def _trainer(setup, **kw):
    config = Config(**DIMS, **kw)
    tr = PT.Trainer(config, setup["smpl"], device="cpu")
    if not tr.state.step:
        load_jax_variables(tr.state.hmmr, setup["params_e"])
        load_jax_variables(tr.state.disc, setup["params_d"])
    return tr


def test_train_step_updates_and_learns(setup):
    """A step moves the parameters; on a fixed batch e_loss falls within
    9 steps, every loss finite."""
    tr = _trainer(setup)
    batch = _port_batch(setup["arrays"])
    before = tr.state.hmmr.mean_param.detach().clone()
    losses = [float(tr.step(batch)["e_loss"])]
    assert tr.state.step == 1
    assert not torch.equal(before, tr.state.hmmr.mean_param)
    for _ in range(8):
        m = tr.step(batch)
        assert all(np.isfinite(float(v)) for v in m.values())
        losses.append(float(m["e_loss"]))
    assert losses[-1] < losses[0], losses


def test_bf16_training_step_close_to_fp32(setup):
    """use_bfloat16: losses within 5% of fp32 on the first step, fp32
    parameters and moments, and training continues and moves them."""
    batch = _port_batch(setup["arrays"])
    t32, t16 = _trainer(setup), _trainer(setup, use_bfloat16=True)
    m32, m16 = t32.step(batch), t16.step(batch)
    for k in ("e_loss", "d_loss"):
        np.testing.assert_allclose(float(m16[k]), float(m32[k]), rtol=0.05)
    for opt in (t16.state.opt_e, t16.state.opt_d):
        for p in opt.param_groups[0]["params"]:
            assert p.dtype == torch.float32
            assert opt.state[p]["exp_avg"].dtype == torch.float32
    before = t16.state.hmmr.mean_param.detach().clone()
    for _ in range(3):
        m16 = t16.step(batch)
    assert np.isfinite(float(m16["e_loss"]))
    assert not torch.equal(before, t16.state.hmmr.mean_param)


def test_checkpoint_resume_continues_exactly(setup, tmp_path):
    """A full checkpoint (params + Adam moments) restores into a fresh
    Trainer, which then takes the same steps as the uninterrupted one
    (dropout is seeded by the step); a params-only checkpoint restores
    the weights and the step and resets the moments."""
    batch = _port_batch(setup["arrays"])
    tr = _trainer(setup, model_dir=str(tmp_path / "full"))
    for _ in range(2):
        tr.step(batch)
    assert tr.save().endswith("ckpt-2.npz")
    resumed = _trainer(setup, model_dir=str(tmp_path / "full"))
    assert resumed.state.step == 2
    for a, b in zip(tr.state.opt_e.param_groups[0]["params"],
                    resumed.state.opt_e.param_groups[0]["params"]):
        assert torch.equal(tr.state.opt_e.state[a]["exp_avg_sq"],
                           resumed.state.opt_e.state[b]["exp_avg_sq"])
    for _ in range(2):
        want, got = tr.step(batch), resumed.step(batch)
        assert float(got["e_loss"]) == float(want["e_loss"])

    slim = _trainer(setup, model_dir=str(tmp_path / "slim"),
                    save_params_only=True)
    slim.step(batch)
    slim.step(batch)
    path = slim.save()
    keys = set(np.load(path).files)
    assert any(k.startswith("params_e::") for k in keys)
    assert not any(k.startswith("opt_state") for k in keys)
    again = _trainer(setup, model_dir=str(tmp_path / "slim"),
                     save_params_only=True)
    assert again.state.step == 2 and not again.state.opt_e.state
    for (_, a), (_, b) in zip(slim.state.hmmr.named_parameters(),
                              again.state.hmmr.named_parameters()):
        assert torch.equal(a, b)
    assert np.isfinite(float(again.step(batch)["e_loss"]))


def test_port_checkpoint_runs_in_the_jax_model(setup, tmp_path):
    """A port Trainer checkpoint, read by the JAX load_checkpoint, drives
    the JAX HmmrModel to the port model's outputs; its Adam state is
    optax's layout (mu/nu as the params tree, count)."""
    tr = _trainer(setup, model_dir=str(tmp_path))
    batch = _port_batch(setup["arrays"])
    tr.step(batch)
    tree = jax_load(tr.save())
    assert int(tree["step"]) == 1
    assert int(tree["opt_state_e"]["count"]) == 1
    assert (jax.tree_util.tree_structure(tree["opt_state_e"]["mu"])
            == jax.tree_util.tree_structure(tree["params_e"]["params"]))
    want = setup["hmmr"].apply(tree["params_e"], setup["arrays"]["phis"])
    with torch.no_grad():
        got = tr.state.hmmr(batch.phis)
    np.testing.assert_allclose(got.omega_pred.numpy(),
                               np.asarray(want.omega_pred), **OUT_TOL)
    np.testing.assert_allclose(got.omegas_delta[5].numpy(),
                               np.asarray(want.omegas_delta[5]), **OUT_TOL)
    np.testing.assert_allclose(
        tr.state.disc(torch.zeros(3, 23, 9)).detach().numpy(),
        np.asarray(setup["disc"].apply(tree["params_d"],
                                       jnp.zeros((3, 23, 9)))), **OUT_TOL)


def test_dropout_masks():
    """The IEF dropout: keep rate 0.5 +- 0.02 over a large mask, kept
    values scaled by 2, the same seed giving the same masks, and
    train=True refused without a generator."""
    x = torch.ones(256, 1024)
    a = dropout(x, 0.5, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, torch.Generator().manual_seed(7))
    c = dropout(x, 0.5, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs(float((a != 0).float().mean()) - 0.5) < 0.02
    model = HmmrModel(feature_dim=64, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(1, 20, 64), train=True)


def _jax_strip(jconfig, smpl_j, params_e, arrays, max_frames):
    """The JAX Trainer's render_summary strip on the given variables (the
    method on a stand-in Trainer: it reads only these attributes)."""
    from types import SimpleNamespace

    trainer = SimpleNamespace(
        config=jconfig, smpl=smpl_j, hmmr=JT.build_models(jconfig)[0],
        state=SimpleNamespace(params_e=params_e))
    batch = JT.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return JT.Trainer.render_summary(trainer, batch, max_frames)


def assert_strips_match(got, want, max_differ=STRIP_DIFF_PIXELS):
    """Two render_summary strips: the same shape, uint8, and at most
    ``max_differ`` pixels apart."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differ = int(np.any(got != want, axis=-1).sum())
    print(f"render_summary strip {got.shape}: {differ} pixels differ")
    assert differ <= max_differ, differ


def test_histogram_summary_and_render(setup, tmp_path):
    """Beta and the 24 discriminator-output histograms land in the logger;
    render_summary's strip equals the JAX Trainer's on the same weights
    (see STRIP_DIFF_PIXELS)."""
    import csv

    logger = MetricLogger(str(tmp_path), use_tensorboard=False)
    tr = PT.Trainer(Config(**DIMS), setup["smpl"], logger=logger,
                    device="cpu")
    tr.histogram_summary(_port_batch(setup["arrays"]))
    logger.close()
    with open(tmp_path / "histograms.csv") as f:
        tags = {r["tag"] for r in csv.DictReader(f)}
    assert {"betas", "betas_hal", "poses_out/all",
            "poses_out/Left_Finger"} <= tags
    assert len([t for t in tags if t.startswith("poses_out/")]) == 24
    batch = _port_batch(setup["arrays"])
    strip = tr.render_summary(batch, max_frames=4)
    want = _jax_strip(JaxConfig(**DIMS),
                      jax_smpl(num_verts=NUM_VERTS, num_kps=DIMS["num_kps"]),
                      export_jax_variables(tr.state.hmmr), setup["arrays"],
                      4)
    assert strip.shape == want.shape == (224, 224 * 4, 3)
    assert strip.dtype == np.uint8 and strip.min() < 255
    assert_strips_match(strip, want)


def test_config_matches_jax(tmp_path):
    """The port's Config has the JAX Config's fields and defaults; each
    package reads the other's params.json."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(Config)}
    assert pf == jf
    c = Config(batch_size=3, delta_t_values=(-2, 2), model_dir=str(tmp_path))
    path = c.save()
    with open(path) as f:
        j = JaxConfig.from_json(f.read())
    assert dataclasses.asdict(j) == dataclasses.asdict(c)
    assert Config.from_json(j.to_json()) == c
    assert c.check_resume_config(Config()) == ["batch_size",
                                               "delta_t_values"]


# ---------------------------------------------------------------------------
# Data pipeline and the CLI
# ---------------------------------------------------------------------------


def _write_train_data(root, feature_dim, n_frames=(30, 12, 25)):
    """Phi records for a 2-D and a 3-D dataset, and mocap records."""
    rng = np.random.RandomState(11)
    for ds in ("insta_variety", "h36m"):
        d = os.path.join(root, ds, "train")
        os.makedirs(d)
        for shard in range(2):
            with TFRecordWriter(os.path.join(d, f"s{shard}.tfrecord")) as w:
                for n in n_frames:
                    labels = rng.rand(n, 3, 25).astype(np.float32)
                    labels[:, 2] = rng.rand(n, 25) > 0.2
                    w.write(convert_to_example_temporal(
                        image_datas=None,
                        image_paths=[f"f{i}.png" for i in range(n)],
                        image_shapes=np.full((n, 2), 224),
                        labels=labels,
                        centers=rng.randint(0, 224, (n, 2)),
                        gt3ds=rng.randn(n, 14, 3).astype(np.float32),
                        scale_factors=rng.rand(n, 2).astype(np.float32),
                        start_pts=rng.randint(0, 50, (n, 2)),
                        cams=rng.rand(n, 3).astype(np.float32),
                        poses=rng.randn(n, 72).astype(np.float32) * 0.2,
                        shape=rng.randn(10).astype(np.float32) * 0.3,
                        phis=rng.randn(n, feature_dim).astype(np.float32),
                    ))
    d = os.path.join(root, "mocap_neutrMosh")
    os.makedirs(d)
    with TFRecordWriter(os.path.join(d, "neutrSMPL_CMU_0.tfrecord")) as w:
        for _ in range(150):
            w.write(encode_example({
                "pose": rng.randn(72).astype(np.float32) * 0.2,
                "shape": rng.randn(10).astype(np.float32) * 0.3,
            }))


def test_data_pipeline_matches_jax(tmp_path):
    """The port's TrainDataPipeline yields the JAX pipeline's batches, equal
    array for array, for the same records and seed (3 batches)."""
    _write_train_data(str(tmp_path), DIMS["feature_dim"])
    kw = dict(DIMS, data_dir=str(tmp_path), datasets=("insta_variety",
                                                      "h36m"), seed=5)
    jp = JL.TrainDataPipeline(JaxConfig(**kw))
    pp = PL.TrainDataPipeline(Config(**kw))
    try:
        for want, got in zip([b for b, _ in zip(jp, range(3))],
                             [b for b, _ in zip(pp, range(3))]):
            for field, w, g in zip(want._fields, want, got):
                assert g.dtype == np.asarray(w).dtype, field
                assert np.array_equal(g, np.asarray(w)), field
    finally:
        jp.close()
        pp.close()
    # These records carry phis and no frames: image mode refuses them.
    with pytest.raises(ValueError, match="without frames"):
        next(iter(PL.ExampleStream(PL.get_all_files(str(tmp_path), ["h36m"]),
                                   20, decode_images=True)))


def test_train_main_writes_a_checkpoint_the_port_reads(tmp_path):
    """train.main on the CPU for 2 steps writes params.json and
    ckpt-2.npz; eval.harness.load_model_variables reads it into an
    HmmrModel that gives the trainer's outputs."""
    data = tmp_path / "data"
    _write_train_data(str(data), DIMS["feature_dim"])
    smpl = synthetic_smpl_model(num_verts=NUM_VERTS, num_kps=25)
    smpl_path = str(tmp_path / "smpl.npz")
    np.savez(smpl_path, parents=np.array(smpl.parents),
             cocoplus_regressor=smpl.joint_regressor.numpy(),
             **{k: getattr(smpl, k).numpy() for k in (
                 "v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights")})
    model_dir = str(tmp_path / "run")
    args = ["--data_dir", str(data), "--model_dir", model_dir,
            "--smpl_model_path", smpl_path, "--batch_size", "2",
            "--feature_dim", str(DIMS["feature_dim"]), "--num_kps", "25",
            "--datasets", "insta_variety", "h36m", "--use_fused_smpl",
            "--log_step", "1", "--device", "cpu", "--num_steps", "2"]
    trainer = train_main.main(args)
    assert trainer.state.step == 2
    with open(os.path.join(model_dir, "params.json")) as f:
        assert json.load(f)["use_fused_smpl"] is True
    variables = load_model_variables(os.path.join(model_dir, "ckpt-2.npz"))
    model = HmmrModel(feature_dim=DIMS["feature_dim"], device="meta")
    model = load_jax_variables(model.to_empty(device="cpu"), variables)
    x = torch.randn(1, 20, DIMS["feature_dim"])
    with torch.no_grad():
        np.testing.assert_array_equal(
            model(x).omega_pred.numpy(),
            trainer.state.hmmr(x).omega_pred.numpy())
