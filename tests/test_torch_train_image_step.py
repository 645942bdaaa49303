"""The port's image-mode training step (Config(precomputed_phi=False))
against the JAX package's, on the CPU.

Sizes: 2 tubes of T=8 frames of 32x32, every head (present, +-5, the
hallucinator), a 32-vertex synthetic SMPL model, and a narrow trunk of the
ResNet-50 v2 layout (blocks (2, 32, 8), (2, 48, 12), (1, 64, 16); phi 64)
in both packages: each package's HmmrModel builds its ResNetV2_50 by name,
and this module hands both the narrow blocks. The full-depth trunk is held
to JAX in tests/test_torch_train_image.py. Weights come from the port's
init, biases and BatchNorm parameters and statistics randomised, carried to
JAX by utils.weights. The step's dropout is off in both packages (the
heads evaluated with train=False), so that the train-mode BatchNorm and its
statistics are compared on the same numbers. The JAX programs are compiled
with XLA's backend optimisation level 0, which halves their compile time.

The data-parallel step (Trainer(mesh=), two gloo ranks as subprocesses,
tests/torch_mesh_worker.py) is held to the same JAX step on the global
batch, at the same tolerances: JAX's step on a 2-device mesh computes it
too (tests/test_image_mode_training.py holds the two together), and its
programs would double this file's compile time. Each rank holds one tube,
so every train-mode BatchNorm normalises with statistics of both ranks'
frames. With one rank, the mesh step is the single-process step exactly.

Tolerances:
- fp32 losses: rtol 1e-5 (float32 sums in another order);
- fp32 gradients, per parameter: max|port - JAX| <= 1e-4 * max|JAX| +
  1e-6 (the phi-mode test's bound; the 1e-6 floor is for gradients that
  are zero in exact arithmetic and come out as rounding noise of ~1e-7:
  the ResNet's conv biases reach the loss only through train-mode
  BatchNorms, which remove any per-channel constant);
- the updated moving averages: rtol 1e-5, atol 1e-6 (they take the batch
  statistics at 0.003); in bf16, as the gradients: the largest difference
  of each port tensor from JAX's fp32 update at most twice JAX's bf16
  one, plus 1e-5 (the batch statistics of a bf16 forward move by a few
  percent at this size, in both packages);
- bf16 losses: rtol 2e-3, atol 1e-5 against JAX's bf16 step (the losses
  are fp32 on bf16 outputs; a bf16 ulp is 2^-8 relative, and the two
  packages round at other places: XLA's fusions once, torch per op; the
  atol is for the small losses made of differences of outputs, e_const
  ~5e-4, where an ulp of the outputs is a larger share);
- bf16 gradients: at this size a bf16 backward lands 5-50% (relative L2)
  from the fp32 gradient in both packages, so each parameter's port bf16
  gradient is held to at most twice JAX's bf16 distance from JAX's fp32
  gradient, plus 1e-3;
- bf16 with freeze_bn_stats, where flax promotes the trunk after the root
  conv to fp32 (the moving statistics are fp32): the losses within rtol
  2e-5, atol 1e-5 of JAX's bf16 step (the port measured 2.2e-6 on e_loss;
  with its trunk left in bf16 it was 1.0e-4, and 1.3e-4 on e_kp); the
  gradients by the bf16 rule above applied to each model's whole gradient
  as one vector (the port 0.00778 from fp32, JAX 0.00776), not tensor by
  tensor: the only bf16 roundings left are the root conv's output and the
  gradients, and the narrow trunk's last unit, at 2x2 pixels, sits behind
  a few ReLUs whose sign such a rounding flips (its conv1 gradient: the
  port 0.178 from fp32, JAX 0.074, the port 0.153 from JAX's bf16).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.models import hmmr as JH
from human_dynamics_tpu.models import resnet as JR
from human_dynamics_tpu.train import trainer as JT
from human_dynamics_tpu.utils.checkpoint import flatten_tree
from human_dynamics_tpu.utils.config import Config as JaxConfig
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.models import hmmr as PH
from human_dynamics_tpu_torch.models import resnet as PR
from human_dynamics_tpu_torch.train import trainer as PT
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.weights import (
    export_jax_variables,
    jax_to_port,
    load_jax_variables,
    variable_map,
)
from tests.test_torch_train_image import NARROW, randomise
from tests.torch_mesh_worker import run_group

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-6
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_STATS_FLOOR = 1e-5
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 2e-3, 1e-5
BF16_GRAD_FACTOR, BF16_GRAD_FLOOR = 2.0, 1e-3
FREEZE_BF16_LOSS_RTOL = 2e-5
# XLA's backend optimisation level for the JAX programs.
FAST_COMPILE = {"xla_backend_optimization_level": 0}
DIMS = dict(batch_size=2, T=8, img_size=32, precomputed_phi=False,
            feature_dim=NARROW[-1][1], num_kps=25)
NUM_VERTS = 32


@pytest.fixture(scope="module", autouse=True)
def narrow_resnet():
    """Both packages' HmmrModel build the narrow trunk."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JH, "ResNetV2_50",
                   functools.partial(JR.ResNetV2_50, blocks=NARROW))
        mp.setattr(PH, "ResNetV2_50",
                   functools.partial(PR.ResNetV2_50, blocks=NARROW))
        yield


class _JaxHeadsWithoutDropout(JH.HmmrModel):
    """The JAX model with train-mode BatchNorm but no dropout."""

    def _pred_heads(self, features, train, with_deltas):
        return super()._pred_heads(features, False, with_deltas)


def _without_dropout(hmmr):
    """The port model's heads evaluated without dropout, train or not."""
    heads = hmmr._pred_heads
    hmmr._pred_heads = lambda f, with_deltas, train, g: heads(
        f, with_deltas, False, None)
    return hmmr


def _batch_arrays(config, seed=3):
    rng = np.random.RandomState(seed)
    b, t, s = config.batch_size, config.T, config.img_size
    kps = rng.randn(b, t, config.num_kps, 3).astype(np.float32)
    kps[..., 2] = (rng.rand(b, t, config.num_kps) > 0.2).astype(np.float32)
    return dict(
        phis=rng.uniform(-1, 1, (b, t, s, s, 3)).astype(np.float32),
        kps=kps,
        poses_gt=(rng.randn(b, t, 24, 3) * 0.2).astype(np.float32),
        shapes_gt=(rng.randn(b, 10) * 0.3).astype(np.float32),
        joints_gt=rng.randn(b, t, 14, 3).astype(np.float32),
        has_3d_joints=np.array([1.0, 0.0], np.float32),
        has_3d_smpl=np.ones((b,), np.float32),
        poses_real=(rng.randn(PT.fake_pool_size(config), 24, 3)
                    * 0.2).astype(np.float32),
    )


def _port_batch(arrays):
    return PT.Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _port_state(config, trees):
    state = PT.create_train_state(config, "cpu",
                                  torch.Generator().manual_seed(0))
    load_jax_variables(state.hmmr, trees["e"])
    load_jax_variables(state.disc, trees["d"])
    return state


@pytest.fixture(scope="module")
def setup(narrow_resnet):
    """Randomised weights, a batch, and the JAX losses, gradients and
    updated statistics of one train-mode step in fp32 and in bf16, with
    batch statistics and with ``freeze_bn_stats``."""
    config = Config(**DIMS)
    state = PT.create_train_state(config, "cpu",
                                  torch.Generator().manual_seed(1))
    trees = {"e": randomise(export_jax_variables(state.hmmr), 2),
             "d": randomise(export_jax_variables(state.disc), 3)}
    arrays = _batch_arrays(config)
    jbatch = JT.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    smpl_j = jax_smpl(num_verts=NUM_VERTS, num_kps=DIMS["num_kps"])
    hmmr, disc = JT.build_models(JaxConfig(**DIMS))
    hmmr = _JaxHeadsWithoutDropout(**{
        f.name: getattr(hmmr, f.name) for f in dataclasses.fields(hmmr)
        if f.init and f.name not in ("parent", "name")})

    args = (trees["e"]["params"], trees["d"]["params"])
    jax_out = {}
    for bf16, freeze_bn in ((False, False), (True, False), (False, True),
                            (True, True)):
        c = JaxConfig(**DIMS, use_bfloat16=bf16, freeze_bn_stats=freeze_bn)
        model = dataclasses.replace(hmmr, freeze_bn_stats=freeze_bn)

        def total(a, b, c=c, model=model):
            e, d, m = JT.compute_losses(
                c, model, disc, smpl_j,
                {"params": a, "batch_stats": trees["e"]["batch_stats"]},
                {"params": b}, jbatch, train=True)
            return e + d, m

        step = jax.jit(jax.grad(total, argnums=(0, 1), has_aux=True))
        (ge, gd), m = step.lower(*args).compile(FAST_COMPILE)(*args)
        stats = m.pop("_new_batch_stats")
        jax_out[bf16, freeze_bn] = dict(
            losses={k: float(v) for k, v in m.items()},
            ge=jax.tree_util.tree_map(np.asarray, ge),
            gd=jax.tree_util.tree_map(np.asarray, gd),
            stats=flatten_tree(jax.tree_util.tree_map(np.asarray, stats)))
    return dict(trees=trees, arrays=arrays, jax_out=jax_out,
                smpl=synthetic_smpl_model(num_verts=NUM_VERTS,
                                          num_kps=DIMS["num_kps"]))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_grads(module, jax_out, got, bf16, part, freeze_bn=False):
    names = list(got)
    tree = lambda k: jax_to_port(module, {"params": jax_out[k, freeze_bn][
        part]}, names, strict=False)
    want32 = tree(False)
    want16 = tree(True) if bf16 else None
    if bf16 and freeze_bn:
        # The module's whole gradient as one vector (see the docstring).
        flat = lambda d: np.concatenate([np.asarray(d[n]).ravel()
                                         for n in names])
        w = flat(want32)
        jax_dist = _rel_l2(flat(want16), w)
        dist = _rel_l2(flat({n: g.numpy() for n, g in got.items()}), w)
        assert dist <= BF16_GRAD_FACTOR * jax_dist + BF16_GRAD_FLOOR, (
            f"{part}: port bf16 {dist} from fp32, JAX bf16 {jax_dist}")
        return
    for name, g in got.items():
        g, w = g.numpy(), want32[name].numpy()
        if bf16:
            jax_dist = _rel_l2(want16[name].numpy(), w)
            dist = _rel_l2(g, w)
            assert dist <= BF16_GRAD_FACTOR * jax_dist + BF16_GRAD_FLOOR, (
                f"{name}: port bf16 {dist} from fp32, JAX bf16 {jax_dist}")
        else:
            err = float(np.abs(g - w).max())
            assert err <= GRAD_REL * np.abs(w).max() + GRAD_ATOL, (
                f"{name}: {err} vs {GRAD_REL} * {np.abs(w).max()}")


def _check_against_jax(setup, metrics, ge, gd, got_stats, bf16,
                       freeze_bn=False):
    """Losses, gradients (by port name, of the HMMR model and the
    discriminator) and the moving averages (by flax path) of one step
    against JAX's."""
    want = setup["jax_out"][bf16, freeze_bn]
    assert set(metrics) == set(want["losses"])
    tol = (dict(rtol=LOSS_RTOL) if not bf16 else
           dict(rtol=FREEZE_BF16_LOSS_RTOL, atol=BF16_LOSS_ATOL) if freeze_bn
           else dict(rtol=BF16_LOSS_RTOL, atol=BF16_LOSS_ATOL))
    for k, w in want["losses"].items():
        np.testing.assert_allclose(float(metrics[k]), w, err_msg=k, **tol)
    hmmr = _port_state(Config(**DIMS), setup["trees"])
    _check_grads(hmmr.hmmr, setup["jax_out"], ge, bf16, "ge", freeze_bn)
    _check_grads(hmmr.disc, setup["jax_out"], gd, bf16, "gd", freeze_bn)
    assert set(got_stats) == set(want["stats"])
    stats32 = setup["jax_out"][False, freeze_bn]["stats"]
    for k, w in want["stats"].items():
        if bf16:
            jax_dist = np.abs(w - stats32[k]).max()
            dist = np.abs(got_stats[k] - stats32[k]).max()
            assert dist <= BF16_GRAD_FACTOR * jax_dist + BF16_STATS_FLOOR, (
                k, dist, jax_dist)
        else:
            np.testing.assert_allclose(got_stats[k], w, err_msg=k,
                                       **STATS_TOL)


@pytest.mark.parametrize("freeze_phi,bf16,freeze_bn", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (False, True, True)],
    ids=["unfrozen", "freeze_phi", "unfrozen_bf16", "freeze_bn_stats",
         "freeze_bn_stats_bf16"])
def test_compute_losses_match_jax(setup, freeze_phi, bf16, freeze_bn):
    """compute_losses(train=True) in image mode: every loss, the gradient
    of every trainable parameter (with freeze_phi no ResNet parameter takes
    one) and every updated moving average against JAX's step. With
    freeze_bn_stats in bf16 the trunk after the root conv computes in fp32,
    as flax promotes it."""
    config = Config(**DIMS, freeze_phi=freeze_phi, use_bfloat16=bf16,
                    freeze_bn_stats=freeze_bn)
    st = _port_state(config, setup["trees"])
    _without_dropout(st.hmmr)
    e, d, metrics = PT.compute_losses(config, st.hmmr, st.disc,
                                      setup["smpl"],
                                      _port_batch(setup["arrays"]),
                                      train=True)
    named_e = [(n, p) for n, p in st.hmmr.named_parameters()
               if p.requires_grad]
    named_d = list(st.disc.named_parameters())
    grads = torch.autograd.grad(e + d, [p for _, p in named_e + named_d])
    ge = {n: g for (n, _), g in zip(named_e, grads)}
    gd = {n: g for (n, _), g in zip(named_d, grads[len(named_e):])}
    n_resnet = sum(n.startswith("resnet_v2_50.") for n in ge)
    assert n_resnet == (0 if freeze_phi else
                        len(list(st.hmmr.resnet_v2_50.parameters())))
    _check_against_jax(
        setup, {k: v.detach() for k, v in metrics.items()}, ge, gd,
        flatten_tree(export_jax_variables(st.hmmr)["batch_stats"]), bf16,
        freeze_bn)


def test_freeze_bn_stats_uses_moving_statistics(setup):
    """freeze_bn_stats: the ResNet normalises with its moving averages in the
    step, which leaves them as they were."""
    config = Config(**DIMS, freeze_bn_stats=True)
    st = _port_state(config, setup["trees"])
    before = {k: v.clone() for k, v in st.hmmr.named_buffers()}
    images = torch.from_numpy(setup["arrays"]["phis"])
    PT.compute_losses(config, st.hmmr, st.disc, setup["smpl"],
                      _port_batch(setup["arrays"]), train=True,
                      generator=torch.Generator().manual_seed(0))
    for k, v in st.hmmr.named_buffers():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        want = st.hmmr.encode_images(images, train=False)
        got = st.hmmr.encode_images(images, train=True)
    assert torch.equal(got, want)


def _flax_keys(module, names):
    vm = variable_map(module)
    return {"/".join(vm[n][0][1:]) for n in names}


@pytest.mark.parametrize("kw", [dict(freeze_phi=True),
                                dict(freeze_phi=False,
                                     freeze_resnet_stages=2)],
                         ids=["freeze_phi", "stages2"])
def test_split_frozen_params_matches_jax(setup, kw):
    """The frozen set is JAX's, by flax path; a Trainer step leaves every
    frozen tensor unchanged, gives it no Adam state, and moves the
    trainable ones and the moving averages of every unit."""
    config = Config(**DIMS, **kw)
    jtrain, jfrozen = JT.split_frozen_params(JaxConfig(**DIMS, **kw),
                                             setup["trees"]["e"]["params"])
    tr = PT.Trainer(config, setup["smpl"], device="cpu")
    load_jax_variables(tr.state.hmmr, setup["trees"]["e"])
    load_jax_variables(tr.state.disc, setup["trees"]["d"])
    trainable, frozen = PT.split_frozen_params(
        config, dict(tr.state.hmmr.named_parameters()))
    assert _flax_keys(tr.state.hmmr, frozen) == {
        k.replace("::", "/") for k in flatten_tree(jfrozen)}
    assert _flax_keys(tr.state.hmmr, trainable) == {
        k.replace("::", "/") for k in flatten_tree(jtrain)}

    before = {n: p.detach().clone()
              for n, p in tr.state.hmmr.named_parameters()}
    stats = {n: b.clone() for n, b in tr.state.hmmr.named_buffers()}
    m = tr.step(_port_batch(setup["arrays"]))
    assert all(np.isfinite(float(v)) for v in m.values())
    stepped = {id(p) for p in tr.state.opt_e.state}
    for n, p in tr.state.hmmr.named_parameters():
        if n in frozen:
            assert torch.equal(p, before[n]) and id(p) not in stepped, n
            assert not p.requires_grad and p.grad is None, n
        else:
            assert id(p) in stepped, n
    assert not torch.equal(tr.state.hmmr.mean_param, before["mean_param"])
    moved = [n for n, b in tr.state.hmmr.named_buffers()
             if not torch.equal(b, stats[n])]
    assert len(moved) == len(stats)


# ---------------------------------------------------------------------------
# The data-parallel step
# ---------------------------------------------------------------------------

_DP_CASES = {
    "unfrozen": dict(freeze_phi=False),
    "freeze_phi": dict(freeze_phi=True),
    "unfrozen_bf16": dict(freeze_phi=False, use_bfloat16=True),
    "unfrozen_remat": dict(freeze_phi=False, remat_resnet=True),
}


def _dp_case(steps=1, dropout=False, **kw):
    return ("train", dict(config=dict(DIMS, **kw), num_kps=DIMS["num_kps"],
                          blocks=NARROW, state="main", batch="main",
                          steps=steps, dropout=dropout))


@pytest.fixture(scope="module")
def dp_groups(setup, tmp_path_factory):
    """world -> each rank's results: at W=2 one step of each _DP_CASES
    configuration without dropout; at W=1 two bf16 steps with dropout."""
    st = _port_state(Config(**DIMS), setup["trees"])
    payload = {
        "states": {"main": (st.hmmr.state_dict(), st.disc.state_dict())},
        "batches": {"main": {k: torch.from_numpy(v)
                             for k, v in setup["arrays"].items()}},
        "inputs": {},
    }
    cases = {
        1: [("world1", *_dp_case(steps=2, dropout=True, freeze_phi=False,
                                 use_bfloat16=True))],
        2: [(name, *_dp_case(**kw)) for name, kw in _DP_CASES.items()],
    }
    return {w: run_group(tmp_path_factory.mktemp(f"image_dp{w}"), w,
                         dict(payload, cases=c)) for w, c in cases.items()}


@pytest.mark.parametrize("case", list(_DP_CASES))
def test_dp_step_matches_jax(setup, dp_groups, case):
    """Two ranks, one tube each: the global losses, the summed gradients
    of every trainable parameter and every moving average (statistics of
    both ranks' frames) against JAX's step on the whole batch; every rank
    ends with rank 0's parameters, moments and moving averages."""
    ranks = dp_groups[2]
    for r in ranks[1:]:
        for k, v in ranks[0][case]["state"].items():
            assert torch.equal(r[case]["state"][k], v), k
    got = ranks[0][case]
    grads = got["grads"][0]
    ge = {n[2:]: g for n, g in grads.items() if n.startswith("e.")}
    gd = {n[2:]: g for n, g in grads.items() if n.startswith("d.")}
    assert (not any(n.startswith("resnet_v2_50.") for n in ge)) == (
        case == "freeze_phi")
    model = _port_state(Config(**DIMS), setup["trees"]).hmmr
    model.load_state_dict({n[2:]: v for n, v in got["state"].items()
                           if n.startswith("e.") and ":" not in n})
    _check_against_jax(
        setup, got["metrics"][0], ge, gd,
        flatten_tree(export_jax_variables(model)["batch_stats"]),
        _DP_CASES[case].get("use_bfloat16", False))


def test_world1_mesh_step_equals_single_process(setup, dp_groups):
    """Trainer(mesh=make_mesh(1)), bf16 with the trunk trained and dropout
    on: two steps give the single-process Trainer's losses and state
    exactly (every collective of one rank is the identity)."""
    config = Config(**DIMS, freeze_phi=False, use_bfloat16=True)
    tr = PT.Trainer(config, setup["smpl"], device="cpu")
    load_jax_variables(tr.state.hmmr, setup["trees"]["e"])
    load_jax_variables(tr.state.disc, setup["trees"]["d"])
    batch = _port_batch(setup["arrays"])
    want = [{k: float(v) for k, v in tr.step(batch).items()}
            for _ in range(2)]
    got = dp_groups[1][0]["world1"]
    assert got["metrics"] == want
    for tag, module in (("e.", tr.state.hmmr), ("d.", tr.state.disc)):
        for n, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            assert torch.equal(got["state"][tag + n], t), n
