"""The port's 2-D (data x time) training step and its tensor-parallel hook
against the JAX package's steps on ``make_mesh_2d(2, 2)`` and
``make_mesh_tp(2, 2)``, and against the port's single-process step, on the
CPU.

The port's ranks run as gloo subprocesses (tests/torch_mesh_worker.py), one
group per world size with every case of that size. The JAX steps are
``train_step`` on a replicated state and a ``shard_batch_2d``ed batch, and
on a ``shard_params_tp``ed state and a ``shard_batch``ed batch (GSPMD),
each jitted once for both SMPL decodes (one program holds the fused and
the unfused step) at XLA's backend optimisation level 0. Dims and weights
are tests/test_torch_train_dp.py's: Config(batch_size=4, T=20,
feature_dim=64, num_kps=19), a 32-vertex SMPL model, the heads without
dropout in both packages (their generators differ). At feature_dim 64 the
policy shards the IEF heads' fc1 and fc2 and the discriminator's
all-joints fc1 and fc2 (1024 wide).

Tolerances:
- losses of each of two steps: rtol 1e-5 (float32 sums in another order;
  the halo convs are three matmuls where the unsharded conv is one);
- the summed gradients of the first step, per tensor: max|port - JAX| <=
  1e-4 * max|JAX|, JAX's read from its first Adam moment (as the DP test);
- every rank's state (a TP state gathered whole) equal to rank 0's.

Against the port's single-process step (the same tolerances): a 1x2 2-D
phi step with dropout on the same generator (the masks drawn at the global
(B, T) shape, each rank keeping its time block), and in image mode on
tests/test_torch_train_image.py's narrow trunk a 1x2 2-D step (BatchNorm
moments over both time ranks) and a 1x2 TP step with ``min_dim`` 48, so
that the trunk's convs, the temporal convs and the hallucinator are split
too. tests/test_torch_train_image_step.py holds that single-process image
step to JAX.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.parallel import make_mesh_2d as jax_mesh_2d
from human_dynamics_tpu.parallel import make_mesh_tp as jax_mesh_tp
from human_dynamics_tpu.parallel import replicate as jax_replicate
from human_dynamics_tpu.parallel import shard_batch as jax_shard
from human_dynamics_tpu.parallel import shard_batch_2d as jax_shard_2d
from human_dynamics_tpu.parallel import shard_params_tp as jax_shard_tp
from human_dynamics_tpu.train import trainer as JT
from human_dynamics_tpu.utils.config import Config as JaxConfig
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.models import hmmr as PH
from human_dynamics_tpu_torch.models import resnet as PR
from human_dynamics_tpu_torch.train import trainer as PT
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.weights import variable_map
from tests.test_torch_train_dp import (
    DIMS,
    FAST_COMPILE,
    GRAD_REL,
    LOSS_RTOL,
    STEPS,
    _JaxHeadsWithoutDropout,
    _assert_close_per_tensor,
    _assert_ranks_equal,
    _jax_moment,
    weights,
)
from tests.test_torch_train_image import NARROW
from tests.torch_mesh_worker import run_group

torch.set_num_threads(1)

# The image steps' gradient floor (tests/test_torch_train_image_step.py's):
# the root conv's bias feeds a train-mode BatchNorm, so its true gradient
# is 0 and the computed one rounding noise (~5e-7).
IMAGE_GRAD_ATOL = 1e-6
IMAGE_STATS_TOL = dict(rtol=1e-5, atol=1e-6)
IMAGE_DIMS = dict(batch_size=2, T=8, img_size=32, precomputed_phi=False,
                  feature_dim=NARROW[-1][1], num_kps=25, freeze_phi=False)
MESHES = {"2d": ("2d", 2, 2), "tp": ("tp", 2, 2)}


def _image_arrays(config, seed=5):
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


def _narrow_trainer(config, **kw):
    """A single-process CPU Trainer with the narrow trunk."""
    resnet = PH.ResNetV2_50
    PH.ResNetV2_50 = functools.partial(PR.ResNetV2_50, blocks=NARROW)
    try:
        return PT.Trainer(config, synthetic_smpl_model(
            num_verts=32, num_kps=config.num_kps), device="cpu", **kw)
    finally:
        PH.ResNetV2_50 = resnet


def _image_state():
    """The narrow image model's state dicts, every bias, BatchNorm scale
    and moving statistic randomised."""
    tr = _narrow_trainer(Config(**IMAGE_DIMS))
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for module in (tr.state.hmmr, tr.state.disc):
            for n, t in list(module.named_parameters()) + list(
                    module.named_buffers()):
                if n.endswith(("bias", "beta", "moving_mean")):
                    t.copy_(torch.randn(t.shape, generator=g) * 0.1)
                elif n.endswith(("gamma", "moving_variance")):
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return tr.state.hmmr.state_dict(), tr.state.disc.state_dict()


def _case(mesh, batch="main", state="main", steps=STEPS, **kw):
    config = dict(DIMS) if state == "main" else dict(IMAGE_DIMS)
    config.update(kw.pop("config", {}))
    args = dict(config=config, num_kps=config["num_kps"], state=state,
                batch=batch, steps=steps, mesh=mesh, dropout=False)
    args.update(kw)
    if state == "image":
        args["blocks"] = NARROW
    return ("train", args)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The DP test's weights and batch, and JAX's 2-D and TP steps
    (metrics and state after each of two steps, fused and unfused), with
    the names of the parameters JAX's policy shards. The port's rank
    groups (``_start_groups``) run meanwhile."""
    setup = weights()
    setup["model_dir"] = str(tmp_path_factory.mktemp("tp_ckpt"))
    setup["image_state"] = _image_state()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    setup["groups"] = pool.submit(_run_groups, setup, tmp_path_factory)
    pool.shutdown(wait=False)
    state, disc = setup["state"], setup["disc"]
    heads = _JaxHeadsWithoutDropout(**{
        f.name: getattr(setup["hmmr"], f.name)
        for f in dataclasses.fields(setup["hmmr"])
        if f.init and f.name not in ("parent", "name")})
    smpl_j = jax_smpl(num_verts=32, num_kps=DIMS["num_kps"])
    tx_e, tx_d = JT.make_optimizers(JaxConfig(**DIMS))
    configs = [JaxConfig(**DIMS, use_fused_smpl=f) for f in (False, True)]

    def both(states, batch, rng):
        return tuple(JT.train_step(c, heads, disc, smpl_j, tx_e, tx_d, st,
                                   batch, rng)
                     for c, st in zip(configs, states))

    jbatch = JT.Batch(**{k: jnp.asarray(v)
                         for k, v in setup["arrays"].items()})
    rng = jax.random.PRNGKey(DIMS.get("seed", 1))
    jax_out, sharded = {}, None
    for kind, mesh, put_state, put_batch in (
            ("2d", jax_mesh_2d(2, 2), jax_replicate, jax_shard_2d),
            ("tp", jax_mesh_tp(2, 2), jax_shard_tp, jax_shard)):
        st = put_state(state, mesh)
        if kind == "tp":
            sharded = _jax_sharded_names(setup["port"], st)
        b = put_batch(jbatch, mesh)
        fn = jax.jit(both).lower((st, st), b, rng).compile(FAST_COMPILE)
        states, runs = (st, st), ([], [])
        for _ in range(STEPS):
            outs = fn(states, b, rng)
            states = tuple(put_state(s, mesh) for s, _ in outs)
            for run, (s, m) in zip(runs, outs):
                run.append(({k: float(v) for k, v in m.items()},
                            jax.tree_util.tree_map(np.asarray, s)))
        for fused, run in zip((False, True), runs):
            jax_out[(kind, fused)] = run
    return dict(setup, jax_out=jax_out, jax_sharded=sharded)


def _jax_sharded_names(port, state):
    """"e." / "d." + port name of every parameter of a JAX TrainState whose
    sharding carries the ``model`` axis."""
    out = set()
    for tag, module, tree in (("e", port.hmmr, state.params_e),
                              ("d", port.disc, state.params_d)):
        for name, (key, _) in variable_map(module).items():
            leaf = tree
            for k in key:
                leaf = leaf[k]
            if "model" in str(leaf.sharding.spec):
                out.add(f"{tag}.{name}")
    return out


def _run_groups(setup, tmp_path_factory):
    """world -> each rank's results. World 4: the 2x2 2-D and TP steps,
    fused and unfused (the fused TP run writes a checkpoint). World 2: a
    1x2 2-D phi step with dropout, and the image-mode 1x2 2-D and TP
    steps."""
    payload = {
        "states": {"main": (setup["port"].hmmr.state_dict(),
                            setup["port"].disc.state_dict()),
                   "image": setup["image_state"]},
        "batches": {"main": {k: torch.from_numpy(v)
                             for k, v in setup["arrays"].items()},
                    "image": {k: torch.from_numpy(v) for k, v in
                              _image_arrays(Config(**IMAGE_DIMS)).items()}},
        "inputs": {},
    }
    cases = {
        4: {f"{kind}_{'fused' if f else 'unfused'}": _case(
            mesh, config=dict(use_fused_smpl=f,
                              model_dir=setup["model_dir"] if kind == "tp"
                              and f else ""),
            save=kind == "tp" and f)
            for kind, mesh in MESHES.items() for f in (False, True)},
        2: {"2d_dropout": _case(("2d", 1, 2), dropout=True),
            "image_2d": _case(("2d", 1, 2), batch="image", state="image",
                              steps=1, dropout=True),
            "image_tp": _case(("tp", 1, 2), batch="image", state="image",
                              steps=1, dropout=True, min_dim=48)},
    }
    payload_for = lambda w: dict(payload, cases=[
        (n, kind, args) for n, (kind, args) in cases[w].items()])
    return {w: run_group(tmp_path_factory.mktemp(f"group{w}"), w,
                         payload_for(w)) for w in cases}


@pytest.fixture(scope="module")
def groups(setup):
    return setup["groups"].result()


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_sharded_step_matches_jax_mesh(setup, groups, kind, fused):
    """Two steps of the 2x2 2-D or TP step against JAX's on the same mesh:
    every loss of each step, the summed gradients of the first, and every
    rank's state equal to rank 0's."""
    ranks = groups[4]
    name = f"{kind}_{'fused' if fused else 'unfused'}"
    _assert_ranks_equal(ranks, name)
    got = ranks[0][name]
    want = setup["jax_out"][(kind, fused)]
    for step, (m, (w_metrics, _)) in enumerate(zip(got["metrics"], want)):
        assert set(m) == set(w_metrics)
        for k, v in w_metrics.items():
            np.testing.assert_allclose(m[k], v, rtol=LOSS_RTOL,
                                       err_msg=f"step {step}: {k}")
    b1 = 0.9
    _assert_close_per_tensor(got["grads"][0], {
        n: v.numpy() / (1 - b1)
        for n, v in _jax_moment(setup, want[0][1], "mu").items()})


def test_tp_policy_shards_what_jax_shards(setup, groups):
    """shard_params_tp splits the parameters that JAX's marks with the
    ``model`` axis on the same state, on every rank, and some of them."""
    want = setup["jax_sharded"]
    assert want
    for r, res in enumerate(groups[4]):
        assert set(res["tp_fused"]["sharded"]) == want, r


def test_tp_checkpoint_restores_into_a_single_process_trainer(setup,
                                                              groups):
    """The TP run's checkpoint (rank 0 writes the gathered tensors) loads
    into a single-process Trainer equal to the gathered parameters and
    Adam moments, and back into the sharded Trainer on every rank."""
    for res in groups[4]:
        got = res["tp_fused"]
        assert got["checkpoint"].endswith(f"ckpt-{STEPS}.npz")
        assert set(got["restored"]) == set(got["state"])
        for k, v in got["state"].items():
            assert torch.equal(got["restored"][k], v), k
    got = groups[4][0]["tp_fused"]
    tr = PT.Trainer(Config(**DIMS, model_dir=setup["model_dir"]),
                    synthetic_smpl_model(num_verts=32,
                                         num_kps=DIMS["num_kps"]),
                    device="cpu")
    assert tr.state.step == STEPS
    state = got["state"]
    for tag, module, opt in (("e.", tr.state.hmmr, tr.state.opt_e),
                             ("d.", tr.state.disc, tr.state.opt_d)):
        for n, p in module.named_parameters():
            assert torch.equal(p, state[tag + n]), n
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][key],
                                   state[f"{tag}{n}:{key}"]), (n, key)


def _single_process_step(config, state, arrays, steps, image=False):
    tr = (_narrow_trainer(config) if image
          else PT.Trainer(config, synthetic_smpl_model(
              num_verts=32, num_kps=config.num_kps), device="cpu"))
    tr.state.hmmr.load_state_dict(state[0])
    tr.state.disc.load_state_dict(state[1])
    batch = PT.Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    metrics, grads = [], None
    for _ in range(steps):
        metrics.append({k: float(v) for k, v in tr.step(batch).items()})
        if grads is None:
            grads = {f"{tag}.{n}": p.grad.clone() for tag, m in (
                ("e", tr.state.hmmr), ("d", tr.state.disc))
                for n, p in m.named_parameters() if p.grad is not None}
    return metrics, grads, dict(tr.state.hmmr.named_buffers())


@pytest.mark.parametrize("case", ["2d_dropout", "image_2d", "image_tp"])
def test_one_by_two_step_matches_single_process(setup, groups, case):
    """A 1x2 2-D or TP step (with dropout on the same generator) against
    the port's single-process step: the losses, the gradients of the
    first step (in image mode within IMAGE_GRAD_ATOL more), the moving
    averages, every rank's state equal."""
    ranks = groups[2]
    _assert_ranks_equal(ranks, case)
    got = ranks[0][case]
    image = case.startswith("image")
    config = Config(**(IMAGE_DIMS if image else DIMS))
    state = (setup["image_state"] if image else
             (setup["port"].hmmr.state_dict(), setup["port"].disc.state_dict()))
    arrays = _image_arrays(config) if image else setup["arrays"]
    metrics, grads, stats = _single_process_step(
        config, state, arrays, len(got["metrics"]), image)
    for step, (m, want) in enumerate(zip(got["metrics"], metrics)):
        for k, v in want.items():
            np.testing.assert_allclose(m[k], v, rtol=LOSS_RTOL,
                                       err_msg=f"step {step}: {k}")
    atol = IMAGE_GRAD_ATOL if image else 0.0
    for n, w in grads.items():
        err = float((got["grads"][0][n] - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()) + atol, (
            f"{n}: {err} vs {GRAD_REL} * {float(w.abs().max())} + {atol}")
    assert bool(stats) == image
    for n, v in stats.items():
        np.testing.assert_allclose(got["state"]["e." + n], v,
                                   **IMAGE_STATS_TOL, err_msg=n)
