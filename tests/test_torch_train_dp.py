"""The port's data-parallel training step (``Trainer(..., mesh=)``) against
the JAX package's step on a ``make_mesh(W)`` mesh, in phi mode, on the CPU.

The port's ranks run as gloo subprocesses (tests/torch_mesh_worker.py), one
group per world size with every case of that size; the JAX step is
``train_step`` jitted with the state as an argument on a replicated state
and a ``shard_batch``ed batch (GSPMD), compiled at XLA's backend
optimisation level 0. Dims are tests/test_torch_train.py's with a global
batch of 4: Config(T=20, feature_dim=64, num_kps=19), a 32-vertex SMPL
model, the weights of the JAX ``create_train_state`` with every bias and
GroupNorm scale randomised. The heads run without dropout in both
packages (their generators differ). tests/test_torch_train_dp_launch.py
holds the rest of the data-parallel step, with these helpers.

Tolerances:
- losses of each of two steps: rtol 1e-5 (float32 sums in another order);
- the summed gradients of the first step, per tensor: max|port - JAX| <=
  1e-4 * max|JAX| (tests/test_torch_train.py's gradient target); JAX's is
  read from its first moment, mu = (1 - b1) * g after one step. The second
  step's gradients are not compared: they are taken at parameters that
  Adam has already moved apart (below);
- each parameter's update after two steps against optax's Adam on the
  port's own summed gradients: within 1e-5 of the sum of the magnitudes
  of optax's two updates (the two may cancel) plus two float32 ulps of
  the parameter (tests/test_torch_train.py's Adam-vs-optax target). Not
  against JAX's update: Adam divides each element by its own gradient's
  size, so an element whose gradient is near zero moves by up to the
  learning rate on a difference at the gradient target's scale;
- every rank's parameters, moments and moving averages equal to rank 0's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.models import hmmr as JH
from human_dynamics_tpu.parallel import make_mesh as jax_mesh
from human_dynamics_tpu.parallel import replicate as jax_replicate
from human_dynamics_tpu.parallel import shard_batch as jax_shard
from human_dynamics_tpu.train import trainer as JT
from human_dynamics_tpu.utils.config import Config as JaxConfig
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.train import trainer as PT
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.weights import jax_to_port
from tests.test_torch_train import (
    NUM_VERTS,
    _batch_arrays,
    _port_state,
    _randomise,
)
from tests.test_torch_train import DIMS as TRAIN_DIMS
from tests.torch_mesh_worker import run_group

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
DIMS = dict(TRAIN_DIMS, batch_size=4)
FAST_COMPILE = {"xla_backend_optimization_level": 0}
STEPS = 2


class _JaxHeadsWithoutDropout(JH.HmmrModel):
    """The JAX model without dropout in its heads."""

    def _pred_heads(self, features, train, with_deltas):
        return super()._pred_heads(features, False, with_deltas)


def _skewed(arrays):
    """The main batch with rank 1's rows (2, 3 of 4 at W=2) unlabelled in
    3-D and seven eighths of their keypoints invisible, the visible ones
    five times as far from the predictions: a mean of per-rank means
    weighs those rows as much as rank 0's, the global counts do not."""
    out = {k: v.copy() for k, v in arrays.items()}
    out["has_3d_smpl"][2:] = 0.0
    out["has_3d_joints"][2:] = 0.0
    kps = out["kps"]
    kps[2:, ..., :2] *= 5.0
    kps[2:, ..., 2] = (np.random.RandomState(9).rand(*kps[2:, ..., 2].shape)
                       > 0.875)
    return out


def _case(batch, fused=False, dropout=False, steps=STEPS, state="main"):
    return ("train", dict(
        config=dict(DIMS, use_fused_smpl=fused), num_kps=DIMS["num_kps"],
        state=state, batch=batch, dropout=dropout, steps=steps))


_BOTH = {f"{'fused' if f else 'unfused'}": _case("main", fused=f)
         for f in (False, True)}
_CASES = {2: dict(_BOTH, skewed=_case("skewed", steps=1)), 4: _BOTH}


def _write_smpl_npz(path):
    smpl = synthetic_smpl_model(num_verts=NUM_VERTS, num_kps=25)
    np.savez(path, parents=np.array(smpl.parents),
             cocoplus_regressor=smpl.joint_regressor.numpy(),
             **{k: getattr(smpl, k).numpy() for k in (
                 "v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights")})


def weights():
    """The JAX ``create_train_state`` with every bias and GroupNorm scale
    randomised, its models, the port's state holding the same weights, a
    batch and the SMPL model."""
    state, hmmr, disc = JT.create_train_state(JaxConfig(**DIMS),
                                              jax.random.PRNGKey(0))
    state = state._replace(params_e=_randomise(state.params_e, 1),
                           params_d=_randomise(state.params_d, 2))
    return dict(
        state=state, hmmr=hmmr, disc=disc, arrays=_batch_arrays(
            Config(**DIMS)),
        port=_port_state(Config(**DIMS), state.params_e, state.params_d),
        smpl=synthetic_smpl_model(num_verts=NUM_VERTS,
                                  num_kps=DIMS["num_kps"]))


def make_groups(setup, batches, cases, tmp_path_factory):
    """world -> each rank's results of every case of that size, run once
    per module."""
    payload = {
        "states": {"main": (setup["port"].hmmr.state_dict(),
                            setup["port"].disc.state_dict())},
        "batches": {k: {n: torch.from_numpy(v) for n, v in b.items()}
                    for k, b in batches.items()},
        "inputs": {},
    }
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_group(
                tmp_path_factory.mktemp(f"dp{world}"), world,
                dict(payload, cases=[(n, kind, args) for n, (kind, args)
                                     in cases[world].items()]))
        return cache[world]

    return get


@pytest.fixture(scope="module")
def setup():
    """The weights, the batches, and JAX's mesh step (metrics and state
    after each step) at W = 2 and 4, fused and unfused, and on the skewed
    batch."""
    setup = weights()
    state, disc = setup["state"], setup["disc"]
    heads = _JaxHeadsWithoutDropout(**{
        f.name: getattr(setup["hmmr"], f.name)
        for f in dataclasses.fields(setup["hmmr"])
        if f.init and f.name not in ("parent", "name")})
    smpl_j = jax_smpl(num_verts=NUM_VERTS, num_kps=DIMS["num_kps"])
    tx_e, tx_d = JT.make_optimizers(JaxConfig(**DIMS))
    batches = {"main": setup["arrays"], "skewed": _skewed(setup["arrays"])}

    jax_out = {}
    for fused in (False, True):
        c = JaxConfig(**DIMS, use_fused_smpl=fused)

        def step(st, batch, rng, c=c):
            return JT.train_step(c, heads, disc, smpl_j, tx_e, tx_d, st,
                                 batch, rng)

        for world in (2, 4):
            mesh = jax_mesh(world)
            st = jax_replicate(state, mesh)
            rng = jax.random.PRNGKey(DIMS.get("seed", 1))
            shard = lambda name: jax_shard(JT.Batch(**{
                k: jnp.asarray(v) for k, v in batches[name].items()}), mesh)
            fn = jax.jit(step).lower(st, shard("main"), rng).compile(
                FAST_COMPILE)
            runs = {"main": STEPS}
            if world == 2 and not fused:
                runs["skewed"] = 1
            for name, n in runs.items():
                s, out = st, []
                for _ in range(n):
                    s, m = fn(s, shard(name), rng)
                    out.append(({k: float(v) for k, v in m.items()},
                                jax.tree_util.tree_map(np.asarray, s)))
                jax_out[(world, fused, name)] = out

    return dict(setup, batches=batches, jax_out=jax_out)


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    return make_groups(setup, setup["batches"], _CASES, tmp_path_factory)


def _params(module, trees, prefix):
    """{prefix + port name: parameter} of a flax params tree."""
    names = [n for n, _ in module.named_parameters()]
    got = jax_to_port(module, trees, names)
    return {prefix + n: v for n, v in got.items()}


def _jax_params(setup, trees):
    """{"e." / "d." + port name: tensor} of a pair of flax variable trees."""
    e, d = trees
    port = setup["port"]
    return {**_params(port.hmmr, e, "e."), **_params(port.disc, d, "d.")}


def _jax_moment(setup, state, key):
    """A JAX TrainState's Adam moment ``key`` by port names."""
    return _jax_params(setup, ({"params": getattr(state.opt_state_e[0], key)},
                               {"params": getattr(state.opt_state_d[0],
                                                  key)}))


def _optax_steps(params, grads):
    """optax's Adam (the JAX Trainer's) from ``params`` over the gradients
    of each step: [{name: the parameter after step k}]."""
    tx_e, tx_d = JT.make_optimizers(JaxConfig(**DIMS))

    @jax.jit
    def run(params, grads):
        out = [{} for _ in grads]
        for tag, tx in (("e.", tx_e), ("d.", tx_d)):
            p = {k: v for k, v in params.items() if k.startswith(tag)}
            s = tx.init(p)
            for g, after in zip(grads, out):
                u, s = tx.update({k: g[k] for k in p}, s, p)
                p = optax.apply_updates(p, u)
                after.update(p)
        return out

    got = run({k: v.numpy() for k, v in params.items()},
              [{k: v.numpy() for k, v in g.items()} for g in grads])
    return [{k: np.asarray(v) for k, v in g.items()} for g in got]


def _assert_close_per_tensor(got, want):
    for n, w in want.items():
        err = float(np.abs(got[n].numpy() - w).max())
        assert err <= GRAD_REL * np.abs(w).max(), (
            f"{n}: {err} vs {GRAD_REL} * {np.abs(w).max()}")


def _assert_ranks_equal(ranks, case):
    for r, res in enumerate(ranks[1:], 1):
        want = ranks[0][case]["state"]
        got = res[case]["state"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (case, r, k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dp_step_matches_jax_mesh(setup, groups, world, fused):
    """Two W-rank steps against JAX's make_mesh(W) step: every loss, each
    parameter's update after each step, and every rank equal to every
    other."""
    ranks = groups(world)
    name = "fused" if fused else "unfused"
    _assert_ranks_equal(ranks, name)
    got = ranks[0][name]
    want = setup["jax_out"][(world, fused, "main")]
    for step, (m, (w_metrics, _)) in enumerate(zip(got["metrics"], want)):
        assert set(m) == set(w_metrics)
        for k, v in w_metrics.items():
            np.testing.assert_allclose(m[k], v, rtol=LOSS_RTOL,
                                       err_msg=f"step {step}: {k}")
    # The summed gradients of the first step.
    b1 = 0.9
    _assert_close_per_tensor(got["grads"][0], {
        n: v.numpy() / (1 - b1)
        for n, v in _jax_moment(setup, want[0][1], "mu").items()})
    # Both Adams on the summed gradients.
    state = got["state"]
    before = _jax_params(setup, (setup["state"].params_e,
                                 setup["state"].params_d))
    steps = _optax_steps(before, got["grads"])
    for n, p0 in before.items():
        path = [p0.numpy()] + [s[n] for s in steps]
        new = state[n].numpy()
        size = sum(np.abs(b - a) for a, b in zip(path, path[1:]))
        ulp = np.maximum(np.spacing(np.abs(new)), np.spacing(np.abs(path[0])))
        err = np.abs(new - path[-1])
        assert (err <= 1e-5 * size + 2 * ulp).all(), n


def test_global_counts_on_a_skewed_batch(setup, groups):
    """Rank 1's rows carry no 3-D labels and few visible keypoints: the
    W=2 step's losses equal JAX's mesh step's (the global counts), and a
    mean of the two ranks' own losses would be far from them."""
    got = groups(2)[0]["skewed"]["metrics"][0]
    want = setup["jax_out"][(2, False, "skewed")][0][0]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    config = Config(**DIMS)
    st = setup["port"]
    batch = setup["batches"]["skewed"]
    heads = st.hmmr._pred_heads
    st.hmmr._pred_heads = lambda f, w, t, g: heads(f, w, False, None)
    try:
        per_rank = []
        for r in range(2):
            block = PT.Batch(**{k: torch.from_numpy(np.split(v, 2)[r])
                                for k, v in batch.items()})
            per_rank.append(PT.compute_losses(
                config, st.hmmr, st.disc, setup["smpl"], block,
                train=False)[2])
    finally:
        del st.hmmr._pred_heads
    for k in ("e_smpl", "e_kp"):
        mean_of_means = float((per_rank[0][k] + per_rank[1][k]).detach() / 2)
        factor = want[k] / mean_of_means
        assert abs(np.log(factor)) > np.log(1.5), (
            f"{k}: global {want[k]}, mean of per-rank means "
            f"{mean_of_means}: factor {factor}, the batch does not tell "
            "them apart")
