"""The port's process mesh (human_dynamics_tpu_torch.parallel: multihost,
mesh, the halo temporal encoder) against the JAX package's parallel
module on the conftest's CPU mesh.

Rank groups run as gloo subprocesses on the CPU
(tests/torch_mesh_worker.py), one group per world size with every case of
that size. Blocks of a sharded batch must equal the JAX arrays'
addressable shards exactly; the movie strip is held to JAX's
movie_strip_sharded within 2e-5 (the JAX halo tests' bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.parallel import (
    make_mesh,
    make_mesh_2d,
    shard_batch,
    shard_batch_2d,
)
from human_dynamics_tpu.parallel.halo import movie_strip_sharded
from human_dynamics_tpu.train.trainer import Batch as JaxBatch
from human_dynamics_tpu_torch import parallel
from human_dynamics_tpu_torch.models import HmmrModel
from human_dynamics_tpu_torch.parallel.multihost import (
    ENV_COORDINATOR,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    default_backend,
    initialize,
    process_env,
)
from human_dynamics_tpu_torch.utils.weights import export_jax_variables
from tests.torch_mesh_worker import run_group

torch.set_num_threads(1)

C = 64
STRIP_NS = (7, 20, 43)
RNG = np.random.RandomState(37)
PHI = {n: RNG.randn(n, C).astype(np.float32) for n in STRIP_NS}
B, T = 4, 6
BATCH = dict(
    phis=RNG.randn(B, T, C), kps=RNG.randn(B, T, 25, 3),
    poses_gt=RNG.randn(B, T, 24, 3), shapes_gt=RNG.randn(B, 10),
    joints_gt=RNG.randn(B, T, 14, 3), has_3d_joints=RNG.rand(B),
    has_3d_smpl=RNG.rand(B), poses_real=RNG.randn(8, 24, 3, 3),
)
BATCH = {k: v.astype(np.float32) for k, v in BATCH.items()}
KEYS = sorted(BATCH)

_PHI = {"model": "phi"}
_CASES = {
    1: [("strip20", "strip", dict(_PHI, phi="phi20"))],
    2: [(f"strip{n}", "strip", dict(_PHI, phi=f"phi{n}")) for n in STRIP_NS]
    + [("shard_batch", "shard_batch", dict(keys=KEYS)),
       ("replicate", "replicate", {})],
    4: [("strip43", "strip", dict(_PHI, phi="phi43")),
        ("shard_batch", "shard_batch", dict(keys=KEYS, shape=(2, 2))),
        ("shard_batch_2d", "shard_batch", dict(keys=KEYS, shape=(2, 2),
                                               two_d=True))],
}


@pytest.fixture(scope="module")
def encoder():
    """The port's HmmrModel (its temporal encoder is what runs) and the same
    weights in the JAX layout."""
    tm = HmmrModel(feature_dim=C, generator=torch.Generator().manual_seed(0))
    return tm, export_jax_variables(tm)


@pytest.fixture(scope="module")
def groups(encoder, tmp_path_factory):
    """world -> each rank's results of every case of that size, run once."""
    inputs = {f"phi{n}": torch.from_numpy(PHI[n]) for n in STRIP_NS}
    inputs.update({k: torch.from_numpy(v) for k, v in BATCH.items()})
    payload = {"models": {"phi": ({"feature_dim": C},
                                  encoder[0].state_dict())},
               "inputs": inputs}
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_group(
                tmp_path_factory.mktemp(f"world{world}"), world,
                dict(payload, cases=_CASES[world]))
        return cache[world]

    return get


# ---------------------------------------------------------------------------
# multihost
# ---------------------------------------------------------------------------

_ENV_CASES = {
    # Not configured: None (a coordinator alone is single-process).
    "empty": ({}, None),
    "one_process": ({ENV_NUM_PROCESSES: "1"}, None),
    "coordinator_only": ({ENV_COORDINATOR: "h:1"}, None),
    "valid_triple": ({ENV_COORDINATOR: "host0:9876", ENV_NUM_PROCESSES: "4",
                      ENV_PROCESS_ID: "2"}, ("host0:9876", 4, 2)),
    "missing_coordinator": ({ENV_NUM_PROCESSES: "2"}, "requires"),
    # "-1" also covers the unset sentinel: every process is told its id.
    "pid_-1": ({ENV_COORDINATOR: "h:1", ENV_NUM_PROCESSES: "2",
                ENV_PROCESS_ID: "-1"}, "must be in"),
    "pid_2": ({ENV_COORDINATOR: "h:1", ENV_NUM_PROCESSES: "2",
               ENV_PROCESS_ID: "2"}, "must be in"),
    "pid_7": ({ENV_COORDINATOR: "h:1", ENV_NUM_PROCESSES: "2",
               ENV_PROCESS_ID: "7"}, "must be in"),
    "malformed_num": ({ENV_NUM_PROCESSES: "two"}, "invalid literal"),
    "malformed_pid": ({ENV_COORDINATOR: "h:1", ENV_NUM_PROCESSES: "2",
                       ENV_PROCESS_ID: "zero"}, "invalid literal"),
}


@pytest.mark.parametrize("case", sorted(_ENV_CASES))
def test_process_env(case):
    """The JAX package's HD_TPU_* contract and errors
    (tests/test_parallel_multihost.py), case by case."""
    env, want = _ENV_CASES[case]
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            process_env(env)
    else:
        assert process_env(env) == want


def test_initialize_single_process_and_backend_choice():
    """No env config: (0, 1) without touching torch.distributed. NCCL for
    CUDA (None means CUDA), gloo for the CPU; NCCL without a CUDA device
    raises instead of falling back."""
    import torch.distributed as dist

    assert initialize({}) == (0, 1)
    assert not dist.is_initialized()
    assert default_backend(None) == "nccl"
    assert default_backend("cuda:1") == "nccl"
    assert default_backend("cpu") == "gloo"
    env = {ENV_COORDINATOR: "localhost:1", ENV_NUM_PROCESSES: "2",
           ENV_PROCESS_ID: "0"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize(env)
    assert not dist.is_initialized()


def test_initialize_two_process_rendezvous(groups):
    """Two processes meet through a file:// coordinator and agree on the
    world (the worker calls initialize with the HD_TPU_* contract)."""
    assert [r["initialize"] for r in groups(2)] == [[0, 2], [1, 2]]


def test_mesh_needs_a_process_group_and_tp_waits():
    """Every mesh, the tensor-parallel one too, needs a process group; and
    shard_params_tp takes only a mesh with a ``model`` axis (a (data,
    time) mesh's layout here, before any weight is touched)."""
    import types

    import torch.distributed as dist

    from human_dynamics_tpu_torch.models import PoseDiscriminator

    assert not dist.is_initialized()
    for make, args in ((parallel.make_mesh, (1,)),
                       (parallel.make_mesh_2d, (1, 1)),
                       (parallel.make_mesh_tp, (1, 1))):
        with pytest.raises(RuntimeError, match="initialize"):
            make(*args, device="cpu")
    disc = PoseDiscriminator(device="cpu")
    before = {n: p.clone() for n, p in disc.named_parameters()}
    mesh_2d = types.SimpleNamespace(shape={"data": 2, "time": 2},
                                    axis_names=("data", "time"))
    with pytest.raises(ValueError, match="no 'model' axis"):
        parallel.shard_params_tp(disc, mesh_2d)
    for n, p in disc.named_parameters():
        assert torch.equal(p, before[n]), n


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def _jax_blocks(arr, mesh):
    """The addressable shards of a JAX array, in the mesh's device order
    (rank order in the port)."""
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    shards = sorted(arr.addressable_shards, key=lambda s: order[s.device])
    return [np.asarray(s.data) for s in shards]


def _jax_batch():
    return JaxBatch(**{k: jnp.asarray(v) for k, v in BATCH.items()})


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_blocks_match_jax(groups, world):
    """Each rank's block of every leaf equals the JAX array's shard on the
    device of the same place: make_mesh(2), and the data axis of
    make_mesh_2d(2, 2) (kept whole along time)."""
    mesh = make_mesh(2) if world == 2 else make_mesh_2d(2, 2)
    sharded = shard_batch(_jax_batch(), mesh)
    ranks = groups(world)
    for k in KEYS:
        want = _jax_blocks(getattr(sharded, k), mesh)
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(
                res["shard_batch"]["blocks"][k].numpy(), want[r],
                err_msg=f"{k} rank {r}")


def test_shard_batch_2d_blocks_match_jax(groups):
    """(data x time) blocks at 2x2: per-frame leaves over both axes,
    per-tube ones over data, the mocap pool whole; an indivisible T raises
    the JAX function's ValueError, word for word."""
    mesh = make_mesh_2d(2, 2)
    sharded = shard_batch_2d(_jax_batch(), mesh)
    ranks = groups(4)
    for k in KEYS:
        want = _jax_blocks(getattr(sharded, k), mesh)
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(
                res["shard_batch_2d"]["blocks"][k].numpy(), want[r],
                err_msg=f"{k} rank {r}")
    bad = _jax_batch()._replace(phis=jnp.asarray(BATCH["phis"][:, :-1]))
    with pytest.raises(ValueError) as err:
        shard_batch_2d(bad, mesh)
    for res in ranks:
        assert res["shard_batch_2d"]["error"] == str(err.value)


def test_replicate_broadcasts_rank0(groups):
    for res in groups(2):
        torch.testing.assert_close(res["replicate"]["w"], torch.zeros(3, 2))
        assert int(res["replicate"]["step"]) == 0


# ---------------------------------------------------------------------------
# halo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,n", [(1, 20), (2, 7), (2, 20), (2, 43),
                                     (4, 43)])
def test_movie_strip_sharded_matches_jax(encoder, groups, world, n):
    """The time-sharded encoder (halo all_reduce, one-pass clip-global
    GroupNorm, conv as three matmuls) on every rank: within 2e-5 of JAX's
    movie_strip_sharded on a mesh of as many devices (padding 7 -> 8,
    43 -> 44), and of the port's own unsharded encoder (F.group_norm,
    nn.Conv1d)."""
    tm, variables = encoder
    mesh = make_mesh(world, axis_name="time")
    want = jax.jit(lambda v, p: movie_strip_sharded(v, p, mesh))(
        variables, jnp.asarray(PHI[n]))
    with torch.no_grad():
        unsharded = tm.temporal_encoder(torch.from_numpy(PHI[n])[None])[0]
    for res in groups(world):
        got = res[f"strip{n}"].numpy()
        assert got.shape == (n, C)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)
        np.testing.assert_allclose(got, unsharded.numpy(), atol=2e-5, rtol=0)
