"""Data-parallel training in phi mode beyond the JAX mesh step of
tests/test_torch_train_dp.py: the W=2 step with dropout on against the
port's own single-process step, world 1 against ``Trainer(mesh=None)``,
the Trainer's replication and errors, ``train.main`` as two processes, and
the loader's file shards against the JAX pipeline's. The same dims,
weights and gloo subprocess groups as that file (its helpers), run as a
second module so that the two spread over two test workers.

Tolerances:
- the W=2 step with dropout on against the single-process step on the
  whole batch: losses rtol 1e-5, every parameter after two steps within
  1e-5 relative in L2;
- world 1 against ``Trainer(mesh=None)``: losses equal, parameters within
  1e-7 relative in L2;
- every rank's parameters, moments and moving averages equal to rank 0's;
- the checkpoint in the JAX model: rtol 1e-5, atol 1e-5 (OUT_TOL);
- the loader's shards and batches: equal to JAX's.
"""

import os

import numpy as np
import pytest
import torch

from human_dynamics_tpu.data import loader as JL
from human_dynamics_tpu.utils.checkpoint import load_checkpoint as jax_load
from human_dynamics_tpu.utils.config import Config as JaxConfig
from human_dynamics_tpu_torch import parallel
from human_dynamics_tpu_torch.data import loader as PL
from human_dynamics_tpu_torch.eval.harness import load_model_variables
from human_dynamics_tpu_torch.models import HmmrModel
from human_dynamics_tpu_torch.train import trainer as PT
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_train import OUT_TOL, _write_train_data
from tests.test_torch_train import DIMS as TRAIN_DIMS
from tests.test_torch_train_dp import (
    DIMS,
    LOSS_RTOL,
    STEPS,
    _assert_ranks_equal,
    _case,
    _write_smpl_npz,
    make_groups,
    weights,
)

torch.set_num_threads(1)

DROPOUT_REL = 1e-5
WORLD1_REL = 1e-7


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights, and phi records, an SMPL npz and the arguments of a
    two-process train.main run."""
    data = tmp_path_factory.mktemp("data")
    # Tubes of at least T frames: a shorter one is padded with frames
    # without a visible keypoint, whose optimal camera is 0/0 in both
    # packages.
    _write_train_data(str(data), DIMS["feature_dim"], n_frames=(30, 24, 25))
    smpl_path = str(data / "smpl.npz")
    _write_smpl_npz(smpl_path)
    model_dir = str(tmp_path_factory.mktemp("run"))
    argv = ["--data_dir", str(data), "--model_dir", model_dir,
            "--smpl_model_path", smpl_path, "--batch_size", "4",
            "--feature_dim", str(DIMS["feature_dim"]), "--num_kps", "25",
            "--datasets", "insta_variety", "h36m", "--use_fused_smpl",
            "--log_step", "1", "--device", "cpu", "--num_steps", "2"]
    return dict(weights(), model_dir=model_dir, cases={
        1: {"world1": _case("main", fused=True, dropout=True)},
        2: {"dropout": _case("main", dropout=True),
            "init": ("trainer_init", dict(config=DIMS,
                                          num_kps=DIMS["num_kps"])),
            "main": ("train_main", dict(argv=argv))},
    })


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    return make_groups(setup, {"main": setup["arrays"]}, setup["cases"],
                       tmp_path_factory)


def _single_trainer(setup, **kw):
    tr = PT.Trainer(Config(**DIMS, **kw), setup["smpl"], device="cpu")
    tr.state.hmmr.load_state_dict(setup["port"].hmmr.state_dict())
    tr.state.disc.load_state_dict(setup["port"].disc.state_dict())
    return tr


def test_dp_step_with_dropout_equals_single_process(setup, groups):
    """Dropout on: the W=2 step draws the single-process step's masks, so
    two steps on the blocks equal two steps on the whole batch."""
    tr = _single_trainer(setup)
    batch = PT.Batch(**{k: torch.from_numpy(v)
                        for k, v in setup["arrays"].items()})
    want = [{k: float(v) for k, v in tr.step(batch).items()}
            for _ in range(STEPS)]
    ranks = groups(2)
    _assert_ranks_equal(ranks, "dropout")
    got = ranks[0]["dropout"]
    for m, w in zip(got["metrics"], want):
        for k, v in w.items():
            np.testing.assert_allclose(m[k], v, rtol=LOSS_RTOL, err_msg=k)
    named = {f"e.{n}": p for n, p in tr.state.hmmr.named_parameters()}
    named.update({f"d.{n}": p for n, p in tr.state.disc.named_parameters()})
    for n, p in named.items():
        p = p.detach()
        rel = float((got["state"][n] - p).norm() / p.norm())
        assert rel <= DROPOUT_REL, (n, rel)


def test_world1_mesh_equals_single_process(setup, groups):
    """Trainer(mesh=make_mesh(1)) in a one-rank gloo group, fused SMPL and
    dropout on: the single-process step's losses, exactly, and its
    parameters."""
    tr = _single_trainer(setup, use_fused_smpl=True)
    batch = PT.Batch(**{k: torch.from_numpy(v)
                        for k, v in setup["arrays"].items()})
    want = [{k: float(v) for k, v in tr.step(batch).items()}
            for _ in range(STEPS)]
    got = groups(1)[0]["world1"]
    assert got["metrics"] == want
    for tag, module in (("e.", tr.state.hmmr), ("d.", tr.state.disc)):
        for n, p in module.named_parameters():
            p = p.detach()
            rel = float((got["state"][tag + n] - p).norm() / p.norm())
            assert rel <= WORLD1_REL, (n, rel)


def test_trainer_replicates_rank0_and_checks_the_batch(groups):
    """Each rank initialises from its own seed; after construction every
    rank holds rank 0's state. A batch_size the world does not divide
    raises ValueError."""
    ranks = groups(2)
    _assert_ranks_equal(ranks, "init")
    assert "not divisible" in ranks[1]["init"]["error"]


def test_trainer_mesh_needs_a_process_group(setup):
    """A Trainer with a mesh but no process group raises, as Mesh does."""
    mesh = object.__new__(parallel.Mesh)
    mesh.shape, mesh.rank, mesh.size = {"data": 1}, 0, 1
    mesh.device = torch.device("cpu")
    with pytest.raises(RuntimeError, match="process group"):
        PT.Trainer(Config(**DIMS), setup["smpl"], device="cpu", mesh=mesh)


def test_train_main_two_processes_write_one_checkpoint(setup, groups):
    """train.main as two gloo processes for 2 steps: rank 0 alone writes
    params.json and ckpt-2.npz, every rank ends equal, and the checkpoint
    drives the port's and the JAX package's HmmrModel to rank 0's
    outputs."""
    ranks = groups(2)
    _assert_ranks_equal(ranks, "main")
    lead = ranks[0]["main"]
    assert [r["main"]["lead"] for r in ranks] == [True, False]
    assert all(r["main"]["step"] == 2 for r in ranks)
    assert all(bool(torch.isfinite(v).all()) for v in lead["state"].values())
    ckpts = [f for f in lead["files"] if f.startswith("ckpt-")]
    assert ckpts == ["ckpt-2.npz"] and "params.json" in lead["files"]
    path = os.path.join(setup["model_dir"], "ckpt-2.npz")
    model = HmmrModel(feature_dim=DIMS["feature_dim"], device="meta")
    model = load_jax_variables(model.to_empty(device="cpu"),
                               load_model_variables(path))
    for n, p in model.named_parameters():
        assert torch.equal(p, lead["state"]["e." + n]), n
    x = np.random.RandomState(4).randn(1, 20, DIMS["feature_dim"]).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).omega_pred.numpy()
    tree = jax_load(path)
    assert int(tree["step"]) == 2
    want = setup["hmmr"].apply(tree["params_e"], x).omega_pred
    np.testing.assert_allclose(got, np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("host_id", [0, 1])
def test_loader_shards_match_jax(tmp_path, host_id):
    """TrainDataPipeline(config, host_id, num_hosts=2): the JAX pipeline's
    shard files and its batches, equal array for array (3 batches)."""
    _write_train_data(str(tmp_path), DIMS["feature_dim"])
    kw = dict(TRAIN_DIMS, data_dir=str(tmp_path),
              datasets=("insta_variety", "h36m"), seed=5)
    jp = JL.TrainDataPipeline(JaxConfig(**kw), host_id=host_id, num_hosts=2)
    pp = PL.TrainDataPipeline(Config(**kw), host_id=host_id, num_hosts=2)
    try:
        for want, got in zip([b for b, _ in zip(jp, range(3))],
                             [b for b, _ in zip(pp, range(3))]):
            for field, w, g in zip(want._fields, want, got):
                assert np.array_equal(g, np.asarray(w)), field
    finally:
        jp.close()
        pp.close()
    files = PL.get_all_files(str(tmp_path), ["h36m"])
    assert (PL.ExampleStream(files, 20, host_id=host_id, num_hosts=2).files
            == JL.ExampleStream(files, 20, host_id=host_id,
                                num_hosts=2).files
            == files[host_id::2])
    with pytest.raises(FileNotFoundError, match="host 2 of 3"):
        PL.ExampleStream(files, 20, host_id=2, num_hosts=3)
