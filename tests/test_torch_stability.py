"""The port's stability run and its summary
(human_dynamics_tpu_torch.scripts.stability_run / summarize_stability), and
h5 mean-omega files (models.hmmr.load_mean_omega), on the CPU.

- A 20-step stability run at toy sizes through the module's CLI: every
  logged loss finite, metrics.csv summarised; without ``--device`` it and
  the gauntlet's CLI raise where there is no CUDA device.
- The port's summary against the JAX repo's scripts/summarize_stability on
  a copy of docs/stability/metrics.csv: the same text.
- load_mean_omega on tiny h5 files written by h5py, with the datasets at
  the root and under '/data' (the deepdish layout): equal to the JAX
  package's; a missing dataset raises KeyError naming the keys there are;
  without h5py it raises an ImportError that says so.
"""

import contextlib
import csv
import io
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.models import hmmr as PH
from human_dynamics_tpu_torch.scripts import (
    stability_run,
    summarize_stability,
    synthetic_gauntlet,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_stability_run_and_summary(tmp_path):
    out = str(tmp_path / "s")
    argv = ["--out", out, "--num_steps", "20", "--num_tubes", "8",
            "--frames_per_tube", "40", "--feature_dim", "64", "--num_verts",
            "48", "--batch_size", "2", "--log_step", "5"]
    # The CUDA device unless asked for the CPU; never a fallback.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stability_run.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_gauntlet.main(["--out", str(tmp_path / "g")])
    trainer = stability_run.main(argv + ["--device", "cpu"])
    model_dir = trainer.config.model_dir
    assert os.path.dirname(model_dir) == os.path.join(out, "logs")
    assert os.path.exists(os.path.join(model_dir, "ckpt-20.npz"))
    with open(os.path.join(model_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [5, 10, 15, 20]
    for r in rows:
        for k in ("e_loss", "d_loss", "e_kp", "e_pose", "d_pose"):
            assert math.isfinite(float(r[k])), (r["step"], k)

    text = _stdout(summarize_stability.main, model_dir)
    assert "Steps logged: 5..20 (4 rows)" in text
    assert "- Finite throughout: yes" in text
    assert text.count("\n| ") == 1 + 4


def test_summary_matches_jax(tmp_path):
    from scripts import summarize_stability as jax_summary

    model_dir = str(tmp_path / "run")
    os.makedirs(model_dir)
    shutil.copy(os.path.join(REPO, "docs", "stability", "metrics.csv"),
                model_dir)
    want = _stdout(jax_summary.main, model_dir)
    assert _stdout(summarize_stability.main, model_dir) == want
    assert "Finite throughout" in want and want.count("\n| ") > 10


@pytest.mark.parametrize("layout", ["root", "data"])
def test_h5_mean_omega_matches_jax(tmp_path, layout, monkeypatch):
    import h5py

    from human_dynamics_tpu.models import hmmr as JH

    rng = np.random.RandomState(3 if layout == "root" else 4)
    path = str(tmp_path / f"mean_{layout}.h5")
    with h5py.File(path, "w") as f:
        group = f if layout == "root" else f.create_group("data")
        group["pose"] = rng.randn(72)
        group["shape"] = rng.randn(1, 10).astype(np.float32)
    got = PH.load_mean_omega(path)
    assert got.shape == (1, 85) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JH.load_mean_omega(path))

    bad = str(tmp_path / "bad.hdf5")
    with h5py.File(bad, "w") as f:
        f["pose"] = rng.randn(72)
    with pytest.raises(KeyError, match=r"'shape'.*available: \['pose'\]"):
        PH.load_mean_omega(bad)

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        PH.load_mean_omega(path)
