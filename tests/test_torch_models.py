"""The port's models (human_dynamics_tpu_torch.models) against the flax
models, with flax-initialised weights carried across by the bridge
(human_dynamics_tpu_torch.utils.weights).

Every leaf of the flax tree is randomised before it is carried across, so
that a bias, a BatchNorm statistic or a transposition that the bridge got
wrong shows in the outputs. Tolerance for the narrow models: atol and rtol
1e-4 (float32 sums in another order; flax GroupNorm takes the variance as
E[x^2] - E[x]^2).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.models import hallucinator as jhal
from human_dynamics_tpu.models import hmmr as jhmmr
from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
from human_dynamics_tpu.models import ief as jief
from human_dynamics_tpu.models import omega as jomega
from human_dynamics_tpu.models import resnet as jresnet
from human_dynamics_tpu.models import temporal as jtemporal
from human_dynamics_tpu.utils.checkpoint import save_checkpoint
from human_dynamics_tpu_torch.core import synthetic_smpl_model
from human_dynamics_tpu_torch.models import hmmr as thmmr
from human_dynamics_tpu_torch.models import omega as tomega
from human_dynamics_tpu_torch.models.hallucinator import Hallucinator
from human_dynamics_tpu_torch.models.ief import IefRegressor, ief_refine
from human_dynamics_tpu_torch.models.resnet import ResNetV2_50
from human_dynamics_tpu_torch.models.temporal import TemporalEncoderFC2GN
from human_dynamics_tpu_torch.utils.weights import (
    load_jax_npz,
    load_jax_variables,
    mapped_shape,
    variable_map,
)

torch.set_num_threads(1)

ATOL = RTOL = 1e-4


def _init(module, *example, seed=0):
    """flax init (jitted), every leaf randomised, as a numpy tree."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), *example)
    rng = np.random.RandomState(seed)

    def randomise(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "moving_variance":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("gamma", "scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "beta", "moving_mean"):
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(randomise, variables)


def _port(cls, variables, **kw):
    """A port module built without allocating an init, then loaded."""
    module = cls(device="meta", **kw).to_empty(device="cpu")
    return load_jax_variables(module, variables).eval()


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol
    )


NARROW_BLOCKS = ((2, 32, 8), (1, 64, 16), (1, 64, 16))


@pytest.mark.parametrize("size", [32, 38])
def test_resnet_narrow_matches_flax(size):
    """Narrow blocks cover a projection shortcut (block1/unit_1), a strided
    identity shortcut (block1/unit_2, the strided last unit of its block),
    a strided projection (block2/unit_1) and an unstrided last block.
    Size 32 gives an even 16x16 map into the pool, which pads (0, 1); size
    38 gives an odd 19x19 map, which pads (1, 1)."""
    jm = jresnet.ResNetV2_50(blocks=NARROW_BLOCKS)
    x = np.random.RandomState(1).uniform(-1, 1, (3, size, size, 3))
    x = x.astype(np.float32)
    v = _init(jm, jnp.zeros((1, size, size, 3)))
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = _port(ResNetV2_50, v, blocks=NARROW_BLOCKS)
    assert tm.block1["unit_2"].stride == 2
    assert tm.block1["unit_2"].shortcut is None
    assert tm.block1["unit_1"].shortcut is not None
    assert tm.block2["unit_1"].stride == 2
    assert tm.block2["unit_1"].shortcut is not None
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (3, 64)
    _close(got, want)


def test_max_pool_pads_like_xla_same():
    """The root pool against flax's max_pool(padding='SAME') on maps with
    negative values, where a (1, 1) pad would change the border."""
    from human_dynamics_tpu_torch.models.resnet import max_pool_same

    for size in (16, 17):
        x = np.random.RandomState(size).randn(2, size, size, 5)
        x = x.astype(np.float32) - 3.0
        want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                            padding="SAME")
        got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))


def test_temporal_encoder_matches_flax():
    jm = jtemporal.TemporalEncoderFC2GN(num_layers=3, num_filter=64)
    phi = np.random.RandomState(2).randn(3, 20, 64).astype(np.float32)
    v = _init(jm, jnp.zeros((1, 20, 64)))
    tm = _port(TemporalEncoderFC2GN, v, num_layers=3, num_filter=64)
    assert tm.fov == jm.fov == 13
    with torch.no_grad():
        _close(tm(torch.from_numpy(phi)), jm.apply(v, jnp.asarray(phi)))


class _JaxIef(fnn.Module):
    """The flax IEF regressor under refinement, as HmmrModel calls it."""

    num_output: int = 85

    @fnn.compact
    def __call__(self, phi, start):
        reg = jief.IefRegressor(num_output=self.num_output, name="reg")
        return jief.ief_refine(reg, phi, start, num_stage=3)


@pytest.mark.parametrize("num_output", [85, 72])
def test_ief_matches_flax(num_output):
    rng = np.random.RandomState(3)
    phi = rng.randn(6, 64).astype(np.float32)
    start = rng.randn(6, num_output).astype(np.float32) * 0.1
    jm = _JaxIef(num_output=num_output)
    v = _init(jm, jnp.zeros((1, 64)), jnp.zeros((1, num_output)))
    want = jm.apply(v, jnp.asarray(phi), jnp.asarray(start))
    tm = _port(IefRegressor, {k: t["reg"] for k, t in v.items()},
               in_features=64 + num_output, num_output=num_output)
    with torch.no_grad():
        got = ief_refine(tm, torch.from_numpy(phi), torch.from_numpy(start))
    _close(got, want)


def test_hallucinator_matches_flax():
    jm = jhal.Hallucinator(features=64)
    phi = np.random.RandomState(4).randn(2, 7, 64).astype(np.float32)
    v = _init(jm, jnp.zeros((1, 64)))
    tm = _port(Hallucinator, v, features=64)
    with torch.no_grad():
        _close(tm(torch.from_numpy(phi)), jm.apply(v, jnp.asarray(phi)))


@pytest.mark.parametrize(
    "opts",
    [
        dict(),
        dict(do_hallucinate_preds=True, use_delta_from_pred=False),
        dict(use_hmr_only=True, predict_delta=False),
        dict(do_hallucinate=False, delta_t_values=(-5, 0, 5, 10)),
    ],
    ids=["default", "hal_preds", "hmr_only", "more_deltas"],
)
def test_hmmr_model_matches_flax(opts):
    """Every head of HmmrModel(feature_dim=64), under the model options."""
    jm = jhmmr.HmmrModel(feature_dim=64, **opts)
    phi = np.random.RandomState(5).randn(2, 20, 64).astype(np.float32)
    v = _init(jm, jnp.zeros((1, 20, 64)))
    want = jm.apply(v, jnp.asarray(phi))
    tm = _port(thmmr.HmmrModel, v, feature_dim=64, **opts)
    with torch.no_grad():
        got = tm(torch.from_numpy(phi))
    assert tm.fov == jm.fov
    for field in ("omega_pred", "omega_hal", "movie_strip", "hal_strip",
                  "phi"):
        if getattr(want, field) is None:
            assert getattr(got, field) is None, field
        else:
            _close(getattr(got, field), getattr(want, field))
    for heads in ("omegas_delta", "omegas_hal_delta"):
        assert set(getattr(got, heads)) == set(getattr(want, heads))
        for dt, val in getattr(want, heads).items():
            _close(getattr(got, heads)[dt], val)
            # The delta heads carry the camera [1, 0, 0].
            np.testing.assert_array_equal(
                getattr(got, heads)[dt][..., :3].numpy(),
                np.broadcast_to([1.0, 0.0, 0.0], (2, 20, 3)),
            )


def test_bridge_maps_full_model_exactly_once():
    """The name and shape map on the full HmmrModel(include_resnet=True):
    the flax tree comes from jax.eval_shape and the port model lives on the
    meta device, so no weights are allocated."""
    shapes = jax.eval_shape(
        jhmmr.HmmrModel(include_resnet=True).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 224, 224, 3)),
    )
    leaves = {
        tuple(p.key for p in path): leaf.shape
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)
    }
    tm = thmmr.HmmrModel(include_resnet=True, device="meta")
    tensors = dict(tm.named_parameters())
    tensors.update(tm.named_buffers())
    mapping = variable_map(tm)

    assert set(mapping) == set(tensors)
    keys = [key for key, _ in mapping.values()]
    assert len(keys) == len(set(keys)) == len(leaves)
    assert set(keys) == set(leaves)
    for name, (key, perm) in mapping.items():
        assert mapped_shape(leaves[key], perm) == tuple(tensors[name].shape), name
    assert mapping["resnet_v2_50.block2.unit_4.conv2.weight"] == (
        ("params", "resnet_v2_50", "block2/unit_4/bottleneck_v2", "conv2",
         "kernel"), (3, 2, 0, 1))
    assert mapping["resnet_v2_50.block1.unit_1.preact.moving_mean"][0] == (
        "batch_stats", "resnet_v2_50", "block1/unit_1/bottleneck_v2",
        "preact", "moving_mean")
    assert mapping["ief_delta.past5.fc1.weight"][0][1] == "ief_delta_past5"
    assert mapping["temporal_encoder.block_2.conv1.weight"][1] == (2, 1, 0)


def test_bridge_is_strict():
    jm = jhal.Hallucinator(features=64)
    v = _init(jm, jnp.zeros((1, 64)))
    fresh = lambda: Hallucinator(64, device="meta").to_empty(device="cpu")

    missing = {"params": dict(v["params"])}
    del missing["params"]["fc3"]
    with pytest.raises(KeyError, match="fc3"):
        load_jax_variables(fresh(), missing)

    extra = {"params": {**v["params"], "fc4": v["params"]["fc3"]}}
    with pytest.raises(ValueError, match="fc4"):
        load_jax_variables(fresh(), extra)

    wrong = {"params": {**v["params"],
                        "fc2": {"kernel": np.zeros((64, 32), np.float32),
                                "bias": v["params"]["fc2"]["bias"]}}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(fresh(), wrong)


def test_npz_checkpoint_round_trip(tmp_path):
    """A checkpoint the JAX package saved as npz loads into the port."""
    jm = jhmmr.HmmrModel(feature_dim=64, do_hallucinate=False)
    v = _init(jm, jnp.zeros((1, 20, 64)))
    path = save_checkpoint(str(tmp_path / "vars.npz"), v)
    tree = load_jax_npz(path)
    tm = _port(thmmr.HmmrModel, tree, feature_dim=64, do_hallucinate=False)
    phi = np.random.RandomState(6).randn(1, 20, 64).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(phi))
    _close(got.omega_pred, jm.apply(v, jnp.asarray(phi)).omega_pred)


def test_mean_omega_resolution(tmp_path):
    assert np.array_equal(thmmr.resolve_mean_omega(None),
                          jhmmr.default_mean_omega())
    path = str(tmp_path / "mean.npz")
    rng = np.random.RandomState(7)
    np.savez(path, pose=rng.randn(72), shape=rng.randn(10))
    np.testing.assert_array_equal(thmmr.resolve_mean_omega(path),
                                  jhmmr.resolve_mean_omega(path))
    import h5py

    h5 = str(tmp_path / "mean.h5")
    with h5py.File(h5, "w") as f:
        f["pose"], f["shape"] = rng.randn(72), rng.randn(10)
    np.testing.assert_array_equal(thmmr.resolve_mean_omega(h5),
                                  jhmmr.resolve_mean_omega(h5))


@pytest.mark.parametrize(
    "opts",
    [
        dict(),
        dict(use_optcam=True),
        dict(use_optcam=True, override=True),
        dict(want_verts=False, fused=True),
        dict(fused=True, override=True),
    ],
    ids=["packed_cam", "optcam", "optcam_override", "no_verts_fused",
         "fused_override"],
)
def test_compute_smpl_matches_jax(opts):
    """compute_smpl over a (2, 3) leading shape, under each option; the
    fused cases run the plain blend+skin on the CPU against the JAX Pallas
    kernel in interpret mode. SMPL tolerances of tests/test_ops_pallas.py."""
    opts = dict(opts)
    override = opts.pop("override", False)
    rng = np.random.RandomState(8)
    raw = (rng.randn(2, 3, 85) * 0.3).astype(np.float32)
    raw[..., 0] += 1.0
    cams = (rng.randn(2, 3, 3) * 0.3).astype(np.float32) if override else None
    want = jomega.compute_smpl(
        jax_smpl(num_verts=80, num_kps=19), jnp.asarray(raw),
        cams_override=None if cams is None else jnp.asarray(cams), **opts)
    got = tomega.compute_smpl(
        synthetic_smpl_model(num_verts=80, num_kps=19), torch.from_numpy(raw),
        cams_override=None if cams is None else torch.from_numpy(cams),
        **opts)
    for field in ("joints", "kps", "poses_rot", "verts"):
        if getattr(want, field) is None:
            assert getattr(got, field) is None, field
        else:
            _close(getattr(got, field), getattr(want, field), atol=2e-4,
                   rtol=0)


def test_split_and_pack_omega_match_jax():
    raw = np.random.RandomState(9).randn(4, 5, 85).astype(np.float32)
    parts = tomega.split_omega(torch.from_numpy(raw))
    for g, w in zip(parts, jomega.split_omega(jnp.asarray(raw))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    poses = parts[1].reshape(4, 5, 24, 3)
    packed = tomega.pack_omega(parts[0], poses, parts[2])
    np.testing.assert_array_equal(packed.numpy(), raw)
