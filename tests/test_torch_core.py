"""The port's numeric core (human_dynamics_tpu_torch.core) against the JAX
package's, on the same numpy inputs.

Tolerances: the rotation, FK and projection functions are elementwise or
3x3 products, held at 1e-6 (float32 rounding in another order); the SMPL
forward at the tests/test_core_smpl.py values (2e-5 on verts and joints,
which sum over V). synthetic_smpl_model must be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.core import projection as jproj
from human_dynamics_tpu.core import rotations as jrot
from human_dynamics_tpu.core import smpl as jsmpl
from human_dynamics_tpu_torch.core import projection as tproj
from human_dynamics_tpu_torch.core import rotations as trot
from human_dynamics_tpu_torch.core import smpl as tsmpl

torch.set_num_threads(1)

ATOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=atol, rtol=0
    )


def test_rodrigues_matches_jax():
    theta = np.random.RandomState(0).randn(64, 3).astype(np.float32)
    _close(trot.rodrigues(_t(theta)), jrot.rodrigues(jnp.asarray(theta)))


def test_rodrigues_zero_angles():
    """The +1e-8 guard goes on theta before the norm: zero angles give the
    identity, finite, and equal to JAX bit for bit."""
    theta = np.zeros((5, 24, 3), np.float32)
    got = trot.rodrigues(_t(theta))
    want = np.asarray(jrot.rodrigues(jnp.asarray(theta)))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(np.eye(3), want.shape), atol=1e-7)


@pytest.mark.parametrize("fn", ["skew_symmetric", "lrotmin"])
def test_rotation_helpers_match_jax(fn):
    x = np.random.RandomState(1).randn(6, 72).astype(np.float32)
    if fn == "skew_symmetric":
        x = x[:, :3]
    _close(getattr(trot, fn)(_t(x)), getattr(jrot, fn)(jnp.asarray(x)))


def test_rot_to_axis_angle_and_deltas_match_jax():
    rng = np.random.RandomState(2)
    aa = rng.randn(32, 3).astype(np.float32)
    aa[0] = 0.0  # the small-angle branch
    rots = np.asarray(jrot.rodrigues(jnp.asarray(aa)))
    _close(trot.rot_to_axis_angle(_t(rots)),
           jrot.rot_to_axis_angle(jnp.asarray(rots)), atol=2e-5)
    _close(trot.rotation_deltas(_t(rots[:-1]), _t(rots[1:])),
           jrot.rotation_deltas(jnp.asarray(rots[:-1]), jnp.asarray(rots[1:])))


@pytest.mark.parametrize("rotate_base", [False, True])
def test_fk_matches_jax(rotate_base):
    rng = np.random.RandomState(3)
    rots = np.asarray(jrot.rodrigues(
        jnp.asarray(rng.randn(7, 24, 3).astype(np.float32) * 0.5)))
    joints = rng.randn(7, 24, 3).astype(np.float32)
    want = jsmpl.global_rigid_transformation(
        jnp.asarray(rots), jnp.asarray(joints), rotate_base=rotate_base)
    got = tsmpl.global_rigid_transformation(
        _t(rots), _t(joints), rotate_base=rotate_base)
    for g, w in zip(got, want):
        _close(g, w, atol=5e-6)


def test_synthetic_smpl_model_bit_identical():
    jm = jsmpl.synthetic_smpl_model(num_verts=300, num_kps=25, seed=4)
    tm = tsmpl.synthetic_smpl_model(num_verts=300, num_kps=25, seed=4)
    for k in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights", "joint_regressor"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    assert tm.parents == jm.parents


@pytest.mark.parametrize("skip_verts", [False, True])
def test_smpl_forward_matches_jax(skip_verts):
    rng = np.random.RandomState(5)
    beta = rng.randn(9, 10).astype(np.float32) * 0.3
    theta = rng.randn(9, 72).astype(np.float32) * 0.3
    jm = jsmpl.synthetic_smpl_model(num_verts=200, num_kps=19)
    tm = tsmpl.synthetic_smpl_model(num_verts=200, num_kps=19)
    want = jsmpl.smpl_forward(jm, jnp.asarray(beta), jnp.asarray(theta),
                              skip_verts=skip_verts)
    got = tsmpl.smpl_forward(tm, _t(beta), _t(theta), skip_verts=skip_verts)
    if skip_verts:
        assert got.verts is None
    else:
        _close(got.verts, want.verts, atol=2e-5)
    _close(got.joints, want.joints, atol=2e-5)
    _close(got.rots, want.rots)
    _close(got.j_posed, want.j_posed, atol=2e-5)


def test_load_smpl_model_npz(tmp_path):
    """npz written in the JAX package's convert_smpl_pkl layout, loaded by
    both packages, with the lsp joint type; a file that is neither npz nor
    the SMPL pkl is refused (the pkl route: tests/test_torch_demo.py)."""
    jm = jsmpl.synthetic_smpl_model(num_verts=64, num_kps=19)
    path = str(tmp_path / "smpl.npz")
    np.savez(
        path,
        v_template=jm.v_template, shapedirs=jm.shapedirs,
        posedirs=jm.posedirs, j_regressor=jm.j_regressor,
        lbs_weights=jm.lbs_weights, cocoplus_regressor=jm.joint_regressor,
        parents=np.array([-1] + list(jm.parents[1:]), np.int64),
        faces=jm.faces,
    )
    want = jsmpl.load_smpl_model(path, joint_type="lsp")
    got = tsmpl.load_smpl_model(path, joint_type="lsp")
    assert got.num_kps == 14 and got.parents == want.parents
    np.testing.assert_array_equal(got.joint_regressor.numpy(),
                                  np.asarray(want.joint_regressor))
    with pytest.raises(ValueError, match="npz"):
        tsmpl.load_smpl_model(str(tmp_path / "smpl.h5"))


def test_orth_proj_idrot_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(4, 5, 19, 3).astype(np.float32)
    cam = rng.randn(4, 5, 3).astype(np.float32)
    _close(tproj.orth_proj_idrot(_t(x), _t(cam)),
           jproj.orth_proj_idrot(jnp.asarray(x), jnp.asarray(cam)))


def test_procrustes_and_optcam_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(6, 19, 2).astype(np.float32)
    tgt = rng.randn(6, 19, 3).astype(np.float32)
    tgt[..., 2] = (rng.rand(6, 19) > 0.3).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    proj, cam = tproj.orth_proj_optcam(xt, _t(tgt))
    jproj_x, jcam = jproj.orth_proj_optcam(jnp.asarray(x), jnp.asarray(tgt))
    _close(cam, jcam, atol=1e-5)
    _close(proj, jproj_x, atol=1e-5)
    assert not cam.requires_grad  # the camera is detached, as in JAX
