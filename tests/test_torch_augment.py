"""The port's batched tube augmentation (human_dynamics_tpu_torch.data.augment)
against the JAX package's per-tube one, and on the card against the CPU.

Both packages draw their augmentation from their own generators, so each
comparison gives both the same sampled values: the random walks' draws go
in through the random functions they call, and augment_tube gets one
TubeAugmentParams. The JAX functions run on the CPU, mapped over the tubes
with ``jax.vmap`` as the JAX pipeline maps them, jitted at XLA's backend
optimisation level 0 (a tenth of the eager time here).

Tolerances:
- integer walks, the flips and the mirrored labels: equal (the same
  float32 operations in the same order, or none); float walks and
  ``reflect_joints3d``: atol 1e-6 (XLA takes the cumulative sum and the
  mean in another order: 1 ulp);
- ``rotate_global_pose``: atol 1e-5 (a rodrigues, a 3x3 product and an
  arccos in float32, summed in another order);
- bilinear samples and crops: atol 1e-5 on values in [0, 1] / [-1, 1]
  (float32 weights multiplied in another order; the sampling is continuous
  in its coordinates, so a floor that falls the other way moves the value
  by a rounding error too);
- keypoints, poses and gt3ds of augment_tube: atol 1e-4 (pixel-scale
  coordinates up to ~100 through a scale, a rotation and a division by the
  crop size; float32 ulp at 100 is 7.6e-6);
- on the card against the CPU, crops: atol 5e-4 (the card's sin, cos and
  pow differ from the CPU's by ulps, so a sampling coordinate of up to
  ~400 px, float32 ulp 3e-5, moves by ~1e-4 px, and a crop of noise
  frames, neighbours up to 2 apart in [-1, 1], by ~2e-4); labels as
  above.

The JAX package is imported inside a fixture, so that the CUDA case runs
where JAX is not installed:
``python -m pytest tests/test_torch_augment.py --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.data import augment as PA

torch.set_num_threads(1)

LABEL_ATOL = 1e-4
PIXEL_ATOL = 1e-5
CARD_PIXEL_ATOL = 5e-4
ROT_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's augmentation module (CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from human_dynamics_tpu.data import augment as JA

    return jax, jnp, JA


def _jax_call(jax, fn, *args):
    """fn(*args), jitted at XLA's backend optimisation level 0."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    return compiled(*args)


def _tubes(seed, b=2, t=4, hw=(40, 48), k=25):
    """B tubes of uint8 frames and labels, and their sampled params."""
    rng = np.random.RandomState(seed)
    h, w = hw
    labels = np.zeros((b, t, 3, k), np.float32)
    labels[:, :, 0] = rng.uniform(0.2 * w, 0.8 * w, (b, t, k))
    labels[:, :, 1] = rng.uniform(0.2 * h, 0.8 * h, (b, t, k))
    labels[:, :, 2] = rng.rand(b, t, k) > 0.2
    arrays = dict(
        images=rng.randint(0, 256, (b, t, h, w, 3)).astype(np.uint8),
        labels=labels,
        centers=np.stack([rng.randint(w // 3, 2 * w // 3, (b, t)),
                          rng.randint(h // 3, 2 * h // 3, (b, t))],
                         -1).astype(np.float32),
        poses=(rng.randn(b, t, 72) * 0.4).astype(np.float32),
        gt3ds=rng.randn(b, t, 14, 3).astype(np.float32),
    )
    params = dict(
        trans=rng.randint(-6, 7, (b, t, 2)).astype(np.float32),
        scale=rng.uniform(-0.3, 0.3, (b, t)).astype(np.float32),
        rotate=rng.uniform(-0.5, 0.5, (b, t)).astype(np.float32),
        flip=np.arange(b) % 2 == 0,
    )
    return arrays, params


def test_sample_tube_params_shapes_and_ranges():
    """Walks in their ranges, integer-valued centre jitter, one flip per
    tube; the same seed gives the same params, another seed others."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return PA.sample_tube_params(g, 64, 20, rotate_max=0.3,
                                     delta_rotate_max=0.1)

    p = draw(0)
    assert p.trans.shape == (64, 20, 2) and p.flip.shape == (64,)
    assert p.scale.shape == p.rotate.shape == (64, 20)
    assert torch.equal(p.trans, torch.round(p.trans))
    assert float(p.trans.abs().max()) <= 21
    assert float(p.scale.abs().max()) <= 0.3 + 1e-6
    assert float(p.rotate.abs().max()) <= 0.3 + 1e-6
    # Steps of at most 3 px: a reflection keeps a step's size.
    assert float((p.trans[:, 1:] - p.trans[:, :-1]).abs().max()) <= 3
    assert 0 < int(p.flip.sum()) < 64
    assert all(torch.equal(a, b) for a, b in zip(p, draw(0)))
    assert not torch.equal(p.scale, draw(1).scale)
    assert float(PA.sample_tube_params(torch.Generator(), 2, 5).rotate
                 .abs().max()) == 0.0


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_bounded_random_walk_matches_jax(jax_ref, monkeypatch, integer):
    """The reflecting fold on the same draws: the start and the steps go in
    through jax.random.{randint,uniform} and torch.{randint,rand}."""
    jax, jnp, JA = jax_ref
    rng = np.random.RandomState(1)
    t, dim = 40, 2
    if integer:
        lo, hi, dlo, dhi = -20, 21, -3, 4
        draws = [rng.randint(lo, hi, (1, dim)), rng.randint(dlo, dhi, (t, dim))]
    else:
        lo, hi, dlo, dhi = -0.3, 0.3, -0.05, 0.05
        draws = [rng.rand(1, dim).astype(np.float32),
                 rng.rand(t, dim).astype(np.float32)]

    jax_draws = iter(draws)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval:
                        jnp.asarray(next(jax_draws), jnp.int32))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, minval=0.0, maxval=1.0:
                        jnp.asarray(next(jax_draws)) * (maxval - minval)
                        + minval)
    want = np.asarray(JA.bounded_random_walk(
        jax.random.PRNGKey(0), lo, hi, dlo, dhi, t, dim, integer))

    port_draws = iter(draws)
    monkeypatch.setattr(torch, "randint",
                        lambda low, high, size, generator=None, device=None:
                        torch.from_numpy(next(port_draws)).reshape(size))
    monkeypatch.setattr(torch, "rand",
                        lambda *size, generator=None, device=None:
                        torch.from_numpy(next(port_draws)).reshape(size))
    got = PA.bounded_random_walk(torch.Generator(), lo, hi, dlo, dhi, t,
                                 dim, integer)
    assert got.shape == (1, t, dim)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=0 if integer else 1e-6)
    assert lo <= float(got.min()) and float(got.max()) <= hi


def test_label_primitives_match_jax(jax_ref):
    """reflect_pose, reflect_joints3d and flip_kps equal; rotate_global_pose
    within ROT_ATOL; all on a batch of (2, 3) leading dims."""
    jax, jnp, JA = jax_ref
    rng = np.random.RandomState(2)
    pose = (rng.randn(2, 3, 72) * 0.5).astype(np.float32)
    joints = rng.randn(2, 3, 14, 3).astype(np.float32)
    kps = rng.randn(2, 3, 25, 3).astype(np.float32) * 50
    theta = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    P = lambda x: torch.from_numpy(x)
    np.testing.assert_array_equal(PA.reflect_pose(P(pose)).numpy(),
                                  np.asarray(JA.reflect_pose(pose)))
    np.testing.assert_allclose(PA.reflect_joints3d(P(joints)).numpy(),
                               np.asarray(JA.reflect_joints3d(joints)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(PA.flip_kps(P(kps), 64.0).numpy(),
                                  np.asarray(JA.flip_kps(kps, 64.0)))
    want = _jax_call(jax, jax.vmap(jax.vmap(JA.rotate_global_pose)), pose,
                     theta)
    np.testing.assert_allclose(
        PA.rotate_global_pose(P(pose), P(theta)).numpy(), np.asarray(want),
        rtol=0, atol=ROT_ATOL)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_bilinear_sample_matches_jax(jax_ref, dtype):
    """Edge-clamped bilinear sampling of 3 images at coordinates inside,
    on and beyond the border; uint8 frames read as value / 255."""
    jax, jnp, JA = jax_ref
    rng = np.random.RandomState(3)
    u8 = rng.randint(0, 256, (3, 17, 23, 3)).astype(np.uint8)
    coords = np.stack([rng.uniform(-4, 27, (3, 9, 11)),
                       rng.uniform(-4, 21, (3, 9, 11))], -1).astype(np.float32)
    coords[:, 0, :3] = [[0, 0], [22, 16], [5, 7]]  # integers and corners
    images = u8 if dtype == "uint8" else u8.astype(np.float32) / 255.0
    want = _jax_call(jax, jax.vmap(JA._bilinear_sample),
                     u8.astype(np.float32) / 255.0, coords)
    got = PA._bilinear_sample(torch.from_numpy(images),
                              torch.from_numpy(coords))
    assert got.dtype == torch.float32 and got.shape == (3, 9, 11, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PIXEL_ATOL)


@pytest.mark.parametrize("apply_rotation", [False, True],
                         ids=["no_rotation", "rotation"])
def test_augment_tube_matches_jax(jax_ref, apply_rotation):
    """Two tubes (one flipped) in one port call against the JAX
    augment_tube mapped over them, the same params; as the pipelines call
    it (uint8 frames; JAX's divided by 255 first)."""
    jax, jnp, JA = jax_ref
    arrays, params = _tubes(4)
    jparams = JA.TubeAugmentParams(**{k: jnp.asarray(v)
                                      for k, v in params.items()})
    want = _jax_call(jax, jax.vmap(
        lambda im, lab, cen, po, g3, p: JA.augment_tube(
            im.astype(jnp.float32) / 255.0, lab, cen, po, g3, p,
            output_size=32, apply_rotation=apply_rotation),
    ), *[jnp.asarray(arrays[k]) for k in ("images", "labels", "centers",
                                          "poses", "gt3ds")], jparams)
    got = PA.augment_tube(
        *[torch.from_numpy(arrays[k]) for k in ("images", "labels",
                                                "centers", "poses", "gt3ds")],
        PA.TubeAugmentParams(**{k: torch.from_numpy(v)
                                for k, v in params.items()}),
        output_size=32, apply_rotation=apply_rotation,
    )
    names = ("crops", "labels", "poses", "gt3ds")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=0,
            atol=PIXEL_ATOL if name == "crops" else LABEL_ATOL, err_msg=name)
    assert float(got[0].min()) >= -1.0 and float(got[0].max()) <= 1.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the augmentation is checked on "
                    "the card against its CPU run")
    return torch.device("cuda")


@pytest.mark.cuda
def test_augment_batch_on_the_card_matches_cpu(cuda_device):
    """augment_batch at the training batch's shape (B=8, T=20, frames
    256x256 -> 224 crops) on the card against the CPU, the same params:
    crops within CARD_PIXEL_ATOL, labels within LABEL_ATOL."""
    arrays, params = _tubes(5, b=8, t=20, hw=(256, 256))
    p = PA.sample_tube_params(torch.Generator().manual_seed(0), 8, 20,
                              rotate_max=0.2, delta_rotate_max=0.05)
    args = [torch.from_numpy(arrays[k]) for k in ("images", "labels",
                                                  "centers", "poses",
                                                  "gt3ds")]
    cpu = PA.augment_batch(*args, p, output_size=224, apply_rotation=True)
    card = PA.augment_batch(
        *[a.to(cuda_device) for a in args],
        PA.TubeAugmentParams(*[x.to(cuda_device) for x in p]),
        output_size=224, apply_rotation=True)
    torch.cuda.synchronize()
    for name, c, g in zip(("crops", "kps", "poses", "gt3ds"), cpu, card):
        assert g.is_cuda and g.shape == c.shape, name
        atol = CARD_PIXEL_ATOL if name == "crops" else LABEL_ATOL
        assert float((g.cpu() - c).abs().max()) <= atol, name
