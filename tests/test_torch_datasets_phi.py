"""The port's device parts of the dataset tools against the JAX package's,
on the CPU: phi extraction (datasets.phi_extractor), the augmented
train-tube writer (datasets.tube_writer) and the 3DPW neutral-shape fit
(datasets.tdpw.fit_neutral_shape); and, on the card, each against its own
CPU run.

Weights come from the port's seeded ResNetV2_50 with its BatchNorm
parameters and statistics randomised, carried to JAX by utils.weights. The
tube writers get one deterministic stub extractor and one fixed set of
augmentation params (each package's sample_tube_params patched), so the
crops, labels and phis are compared on the same draws.

Tolerances:
- phis: atol 1e-4 (fp32 convolutions summed in another order by XLA and
  torch, through 50 layers, on features of size ~1);
- tube labels: atol 1e-4 (the augment's keypoint bound,
  tests/test_torch_augment.py); stub phis, which are crop pixels in
  [-1, 1]: atol 1e-4 (the bilinear sample's 1e-5 bound there, with room
  for the other float32 order of the 300 px crop's coordinates);
  every other field equal;
- the fit over 300 Adam steps at 64 vertices: beta atol 1e-4, loss 1e-5
  relative (torch.optim.Adam and optax.adam take the same steps in other
  float32 orders, on gradients that differ by rounding);
- on the card against the CPU: phis within 1e-4 relative L2 per frame
  (TF32 is off: fp32 convolutions in other orders); the fit's beta after
  100 steps within 1e-4.

The JAX package is imported inside fixtures, so that the CUDA cases run
where JAX is not installed:
``python -m pytest tests/test_torch_datasets_phi.py --noconftest -m cuda``.
"""

import os

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.core.smpl import (
    smpl_forward,
    synthetic_smpl_model,
)
from human_dynamics_tpu_torch.data import augment as PA
from human_dynamics_tpu_torch.data.schema import parse_temporal_example
from human_dynamics_tpu_torch.data.tfrecord import read_tfrecord
from human_dynamics_tpu_torch.datasets import tdpw as PT
from human_dynamics_tpu_torch.datasets import tube_writer as PW
from human_dynamics_tpu_torch.datasets.phi_extractor import FeatureExtractor
from human_dynamics_tpu_torch.models.resnet import ResNetV2_50
from human_dynamics_tpu_torch.utils.weights import export_jax_variables

torch.set_num_threads(1)

PHI_ATOL = 1e-4
LABEL_ATOL = 1e-4
FIT_BETA_ATOL, FIT_LOSS_RTOL = 1e-4, 1e-5
CARD_PHI_REL = 1e-4
N_FRAMES, FRAME_HW = 8, (240, 320)


@pytest.fixture(scope="module")
def resnet_tree():
    """A flax variables tree of a seeded full-depth ResNet-50 v2 with
    randomised BatchNorm parameters and statistics, nested under
    'resnet_v2_50' as an HmmrModel(include_resnet) tree holds it."""
    resnet = ResNetV2_50(generator=torch.Generator().manual_seed(0))
    tree = export_jax_variables(resnet)
    rng = np.random.RandomState(1)

    def randomise(node):
        for k, v in node.items():
            if isinstance(v, dict):
                randomise(v)
            elif k in ("gamma", "moving_variance"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("beta", "moving_mean"):
                node[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)

    randomise(tree)
    return {c: {"resnet_v2_50": tree[c]} for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def crops():
    return np.random.RandomState(2).uniform(
        -1, 1, (3, 64, 64, 3)).astype(np.float32)


def test_feature_extractor_matches_jax(resnet_tree, crops):
    """3 crops at batch_size=2 (a zero-padded tail) through the port's
    extractor and JAX's compute_all_phis, the same weights; a
    numpy input and a tensor give the same phis."""
    from human_dynamics_tpu.datasets.phi_extractor import (
        FeatureExtractor as JFE,
    )

    want = JFE(resnet_tree, batch_size=2).compute_all_phis(crops)
    fe = FeatureExtractor(resnet_tree, batch_size=2, device="cpu")
    got = fe.compute_all_phis(crops)
    assert got.dtype == np.float32 and got.shape == (3, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=PHI_ATOL)
    np.testing.assert_array_equal(
        fe.compute_all_phis(torch.from_numpy(crops)), got)


def test_feature_extractor_sources_and_device(resnet_tree, crops, tmp_path,
                                              monkeypatch):
    """The variables tree, an npz (a Trainer checkpoint's params_e) and a
    port ResNetV2_50 give one extractor (a module already on the device is
    not copied); device=None without a card raises."""
    from human_dynamics_tpu_torch.utils.checkpoint import save_checkpoint

    fe = FeatureExtractor(resnet_tree, batch_size=4, device="cpu")
    want = fe.compute_all_phis(crops)
    path = save_checkpoint(str(tmp_path / "ckpt.npz"),
                           {"params_e": resnet_tree})
    from_npz = FeatureExtractor(path, batch_size=4, device="cpu")
    np.testing.assert_array_equal(from_npz.compute_all_phis(crops), want)
    for a, b in zip(from_npz.resnet.state_dict().values(),
                    fe.resnet.state_dict().values()):
        assert torch.equal(a, b)
    assert FeatureExtractor(fe.resnet, device="cpu").resnet is fe.resnet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureExtractor(fe.resnet)


class StubExtractor:
    """A deterministic extractor: 64 strided pixels of each crop."""

    device = torch.device("cpu")

    def compute_all_phis(self, images):
        flat = np.asarray(images, np.float32).reshape(len(images), -1)
        return np.ascontiguousarray(flat[:, ::2357][:, :64])


@pytest.fixture(scope="module")
def tube(tmp_path_factory):
    """N_FRAMES noise frames as JPEG files and a walking person's
    keypoints, one of them invisible."""
    import cv2

    d = tmp_path_factory.mktemp("tube")
    rng = np.random.RandomState(3)
    paths = []
    for i in range(N_FRAMES):
        p = str(d / f"frame{i:03d}.jpg")
        cv2.imwrite(p, rng.randint(0, 256, FRAME_HW + (3,), dtype=np.uint8))
        paths.append(p)
    kps = np.zeros((N_FRAMES, 25, 3))
    kps[:, :, 0] = 150 + 2.0 * np.arange(N_FRAMES)[:, None] + np.linspace(
        -25, 25, 25)
    kps[:, :, 1] = 120 + np.linspace(-60, 60, 25)
    kps[:, :, 2] = 1.0
    kps[:, 5, 2] = 0.0
    return paths, kps


def _fixed_params(t):
    rng = np.random.RandomState(4)
    walk = np.cumsum(rng.randint(-3, 4, (t, 2)), axis=0)
    return dict(trans=np.clip(walk, -20, 20).astype(np.float32),
                scale=rng.uniform(-0.3, 0.3, t).astype(np.float32),
                rotate=np.zeros(t, np.float32), flip=np.bool_(True))


def test_tube_converter_matches_jax(tube, tmp_path, monkeypatch):
    """One 8-frame tube through both packages' TubeConverter with the stub
    extractor and the same augmentation params: labels and phis within
    their bounds, every other field equal; a rerun skips the shard."""
    import jax
    import jax.numpy as jnp
    from human_dynamics_tpu.data import augment as JA
    from human_dynamics_tpu.datasets import tube_writer as JW

    paths, kps = tube
    fixed = _fixed_params(N_FRAMES)
    # JAX's tube writer calls augment_tube eagerly; its pipelines run it
    # jitted. Jitted at XLA's backend optimisation level 0 here: a third of
    # the eager time.
    eager = JA.augment_tube
    monkeypatch.setattr(JA, "augment_tube", lambda *args: jax.jit(
        eager).lower(*args).compile(
            {"xla_backend_optimization_level": 0})(*args))
    monkeypatch.setattr(JA, "sample_tube_params", lambda key, t, **kw:
                        JA.TubeAugmentParams(**{k: jnp.asarray(v)
                                                for k, v in fixed.items()}))
    monkeypatch.setattr(PA, "sample_tube_params", lambda g, b, t, **kw:
                        PA.TubeAugmentParams(**{
                            k: torch.as_tensor(v)[None]
                            for k, v in fixed.items()}))
    tubes = [dict(image_paths=paths, gt2ds=kps)]
    want_path, = JW.TubeConverter(
        str(tmp_path / "jax"), feature_extractor=StubExtractor(),
    ).write_tubes("t", tubes)
    conv = PW.TubeConverter(str(tmp_path / "port"),
                            feature_extractor=StubExtractor())
    got_path, = conv.write_tubes("t", tubes)
    assert os.path.basename(got_path) == os.path.basename(want_path)

    want = parse_temporal_example(next(read_tfrecord(want_path)))
    got = parse_temporal_example(next(read_tfrecord(got_path)))
    assert got.n == want.n == N_FRAMES
    np.testing.assert_allclose(got.kps, want.kps, rtol=0, atol=LABEL_ATOL)
    np.testing.assert_allclose(got.phis, want.phis, rtol=0, atol=PHI_ATOL)
    assert np.abs(got.kps[..., :2]).max() <= 1.0
    invisible = got.kps[..., 2] == 0  # one joint a frame, zeroed
    assert np.all(invisible.sum(axis=1) == 1)
    assert np.all(got.kps[invisible] == 0)
    for field in ("image_shapes", "centers", "scale_factors", "start_pts",
                  "time_pts", "image_paths", "image_datas", "poses",
                  "gt3ds", "shape", "cams"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=field)

    before = os.path.getmtime(got_path)
    assert conv.write_tubes("t", tubes) == [got_path]
    assert os.path.getmtime(got_path) == before


def test_tube_converter_draws_and_jpegs(tube, tmp_path):
    """The draws come from a CPU generator seeded with seed + rng_key:
    the same seed writes the same record, another seed another; with
    save_img the records keep the 224 crops as the JAX package encodes
    them (((x + 1) * 0.5) * 255, clipped and truncated)."""
    from human_dynamics_tpu_torch.datasets.common import decode_jpeg

    paths, kps = tube
    tubes = [dict(image_paths=paths, gt2ds=kps)]

    def record(name, seed, save_img=False):
        conv = PW.TubeConverter(str(tmp_path / name),
                                feature_extractor=StubExtractor(),
                                seed=seed, save_img=save_img)
        path, = conv.write_tubes("t", tubes)
        with open(path, "rb") as f:
            return f.read()

    assert record("a", 0) == record("b", 0)
    assert record("a1", 1) != record("a", 0)
    ex = parse_temporal_example(record("c", 0, save_img=True)[12:-4])
    assert len(ex.image_datas) == N_FRAMES
    assert decode_jpeg(bytes(ex.image_datas[0])).shape == (224, 224, 3)

    x = torch.from_numpy(np.random.RandomState(5).uniform(
        -1.2, 1.2, (2, 8, 8, 3)).astype(np.float32))
    want = np.clip(((x.numpy() + 1) * 0.5) * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(PW._jpeg_sources(x), want)


@pytest.fixture(scope="module")
def fit_case():
    """A 64-vertex synthetic SMPL model, the mesh of a known beta, and that
    mesh moved by noise (no beta reaches it: the fit keeps a residual, as
    a gendered mesh leaves one for the neutral model)."""
    smpl = synthetic_smpl_model(num_verts=64)
    rng = np.random.RandomState(31)
    beta = (rng.randn(10) * 0.5).astype(np.float32)
    target = smpl_forward(smpl, torch.from_numpy(beta)[None],
                          torch.zeros(1, 72)).verts[0].numpy()
    noisy = (target + 0.02 * rng.randn(*target.shape)).astype(np.float32)
    return smpl, beta, target, noisy


def test_fit_neutral_shape_matches_jax(fit_case):
    """300 Adam steps from beta = 0 in both packages (tol 0: no early
    stop), at the same lr."""
    from human_dynamics_tpu.core import synthetic_smpl_model as jax_smpl
    from human_dynamics_tpu.datasets.tdpw import fit_neutral_shape as jfit

    smpl, _, _, noisy = fit_case
    kw = dict(lr=0.05, max_iters=300, tol=0.0)
    want_beta, want_loss = jfit(jax_smpl(num_verts=64), noisy, **kw)
    beta, loss = PT.fit_neutral_shape(smpl, noisy, device="cpu", **kw)
    assert beta.shape == (10,) and isinstance(loss, float)
    np.testing.assert_allclose(beta, want_beta, rtol=0, atol=FIT_BETA_ATOL)
    np.testing.assert_allclose(loss, want_loss, rtol=FIT_LOSS_RTOL)


def test_fit_neutral_shape_recovers_beta(fit_case, monkeypatch):
    """The JAX package's recovery case (tests/test_datasets.py): loss below
    1e-4 and beta within 0.05 of the truth; an init_beta and a pose are
    taken; device=None without a card raises."""
    smpl, true_beta, target, _ = fit_case
    beta, loss = PT.fit_neutral_shape(smpl, target, max_iters=3000,
                                      lr=0.05, device="cpu")
    assert loss < 1e-4
    np.testing.assert_allclose(beta, true_beta, atol=0.05)
    beta2, loss2 = PT.fit_neutral_shape(
        smpl, target, init_beta=true_beta, pose=np.zeros(72), max_iters=1,
        device="cpu")
    assert loss2 < 1e-10 and np.abs(beta2 - true_beta).max() <= 0.05 + 1e-6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.fit_neutral_shape(smpl, target, max_iters=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the extractor and the fit are "
                    "checked on the card against their CPU runs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phis_on_the_card_match_cpu(cuda_device):
    """Full-width phis of 5 crops of 224x224 at batch 4 on the card against
    the same extractor on the CPU."""
    resnet = ResNetV2_50(generator=torch.Generator().manual_seed(0))
    x = np.random.RandomState(6).uniform(
        -1, 1, (5, 224, 224, 3)).astype(np.float32)
    cpu = FeatureExtractor(resnet, batch_size=4, device="cpu")
    card = FeatureExtractor(resnet, batch_size=4, device=cuda_device)
    want = cpu.compute_all_phis(x)
    for inp in (x, torch.from_numpy(x).to(cuda_device)):
        got = card.compute_all_phis(inp)
        rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want,
                                                                  axis=1)
        assert rel.max() <= CARD_PHI_REL, rel


@pytest.mark.cuda
def test_fit_on_the_card_matches_cpu(cuda_device, fit_case):
    """100 Adam steps on the card against the CPU."""
    smpl, _, _, noisy = fit_case
    kw = dict(lr=0.05, max_iters=100, tol=0.0)
    want, _ = PT.fit_neutral_shape(smpl, noisy, device="cpu", **kw)
    got, loss = PT.fit_neutral_shape(smpl, noisy, device=cuda_device, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIT_BETA_ATOL)
    assert np.isfinite(loss)
