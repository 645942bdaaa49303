"""The port's image-mode training pieces against the JAX package's, on the
CPU: train-mode BatchNorm and its moving averages, the ResNet in train mode,
remat, and the image path of the data loader.

Weights are made by the port from a seeded generator, every BatchNorm
parameter and statistic and every bias randomised, and carried to the JAX
modules by ``utils.weights.export_jax_variables``.

Tolerances:
- SlimBatchNorm, fp32: outputs and updated statistics within rtol 1e-5,
  atol 1e-6 (the batch variance summed in another order); bf16: outputs
  within rtol 2^-6, atol 2^-5 (two bf16 ulps: XLA keeps x * inv + shift in
  fp32 and rounds once, torch rounds the product and the sum; near zero
  the two terms cancel, so an ulp of a term in [4, 8)), statistics within
  rtol 1e-5 (the batch statistics are rounded to bf16 by both, then
  accumulated in fp32);
- the ResNet in train mode (full ResNet-50 depth, 2 frames of 64x64; the
  JAX program compiled at XLA's backend optimisation level 0): phi
  within atol 1e-3 of JAX's, and the port's largest error against a
  float64 run of the same trunk at most twice JAX's (measured: port
  1.8e-4, JAX 3.1e-4; block 4 normalises over 8 samples per channel and
  16 units of renormalised residual streams amplify float32 rounding);
  every BatchNorm's updated statistics within rtol 1e-4, atol 1e-6 (the
  batch statistics enter at 0.003);
- remat against no remat, in fp32 and under the bf16 casts: equal;
- the loader's examples against the JAX loader's: equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_dynamics_tpu.data import loader as JL
from human_dynamics_tpu.models import resnet as JR
from human_dynamics_tpu.utils.checkpoint import flatten_tree
from human_dynamics_tpu_torch.data import (
    TFRecordWriter,
    convert_to_example_temporal,
    encode_example,
)
from human_dynamics_tpu_torch.data import loader as PL
from human_dynamics_tpu_torch.models.resnet import (
    ResNetV2_50,
    SlimBatchNorm,
    max_pool_same,
    updating_batch_stats,
)
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.precision import to_bf16
from human_dynamics_tpu_torch.utils.weights import (
    export_jax_variables,
    load_jax_variables,
)

torch.set_num_threads(1)

BN_TOL = dict(rtol=1e-5, atol=1e-6)
PHI_ATOL = 1e-3
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
# A narrow trunk of the ResNet-50 layout: projection shortcuts, identity
# shortcuts with a stride, the stride on each block's last unit.
NARROW = ((2, 32, 8), (2, 48, 12), (1, 64, 16))


def randomise(tree, seed):
    """A flax variables tree with every BatchNorm parameter and statistic
    and every bias randomised (numpy)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("gamma", "moving_variance"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("beta", "bias", "moving_mean"):
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(tree)


def port_module(module, seed):
    """``module``'s variables randomised, loaded back; returns the tree."""
    tree = randomise(export_jax_variables(module), seed)
    load_jax_variables(module, tree)
    return tree


def stats_of(module):
    return flatten_tree(export_jax_variables(module)["batch_stats"])


# ---------------------------------------------------------------------------
# SlimBatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slim_batchnorm_train_mode_matches_flax(dtype):
    """Train mode: the batch's mean and biased variance; the moving averages
    advance (decay 0.997, fp32) only where asked (flax's mutable, the
    port's updating_batch_stats) and once there; inference mode reads them
    and returns flax's promoted type: fp32 for a bf16 input, as the
    statistics are fp32."""
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 7, 8) * 2 + 0.5).astype(np.float32)    # NHWC
    bn = SlimBatchNorm(8, device="cpu")
    tree = port_module(bn, 1)
    jbn = JR.SlimBatchNorm()
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    jvars = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jdt), tree["params"]),
        "batch_stats": tree["batch_stats"]}
    jx = jnp.asarray(x, jdt)
    want, new = jbn.apply(jvars, jx, train=True, mutable=["batch_stats"])
    want_pure = jbn.apply(jvars, jx, train=True)
    want_inf = jbn.apply({**jvars, **new}, jx, train=False)

    if dtype == "bfloat16":
        params = to_bf16(dict(bn.named_parameters()))
        call = lambda xx, train: torch.func.functional_call(
            bn, params, (xx, train))
    else:
        call = bn
    px = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    before = {k: v.clone() for k, v in bn.named_buffers()}
    pure = call(px, True)
    for k, v in bn.named_buffers():
        assert torch.equal(v, before[k]), f"{k} moved outside the context"
    with updating_batch_stats(bn):
        got = call(px, True)
        again = call(px, True)
    after = {k: v.clone() for k, v in bn.named_buffers()}
    assert all(v.dtype == torch.float32 for v in after.values())
    inf = call(px, False)
    assert got.dtype == tdt
    assert inf.dtype == torch.float32 and want_inf.dtype == jnp.float32

    out_tol = BN_TOL if dtype == "float32" else dict(rtol=2 ** -6,
                                                     atol=2 ** -5)
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).float().numpy()
    for g, w in ((got, want), (pure, want_pure), (again, want),
                 (inf, want_inf)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w, np.float32),
                                   **out_tol)
    for name in ("moving_mean", "moving_variance"):
        np.testing.assert_allclose(after[name].numpy(),
                                   np.asarray(new["batch_stats"][name]),
                                   **BN_TOL)
        assert not torch.equal(after[name], before[name])
    # Advanced once: 0.997 * old + 0.003 * the batch's statistic.
    xb = px.float() if dtype == "float32" else px
    mean = xb.mean(dim=(0, 2, 3)).float()
    np.testing.assert_allclose(
        after["moving_mean"].numpy(),
        (0.997 * before["moving_mean"] + 0.003 * mean).numpy(), **BN_TOL)


# ---------------------------------------------------------------------------
# The ResNet in train mode, and remat
# ---------------------------------------------------------------------------


def test_resnet_train_mode_matches_jax():
    """ResNet-50 v2 at full depth and width on 2 frames of 64x64 in train
    mode with the statistics updated: phi and every BatchNorm's (16 units'
    and the postnorm's) moving averages against flax's mutable apply."""
    net = ResNetV2_50(device="cpu", generator=torch.Generator().manual_seed(0))
    tree = port_module(net, 2)
    x = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want, new = jax.jit(lambda v, x: JR.ResNetV2_50().apply(
        v, x, train=True, mutable=["batch_stats"])).lower(tree, x).compile(
        {"xla_backend_optimization_level": 0})(tree, x)
    net64 = ResNetV2_50(device="meta").to_empty(device="cpu")
    net64.load_state_dict(net.state_dict())
    with torch.no_grad():
        exact = net64.double()(torch.from_numpy(x).double(), train=True)
        with updating_batch_stats(net):
            got = net(torch.from_numpy(x), train=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PHI_ATOL)
    port_err = float((got.double() - exact).abs().max())
    jax_err = float(np.abs(want - exact.numpy()).max())
    assert port_err <= 2 * jax_err, (port_err, jax_err)
    want_stats = {k: np.asarray(v) for k, v in flatten_tree(
        new["batch_stats"]).items()}
    got_stats = stats_of(net)
    assert set(got_stats) == set(want_stats)
    assert len(got_stats) == 2 * (3 * 16 + 1)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, err_msg=k, **STATS_TOL)


def _remat_run(remat, tree, x, bf16):
    """One train-mode forward with the statistics updated, and the backward
    of the sum of phi; (phi, {name: gradient}, statistics)."""
    net = ResNetV2_50(NARROW, device="cpu", remat=remat)
    load_jax_variables(net, tree)
    named = dict(net.named_parameters())
    with updating_batch_stats(net):
        if bf16:
            params = to_bf16(named)
            phi = torch.func.functional_call(
                net, params, (x.to(torch.bfloat16),), {"train": True})
        else:
            phi = net(x, train=True)
    phi.float().sum().backward()
    return (phi.detach(), {k: p.grad for k, p in named.items()},
            stats_of(net))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_remat_equal_and_statistics_advance_once(bf16):
    """remat_resnet recomputes every unit in the backward: phi, every
    gradient and the moving averages equal those without remat, and the
    averages advanced once (the first BatchNorm's checked by hand),
    under the trainer's bf16 casts too."""
    ref = ResNetV2_50(NARROW, device="cpu",
                      generator=torch.Generator().manual_seed(4))
    tree = randomise(export_jax_variables(ref), 5)
    x = torch.from_numpy(np.random.RandomState(6).uniform(
        -1, 1, (4, 32, 32, 3)).astype(np.float32))
    plain, remat = _remat_run(False, tree, x, bf16), _remat_run(True, tree,
                                                                 x, bf16)
    assert torch.equal(plain[0], remat[0])
    for k, g in plain[1].items():
        assert g is not None and torch.equal(g, remat[1][k]), k
    for k, v in plain[2].items():
        np.testing.assert_array_equal(v, remat[2][k], err_msg=k)

    # By hand: block1/unit_1's preact BatchNorm sees the pooled root conv.
    load_jax_variables(ref, tree)
    root = dict(ref.conv1.named_parameters())
    xin = x.permute(0, 3, 1, 2)
    if bf16:
        root, xin = to_bf16(root), xin.to(torch.bfloat16)
    with torch.no_grad():
        conv = torch.func.functional_call(ref.conv1, root, (xin,))
        mean = max_pool_same(conv).mean(dim=(0, 2, 3)).float()
    old = tree["batch_stats"]["block1/unit_1/bottleneck_v2"]["preact"][
        "moving_mean"]
    got = remat[2]["block1/unit_1/bottleneck_v2::preact::moving_mean"]
    np.testing.assert_allclose(got, 0.997 * old + 0.003 * mean.numpy(),
                               **BN_TOL)


# ---------------------------------------------------------------------------
# The loader's image path
# ---------------------------------------------------------------------------


def _write_image_data(root, fmt, n_frames=(12, 9), crop=48):
    """Image records (uint8 frames, raw_u8 or JPEG) for a 2-D and a 3-D
    dataset, and mocap records, written with the port's data/schema."""
    rng = np.random.RandomState(7)
    for ds, with_3d in (("insta_variety", False), ("h36m", True)):
        d = os.path.join(root, ds, "train")
        os.makedirs(d)
        with TFRecordWriter(os.path.join(d, "shard_0.tfrecord")) as w:
            for n in n_frames:
                frames = rng.randint(0, 256, (n, crop, crop, 3)).astype(
                    np.uint8)
                if fmt == "raw_u8":
                    datas = [f.tobytes() for f in frames]
                else:
                    import cv2

                    datas = [cv2.imencode(".jpg", f)[1].tobytes()
                             for f in frames]
                labels = np.zeros((n, 3, 25), np.float32)
                labels[:, :2] = rng.uniform(crop * 0.3, crop * 0.7,
                                            (n, 2, 25))
                labels[:, 2] = rng.rand(n, 25) > 0.2
                w.write(convert_to_example_temporal(
                    image_datas=datas,
                    image_paths=[f"f{i}.png" for i in range(n)],
                    image_shapes=np.full((n, 2), crop), labels=labels,
                    centers=rng.randint(crop // 3, 2 * crop // 3, (n, 2)),
                    gt3ds=(rng.randn(n, 14, 3).astype(np.float32)
                           if with_3d else None),
                    scale_factors=np.ones((n, 2), np.float32),
                    start_pts=np.zeros((n, 2), np.int64),
                    cams=np.ones((n, 3), np.float32) if with_3d else None,
                    poses=((rng.randn(n, 72) * 0.2).astype(np.float32)
                           if with_3d else None),
                    shape=((rng.randn(10) * 0.3).astype(np.float32)
                           if with_3d else None),
                    image_format=fmt,
                ))
    d = os.path.join(root, "mocap_neutrMosh")
    os.makedirs(d)
    with TFRecordWriter(os.path.join(d, "neutrSMPL_CMU_0.tfrecord")) as w:
        for _ in range(80):
            w.write(encode_example({
                "pose": (rng.randn(72) * 0.2).astype(np.float32),
                "shape": (rng.randn(10) * 0.3).astype(np.float32)}))


IMAGE_DIMS = dict(batch_size=2, T=8, num_kps=25, img_size=32,
                  precomputed_phi=False, datasets=("insta_variety", "h36m"),
                  mocap_datasets=("CMU",), seed=3)


@pytest.mark.parametrize("fmt", ["raw_u8", "jpg"])
def test_image_loader_matches_jax_and_batches(tmp_path, fmt):
    """ExampleStream(decode_images=True) yields the JAX stream's examples
    (uint8 frames, keypoints in source pixels, centres; equal, 5 of them,
    short tubes padded); TrainDataPipeline's image batch on the CPU has the
    JAX test's shapes and ranges, and its batches differ step to step."""
    _write_image_data(str(tmp_path), fmt)
    files = PL.get_all_files(str(tmp_path), ["h36m"])
    kw = dict(t=8, num_kps=25, seed=1, decode_images=True, shuffle_buffer=4,
              shuffle_bytes=1 << 30)
    jit, pit = iter(JL.ExampleStream(files, **kw)), iter(
        PL.ExampleStream(files, **kw))
    for _ in range(5):
        want, got = next(jit), next(pit)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert got["images"].dtype == np.uint8
    assert got["images"].shape == (8, 48, 48, 3)

    pipeline = PL.TrainDataPipeline(
        Config(**IMAGE_DIMS, data_dir=str(tmp_path)), device="cpu")
    try:
        batch = pipeline._assemble_batch()
        second = pipeline._assemble_batch()
    finally:
        pipeline.close()
    assert batch.phis.shape == (2, 8, 32, 32, 3)
    assert batch.phis.dtype == torch.float32
    assert float(batch.phis.min()) >= -1.0 and float(batch.phis.max()) <= 1.0
    assert batch.kps.shape == (2, 8, 25, 3)
    assert float(batch.kps[..., :2].abs().max()) <= 3.0
    assert set(torch.unique(batch.kps[..., 2]).tolist()) <= {0.0, 1.0}
    assert batch.poses_gt.shape == (2, 8, 24, 3)
    assert batch.joints_gt.shape == (2, 8, 14, 3)
    assert batch.poses_real.shape == (2 * 8 * 4, 24, 3)
    assert not torch.equal(batch.phis, second.phis)


def test_shuffle_buffer_is_bounded_in_bytes():
    """With max_bytes the buffer never holds more than that many bytes of
    items; every item comes out once."""
    items = [{"_frames": [b"x" * (100 * (i % 5 + 1))]} for i in range(60)]
    produced, seen = [], set()

    def source():
        for it in items:
            produced.append(it)
            yield it

    for out in PL.shuffle_buffered(source(), np.random.RandomState(0),
                                   capacity=50, max_bytes=1000):
        seen.add(id(out))
        # The newest item produced waits for room outside the buffer.
        inside = [it for it in produced[:-1] if id(it) not in seen]
        assert sum(PL._item_nbytes(it) for it in inside) <= 1000
    assert seen == {id(it) for it in items}
