"""The port's int8 root stems and int8 residual stream (``int8_root``,
``int8_stream`` of models/resnet_int8; ops/int8_root_cuda, the stem fused
with the max pool; the "stream" epilogue and pre-activation modes 2 and 3
of ops/resnet_int8_cuda) against the JAX package's, and the CUDA kernels
against their plain versions.

The JAX side is the ``trunk`` of tests/test_torch_resnet_int8.py: a
full-width ResNet-50 v2 at 2x64x64, seed 5, randomised BN statistics, its
int8 params (eager) and calibrated scales carried into the port by
``utils.weights.load_jax_int8``. Tolerances:

- int8 weights, int32 contractions, int8 outputs and pre-activations, and
  the trunk's phi on every int8_root / int8_stream case: equal. XLA
  contracts the new multiply-adds into fused ones on the CPU (the stem's
  epilogue, the u8 stem's float snap and border map, the stream's
  pre-activation and conv3 epilogue and shortcut add), and rewrites a
  division by a constant as a multiply by its reciprocal; the port does
  the same, and the expression tests below hold it there on many elements.
- The K2 case (``use_pallas`` with block 1 streamed) against JAX's Pallas
  kernel in interpret mode: rel 1e-4, K2's tolerance.

JAX is imported inside fixtures, so that the CUDA cases also run where JAX
is not installed:
``python -m pytest tests/test_torch_resnet_int8_root.py --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from human_dynamics_tpu_torch.models import resnet_int8 as T
from human_dynamics_tpu_torch.models.resnet import max_pool_same
from human_dynamics_tpu_torch.ops import int8_root_cuda as R
from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
from human_dynamics_tpu_torch.utils.weights import (
    load_jax_int8,
    load_jax_variables,
)

torch.set_num_threads(1)

# (name, apply_int8_static options, uint8 frames): the trunk cases.
PRE1 = "block1/unit_1/bottleneck_v2/"

TRUNK_CASES = [
    ("s2d", dict(int8_root=True), False),
    ("wfold", dict(int8_root="wfold"), False),
    ("u8_float", dict(int8_root="u8"), False),
    ("u8_bytes", dict(int8_root="u8"), True),
    ("stream_all", dict(int8_stream=True), False),
    ("stream_1", dict(int8_stream=(1,)), False),
    ("stream_12", dict(int8_stream=(1, 2)), False),
    ("s2d_stream_1", dict(int8_root=True, int8_stream=(1,)), False),
    ("k2_stream_1", dict(use_pallas=True, int8_stream=(1,)), False),
]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def trunk():
    """The JAX trunk (as tests/test_torch_resnet_int8.py makes it), its
    int8 params, scales and jitted static trunk on every case; the port's
    on the same weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from human_dynamics_tpu.models.resnet import ResNetV2_50 as JaxResNet
    from human_dynamics_tpu.models import resnet_int8 as J

    rng = np.random.RandomState(5)
    model = JaxResNet()
    x = jnp.asarray(rng.randn(2, 64, 64, 3).astype(np.float32) * 0.5)
    variables = model.init(jax.random.PRNGKey(0), x)
    stats = jax.tree_util.tree_map(
        lambda v: v + jnp.asarray(
            rng.uniform(0.01, 0.2, v.shape).astype(np.float32)),
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    qp = J.prepare_int8_params(variables)
    scales = jax.jit(J.calibrate_int8_scales)(qp, x)
    raw = np.random.RandomState(7).randint(0, 256, (2, 64, 64, 3))
    raw = raw.astype(np.uint8)
    static = jax.jit(
        lambda q, s, im, opts: J.apply_int8_static(q, s, im, **dict(opts)),
        static_argnums=3,
    )
    out = {
        name: np.asarray(static(qp, scales, jnp.asarray(raw) if u8 else x,
                                tuple(opts.items())))
        for name, opts, u8 in TRUNK_CASES
    }
    port = T.ResNetV2_50(device="meta").to_empty(device="cpu")
    load_jax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    tqp, tscales = load_jax_int8(_np(qp), _np(scales))
    return {
        "J": J, "jax": jax, "jnp": jnp, "qp": _np(qp), "out": out,
        "x": torch.from_numpy(np.array(x)), "raw": torch.from_numpy(raw),
        "port": port, "tqp": tqp, "tscales": tscales,
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def test_root_weights_match_jax(trunk):
    """prepare_int8_params' four int8_root keys equal JAX's bit for bit, and
    load_jax_int8 carries them."""
    got = T.prepare_int8_params(trunk["port"])
    for k in T.INT8_ROOT_KEYS:
        want = trunk["qp"][k]
        assert got[k].dtype == (torch.int8 if "/wq" in k else torch.float32)
        assert tuple(got[k].shape) == want.shape, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
        np.testing.assert_array_equal(trunk["tqp"][k].numpy(), want,
                                      err_msg=k)


def test_root_views_match_jax(trunk):
    """_s2d, _wfold and the fold weights against the JAX package's on the
    same arrays."""
    J, jnp = trunk["J"], trunk["jnp"]
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 10, 3).astype(np.float32)
    w = rng.randn(7, 7, 3, 5).astype(np.float32)
    for mine, theirs, arr in ((T._s2d, J._s2d, x), (T._wfold, J._wfold, x),
                              (T._s2d_root_weights, J._s2d_root_weights, w),
                              (T._wfold_root_weights, J._wfold_root_weights,
                               w)):
        np.testing.assert_array_equal(mine(torch.from_numpy(arr)).numpy(),
                                      np.asarray(theirs(jnp.asarray(arr))))


# ---------------------------------------------------------------------------
# The plain versions against dense oracles and the JAX expressions
# ---------------------------------------------------------------------------


def _view_conv(q, w_hwio, fold):
    """The stem's contraction as float64 F.conv2d on the explicit view."""
    if fold == "s2d":
        v, stride, pad = T._s2d(q), (1, 1), (2, 1, 2, 1)
    else:
        v, stride, pad = T._wfold(q), (2, 1), (2, 1, 3, 3)
    v = F.pad(v.double().permute(0, 3, 1, 2), pad)
    y = F.conv2d(v, w_hwio.double().permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int32)


@pytest.mark.parametrize("fold,h,w", [
    ("s2d", 10, 14), ("s2d", 6, 8), ("wfold", 9, 12), ("wfold", 7, 6),
    ("wfold", 10, 10),
])
def test_root_conv_reference_matches_view_conv(trunk, fold, h, w):
    """The stem's plain contraction (the kernel's tap table) against
    F.conv2d in float64 on the explicit s2d / wfold view and against
    jax.lax on it, at odd and even borders: int32 equal."""
    jax, jnp = trunk["jax"], trunk["jnp"]
    rng = np.random.RandomState(h * w)
    q = rng.randint(-128, 128, (2, h, w, 3)).astype(np.int8)
    key = "root/wq_" + fold
    wq = torch.from_numpy(trunk["qp"][key].copy())
    got = R.root_conv_reference(torch.from_numpy(q), K.hwio_to_kmajor(wq),
                                fold)
    assert got.dtype == torch.int32
    assert tuple(got.shape[1:3]) == R.root_geometry(h, w, fold)
    want = _view_conv(torch.from_numpy(q), wq, fold)
    assert torch.equal(got, want)
    J = trunk["J"]
    view = J._s2d if fold == "s2d" else J._wfold
    stride, pad = (((1, 1), ((2, 1), (2, 1))) if fold == "s2d"
                   else ((2, 1), ((3, 3), (2, 1))))
    lax = jax.lax.conv_general_dilated(
        view(jnp.asarray(q)), jnp.asarray(trunk["qp"][key]), stride, pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lax))


def _jax_stem(J, jax, jnp, qp, s_root, s_p, images, int8_root):
    """The int8 stem of J.apply_int8 (resnet_int8.py:379-458) and block 1
    unit 1's pre-activation of the pooled map, dequantised to bf16 (mode 3,
    :540-542 then :578-589) and from the int8 stream (mode 2, :565-576),
    jitted."""
    def stem(qp, s_root, s_p, images):
        if int8_root == "u8":
            if images.dtype == jnp.uint8:
                q = jax.lax.bitcast_convert_type(images ^ jnp.uint8(128),
                                                 jnp.int8)
            else:
                q = (jnp.clip(jnp.round(
                    images.astype(jnp.float32) * 127.5 + 127.5), 0, 255)
                    - 128.0).astype(jnp.int8)
            conv = lambda v: jax.lax.conv_general_dilated(
                J._wfold(v), qp["root/wq_wfold"], (2, 1), ((3, 3), (2, 1)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.int32)
            y = conv(q)
            ones = conv(jnp.ones((1,) + q.shape[1:], jnp.int8))
            w_scale = qp["root/scale_wfold"]
            mult = w_scale * (2.0 / 255.0)
            bias_map = (ones.astype(jnp.float32) * (w_scale / 255.0)
                        + qp["root/b32"])
        else:
            xq = jnp.clip(jnp.round(images * 127.0), -127, 127).astype(
                jnp.int8)
            if int8_root == "wfold":
                y = jax.lax.conv_general_dilated(
                    J._wfold(xq), qp["root/wq_wfold"], (2, 1),
                    ((3, 3), (2, 1)), dimension_numbers=("NHWC", "HWIO",
                                                         "NHWC"),
                    preferred_element_type=jnp.int32)
                w_scale = qp["root/scale_wfold"]
            else:
                y = jax.lax.conv_general_dilated(
                    J._s2d(xq), qp["root/wq_s2d"], (1, 1), ((2, 1), (2, 1)),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    preferred_element_type=jnp.int32)
                w_scale = qp["root/scale_s2d"]
            mult = w_scale / 127.0
            bias_map = qp["root/b32"]
        yq = jnp.clip(jnp.round(y.astype(jnp.float32) * (mult / s_root)
                                + bias_map / s_root), -127, 127).astype(
            jnp.int8)
        pooled = jax.lax.reduce_window(yq, jnp.int8(-128), jax.lax.max,
                                       (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
        A = qp[PRE1 + "preact/A"]
        B = qp[PRE1 + "preact/B"]
        xb = pooled.astype(jnp.bfloat16) * s_root.astype(jnp.bfloat16)
        p3 = jnp.maximum(xb * A.astype(jnp.bfloat16)
                         + B.astype(jnp.bfloat16), 0)
        pq3 = jnp.clip(jnp.round(p3.astype(jnp.float32) / s_p), 0,
                       127).astype(jnp.int8)
        pq2 = jnp.clip(jnp.round(jnp.maximum(
            pooled.astype(jnp.float32) * (s_root * A / s_p) + B / s_p, 0)),
            0, 127).astype(jnp.int8)
        return yq, pooled, pq3, pq2
    return [np.asarray(t) for t in jax.jit(stem)(qp, s_root, s_p, images)]


@pytest.mark.parametrize("h,w", [(64, 64), (30, 38)])
@pytest.mark.parametrize("int8_root,u8_frames", [
    (True, False), ("wfold", False), ("u8", False), ("u8", True),
])
def test_stem_and_pool_match_jax(trunk, int8_root, u8_frames, h, w):
    """The plan's stem (input transform, contraction, epilogue) and the
    fused stem + pool wrapper (``_run_stem``) on 6 frames against the JAX
    package's stem and reduce_window jitted, in every mode: the pooled map
    (-1), its pre-activation dequantised to bf16 (3, int8_root alone) and
    from the int8 stream (2, block 1 streamed): int8 equal. 30x38 puts odd
    sizes (15, 19) under the pool, with a leading pad, and a border map
    that is not the interior sum."""
    J, jax, jnp = trunk["J"], trunk["jax"], trunk["jnp"]
    rng = np.random.RandomState(11)
    raw = rng.randint(0, 256, (6, h, w, 3)).astype(np.uint8)
    floats = (rng.rand(6, h, w, 3).astype(np.float32) * 2 - 1)
    if int8_root == "u8" and not u8_frames:
        floats = raw.astype(np.float32) * np.float32(2 / 255) - 1
    images = raw if u8_frames else floats
    s_root = np.float32(trunk["tscales"]["root/out"])
    s_p = np.float32(trunk["tscales"][PRE1 + "preact"])
    want_y, want_pool, want_pq3, want_pq2 = _jax_stem(
        J, jax, jnp, {k: jnp.asarray(v) for k, v in trunk["qp"].items()},
        s_root, s_p, jnp.asarray(images), int8_root)
    plan = T.prepare_int8_static(trunk["tqp"], trunk["tscales"],
                                 int8_root=int8_root)
    streamed = T.prepare_int8_static(trunk["tqp"], trunk["tscales"],
                                     int8_root=int8_root, int8_stream=(1,))
    root, x = plan["root"], torch.from_numpy(images)
    add, border = T._root_add(root, h, w)
    full = add if border is None else R.stem_add_map(add, border, h, w,
                                                     root["fold"])
    kind = ("u8" if u8_frames else "u8_float") if root["u8"] else "f32"
    y = R.root_stem_reference(x, root["wt"], root["mul"], full,
                              fold=root["fold"], kind=kind)
    assert torch.equal(y, torch.from_numpy(want_y))
    assert plan["pool_preact"].mode == 3
    assert streamed["pool_preact"].mode == 2
    for pre, want in ((None, want_pool), (plan["pool_preact"], want_pq3),
                      (streamed["pool_preact"], want_pq2)):
        got = T._run_stem(root, x, pre)
        assert got.dtype == torch.int8
        assert torch.equal(got, torch.from_numpy(want)), pre


@pytest.mark.parametrize("h,w", [(32, 32), (15, 19), (112, 8), (1, 2)])
def test_max_pool_s8_reference_matches_max_pool_same(h, w):
    """The int8 pool against max_pool_same on the int8 values as floats
    (-inf padding), and its pre-activation modes against the standalone
    pass over the pooled map."""
    g = torch.Generator().manual_seed(h * w)
    x = torch.randint(-127, 128, (2, h, w, 32), generator=g,
                      dtype=torch.int8)
    got = R.max_pool_s8_reference(x)
    want = max_pool_same(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(got, want.to(torch.int8))
    pa, pb = torch.rand(32, generator=g) + 0.5, torch.randn(32, generator=g)
    two = K.Preact(pa * 0.1, pb, None, 2)
    three = K.Preact(pa.to(torch.bfloat16).float(),
                     pb.to(torch.bfloat16).float(), torch.tensor([0.05]), 3,
                     torch.tensor([0.0390625]))
    for pre in (two, three):
        pq = R.max_pool_s8_reference(x, preact=pre)
        assert torch.equal(pq, K.preact_quant_reference(
            got, pre.pa, pre.pb, pre.s, mode=pre.mode, ds=pre.ds))
        assert 0 < int((pq > 0).sum()) < pq.numel()


def test_root_add_refuses_a_doctored_map(trunk, monkeypatch):
    """_root_add: the u8 border map equals the interior add away from the
    border (the 663 of 12544 pixels of a 224x224 frame in rows and columns
    0, 1 and 111 are the border), and a map that differs there, one
    entry's ones_conv off by one, is refused."""
    plan = T.prepare_int8_static(trunk["tqp"], trunk["tscales"],
                                 int8_root="u8")
    mask = R.border_mask(224, 224, "wfold")
    assert int(mask.sum()) == 663
    assert mask[:, [0, 1, 111]].all() and mask[[0, 1, 111]].all()
    assert not mask[2:111, 2:111].any()
    add, border = T._root_add(plan["root"], 30, 38)
    inner = ~R.border_mask(30, 38, "wfold")
    assert torch.equal(border[inner], add.expand(int(inner.sum()), 64))
    assert not torch.equal(border[~inner],
                           add.expand(int((~inner).sum()), 64))
    real = T.root_conv_reference

    def doctored(q, wt, fold):
        acc = real(q, wt, fold)
        acc[0, 7, 9, 5] += 1
        return acc

    monkeypatch.setattr(T, "root_conv_reference", doctored)
    fresh = T.prepare_int8_static(trunk["tqp"], trunk["tscales"],
                                  int8_root="u8")
    with pytest.raises(RuntimeError, match="border map"):
        T._run_stem(fresh["root"], torch.zeros(1, 30, 38, 3,
                                               dtype=torch.uint8))


def test_root_stem_pool_reads_the_border_map_only_at_the_border():
    """root_stem_pool on the CPU: the pool of the plain stem with add at the
    interior and border's entries at the border, whatever border holds
    elsewhere; the pre-activation modes; the operands it refuses."""
    x, wt, mul, add = _stem_operands("cpu", 2, 30, 38, "wfold", "u8")
    border = add
    add = torch.randn(64, generator=torch.Generator().manual_seed(3))
    mask = R.border_mask(30, 38, "wfold")
    full = torch.where(mask[..., None], border, add)
    want = R.max_pool_s8_reference(R.root_stem_reference(
        x, wt, mul, full, fold="wfold", kind="u8"))
    got = R.root_stem_pool(x, wt, mul, add, fold="wfold", kind="u8",
                           border=border)
    assert got.shape == (2, 8, 10, 64) and torch.equal(got, want)
    assert not torch.equal(got, R.max_pool_s8_reference(
        R.root_stem_reference(x, wt, mul, border, fold="wfold", kind="u8")))
    g = torch.Generator().manual_seed(4)
    pa, pb = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g)
    for pre in (K.Preact(pa * 0.1, pb, None, 2),
                K.Preact(pa.to(torch.bfloat16).float(),
                         pb.to(torch.bfloat16).float(),
                         torch.tensor([0.05]), 3, torch.tensor([0.0390625]))):
        pq = R.root_stem_pool(x, wt, mul, add, fold="wfold", kind="u8",
                              border=border, preact=pre)
        assert torch.equal(pq, K.preact_quant_reference(
            want, pre.pa, pre.pb, pre.s, mode=pre.mode, ds=pre.ds))
    with pytest.raises(ValueError, match="map goes in border"):
        R.root_stem_pool(x, wt, mul, border, fold="wfold", kind="u8")
    with pytest.raises(ValueError, match="border must be"):
        R.root_stem_pool(x, wt, mul, add, fold="wfold", kind="u8",
                         border=border[:, :-1])
    with pytest.raises(ValueError, match="mode 2 or 3"):
        R.root_stem_pool(x, wt, mul, add, fold="wfold", kind="u8",
                         preact=K.Preact(pa, pb, None, 0))


def _stream_operands(rng, n=4, h=14, c=64, cb=32):
    hq = rng.randint(0, 128, (n, h, h, cb)).astype(np.int8)
    w3 = rng.randint(-127, 128, (1, 1, cb, c)).astype(np.int8)
    scale3 = (rng.rand(c) * 1e-3).astype(np.float32)
    bias3 = rng.randn(c).astype(np.float32)
    x = rng.randint(-127, 128, (n, 2 * h, 2 * h, c)).astype(np.int8)
    sc = rng.randn(n, h, h, c).astype(np.float32) * 3
    A = (rng.rand(c) + 0.5).astype(np.float32)
    B = (rng.randn(c) * 0.3).astype(np.float32)
    s = dict(s_h=np.float32(0.0211), s_out=np.float32(0.0833),
             s_in=np.float32(0.0372), s_p=np.float32(0.0521))
    return hq, w3, scale3, bias3, x, sc, A, B, s


@pytest.mark.parametrize("shortcut", ["int8_strided", "int8", "bf16"])
def test_stream_epilogue_and_preacts_match_jax(trunk, shortcut):
    """conv3's stream epilogue (resnet_int8.py:633-650) with each shortcut
    and the next unit's mode-2 pre-activation (:565-576), and mode 3 (the
    dequantise boundary, :540-542, then :578-589), against the JAX
    expressions jitted with a conv in front, on 50176 elements: equal."""
    jax, jnp = trunk["jax"], trunk["jnp"]
    rng = np.random.RandomState(3)
    hq, w3, scale3, bias3, x, sc, A, B, s = _stream_operands(rng)
    stride = 2 if shortcut == "int8_strided" else 1
    if shortcut == "int8":
        x = x[:, ::2, ::2].copy()
    sc_bf = jnp.asarray(sc).astype(jnp.bfloat16)

    def unit(hq, w3, scale3, bias3, x, sc, A, B, s_h, s_out, s_in, s_p):
        y = jax.lax.conv_general_dilated(
            hq, w3, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                       "NHWC"),
            preferred_element_type=jnp.int32)
        res = y.astype(jnp.float32) * (s_h * scale3 / s_out) + bias3 / s_out
        if shortcut == "bf16":
            res = res + sc.astype(jnp.float32) / s_out
        else:
            sub = x if stride == 1 else x[:, ::stride, ::stride, :]
            res = res + sub.astype(jnp.float32) * (s_in / s_out)
        out = jnp.clip(jnp.round(res), -127, 127).astype(jnp.int8)
        pq2 = jnp.clip(jnp.round(jnp.maximum(
            out.astype(jnp.float32) * (s_out * A / s_p) + B / s_p, 0)),
            0, 127).astype(jnp.int8)
        xb = out.astype(jnp.bfloat16) * s_out.astype(jnp.bfloat16)
        p3 = jnp.maximum(xb * A.astype(jnp.bfloat16)
                         + B.astype(jnp.bfloat16), 0)
        pq3 = jnp.clip(jnp.round(p3.astype(jnp.float32) / s_p), 0,
                       127).astype(jnp.int8)
        return out, pq2, pq3

    want = [np.asarray(t) for t in jax.jit(unit)(
        hq, w3, scale3, bias3, x, sc_bf, A, B, s["s_h"], s["s_out"],
        s["s_in"], s["s_p"])]
    t = {k: torch.tensor(v) for k, v in s.items()}
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    m3 = t["s_h"] * torch.from_numpy(scale3) / t["s_out"]
    a3 = torch.from_numpy(bias3) / t["s_out"]
    if shortcut == "bf16":
        residual = torch.from_numpy(np.asarray(sc_bf.astype(jnp.float32)))
        residual, res_scale = residual.to(torch.bfloat16), t["s_out"]
    else:
        residual, res_scale = torch.from_numpy(x), t["s_in"] / t["s_out"]
    common = dict(epilogue="stream", mul=m3, add=a3, residual=residual,
                  res_scale=res_scale.reshape(1), res_stride=stride)
    two = K.Preact(t["s_out"] * tA / t["s_p"], tB / t["s_p"], None, 2)
    three = K.Preact(tA.to(torch.bfloat16).float(),
                     tB.to(torch.bfloat16).float(), t["s_p"].reshape(1), 3,
                     t["s_out"].to(torch.bfloat16).float().reshape(1))
    wt = K.hwio_to_kmajor(torch.from_numpy(w3))
    out, pq2 = K.conv_s8(torch.from_numpy(hq), wt, 1, preact=two, **common)
    out3, pq3 = K.conv_s8(torch.from_numpy(hq), wt, 1, preact=three,
                          **common)
    for got, w in ((out, want[0]), (out3, want[0]), (pq2, want[1]),
                   (pq3, want[2])):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), w)
    # The standalone pass reads the int8 stream the same way.
    for pre, w in ((two, want[1]), (three, want[2])):
        np.testing.assert_array_equal(
            K.preact_quant(out, pre.pa, pre.pb, pre.s, mode=pre.mode,
                           ds=pre.ds).numpy(), w)


def test_stream_operands_are_checked():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(8, 16, dtype=torch.int8)
    one, s = torch.ones(8), torch.ones(1)
    res = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="needs a residual"):
        K.conv_s8(x, w, epilogue="stream", mul=one, add=one, res_scale=s)
    with pytest.raises(ValueError, match="res_scale"):
        K.conv_s8(x, w, epilogue="stream", mul=one, add=one, residual=res)
    with pytest.raises(ValueError, match="residual shape"):
        K.conv_s8(x, w, epilogue="stream", mul=one, add=one, residual=res,
                  res_scale=s, res_stride=2)
    with pytest.raises(ValueError, match="strided"):
        K.conv_s8(x, w, epilogue="stream", mul=one, add=one, residual=res.to(
            torch.bfloat16), res_scale=s, res_stride=2)
    with pytest.raises(ValueError, match="mode-1"):
        K.conv_s8(x, w, epilogue="stream", mul=one, add=one, residual=res,
                  res_scale=s, preact=K.Preact(one, one, s, 1))
    with pytest.raises(ValueError, match="mode-2"):
        K.conv_s8(x, w, epilogue="dequant", mul=one, add=one,
                  preact=K.Preact(one, one, None, 2))
    with pytest.raises(ValueError, match="ds"):
        K.preact_quant(res, one, one, s, mode=3)
    with pytest.raises(ValueError, match="takes int8"):
        K.preact_quant(res.to(torch.bfloat16), one, one, mode=2)
    with pytest.raises(ValueError, match="mode 0 or 1"):
        K.fused_block_pq(torch.zeros(1, 2, 2, 16, dtype=torch.bfloat16), [],
                         h=2, w=2, unit_specs=(),
                         next_preact=K.Preact(one, one, None, 2))


def test_stem_refuses_what_it_does_not_take(trunk):
    plan = T.prepare_int8_static(trunk["tqp"], trunk["tscales"],
                                 int8_root=True)
    with pytest.raises(ValueError, match="H and W even"):
        T._run_stem(plan["root"], torch.zeros(1, 7, 8, 3))
    with pytest.raises(ValueError, match="int8_root='u8'"):
        T._run_stem(plan["root"], torch.zeros(1, 8, 8, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="W even"):
        R.root_geometry(8, 9, "wfold")
    for bad in (dict(int8_root="s2d"), dict(int8_root=2),
                dict(int8_stream=(5,))):
        with pytest.raises(ValueError):
            T.prepare_int8_static(trunk["tqp"], trunk["tscales"], **bad)


# ---------------------------------------------------------------------------
# The trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,opts,u8", TRUNK_CASES,
                         ids=[c[0] for c in TRUNK_CASES])
def test_trunk_matches_jax(trunk, name, opts, u8):
    """apply_int8_static on every int8_root / int8_stream case against
    JAX's jitted apply_int8_static: phi equal (the K2 case rel 1e-4)."""
    images = trunk["raw"] if u8 else trunk["x"]
    got = T.apply_int8_static(trunk["tqp"], trunk["tscales"], images,
                              **opts).numpy()
    want = trunk["out"][name]
    assert got.shape == (2, 2048) and got.dtype == np.float32
    if opts.get("use_pallas"):
        assert _rel(got, want) <= 1e-4
    else:
        np.testing.assert_array_equal(got, want)


def _counting(monkeypatch, module, names):
    calls = {n: [] for n in names}
    for n in names:
        real = getattr(module, n)
        monkeypatch.setattr(module, n, lambda *a, _n=n, _r=real, **kw: (
            calls[_n].append((a, kw)) or _r(*a, **kw)))
    return calls


@pytest.mark.parametrize("name,opts,u8", TRUNK_CASES[:1] + TRUNK_CASES[4:],
                         ids=[c[0] for c in TRUNK_CASES[:1]
                              + TRUNK_CASES[4:]])
def test_plan_launches_predicts_the_calls(trunk, monkeypatch, name, opts,
                                          u8):
    """plan_launches against the wrappers' calls of one run: the fused
    stem and pool, the convs by epilogue, K2's units, the standalone
    pre-activations, and every pre-activation by mode."""
    plan = T.prepare_int8_static(trunk["tqp"], trunk["tscales"], **opts)
    want = T.plan_launches(plan)
    calls = _counting(monkeypatch, T, ["conv_s8", "preact_quant",
                                       "root_stem_pool", "fused_block_pq"])
    T.run_int8_static(plan, trunk["x"])
    epis = {e: sum(kw.get("epilogue") == e for _, kw in calls["conv_s8"])
            for e in want["conv"]}
    assert epis == want["conv"]
    assert sum(want["conv"].values()) == len(calls["conv_s8"])
    assert len(calls["root_stem_pool"]) == want["root_pool"]
    assert len(calls["preact_quant"]) == want["preact"]
    assert sum(len(a[1]) for a, _ in calls["fused_block_pq"]) == want["block"]
    modes = {m: 0 for m in K.PREACT_MODES}
    for _, kw in calls["conv_s8"] + calls["root_stem_pool"]:
        if kw.get("preact") is not None:
            modes[kw["preact"].mode] += 1
    for _, kw in calls["preact_quant"]:
        modes[kw["mode"]] += 1
    for _, kw in calls["fused_block_pq"]:
        if kw.get("next_preact") is not None:
            modes[kw["next_preact"].mode] += 1
    assert modes == want["preact_modes"]


def test_plan_pre_activation_sources(trunk):
    """Where each first unit's pre-activation comes from: the int8 pool
    (mode 3 into bf16 block 1; mode 2 into a streamed one), the stream's
    conv3 (mode 2 inside a streamed block, mode 3 across an int8 -> bf16
    boundary), a standalone mode-2 pass after a bf16 -> int8 quantise, and
    nothing for a K2 chain after a dequantise (it reads the bf16 map)."""
    tqp, ts = trunk["tqp"], trunk["tscales"]
    p = T.prepare_int8_static(tqp, ts, int8_root=True)
    assert p["pool_preact"].mode == 3 and p["steps"][0]["pq_from"] == "producer"
    assert T.plan_launches(p)["preact"] == 0
    p = T.prepare_int8_static(tqp, ts, int8_root="u8", int8_stream=(1,))
    assert p["pool_preact"].mode == 2
    assert [u["next"].mode for u in p["steps"][:3]] == [2, 2, 3]
    p = T.prepare_int8_static(tqp, ts, int8_stream=(2,))
    enter = [u for u in p["steps"] if u["enter"] is not None]
    assert [u["enter"][0] for u in enter] == ["quantise", "dequant"]
    assert [u["pq_from"] for u in enter] == ["standalone", "producer"]
    assert T.plan_launches(p)["preact_modes"] == {0: 0, 1: 11, 2: 4, 3: 1}
    p = T.prepare_int8_static(tqp, ts, use_pallas=True, int8_stream=(1,))
    assert p["steps"][3]["kind"] == "k2"
    assert p["steps"][3]["pq_from"] == "none" and p["steps"][2]["next"] is None
    assert p["head"]["stream_scale"] is None
    p = T.prepare_int8_static(tqp, ts, int8_stream=True)
    assert p["head"]["stream_scale"] is not None
    assert T.plan_launches(p)["conv"] == {"dequant": 4, "requant": 32,
                                          "stream": 16}


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (GPU only)
# ---------------------------------------------------------------------------


def _stem_operands(dev, n, h, w, fold, kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    if kind == "u8":
        x = torch.randint(0, 256, (n, h, w, 3), generator=g,
                          dtype=torch.uint8)
    else:
        x = torch.rand(n, h, w, 3, generator=g) * 2.2 - 1.1
    wt = torch.randint(-127, 128, (64, R.ROOT_K[fold]), generator=g,
                       dtype=torch.int8)
    mul = torch.rand(64, generator=g) * 1e-3 + 1e-5
    ho, wo = R.root_geometry(h, w, fold)
    add = (torch.randn(ho, wo, 64, generator=g) if kind == "u8"
           else torch.randn(64, generator=g))
    return [t.to(dev) for t in (x, wt, mul, add)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [-1, 2, 3])
@pytest.mark.parametrize("n,h,w", [(8, 224, 224), (3, 64, 64), (2, 30, 38),
                                   (1, 30, 302)])
@pytest.mark.parametrize("fold,kind", [("s2d", "f32"), ("wfold", "f32"),
                                       ("wfold", "u8_float"),
                                       ("wfold", "u8")])
def test_cuda_root_stem_pool_matches_plain(cuda_device, fold, kind, n, h, w,
                                           mode):
    """The fused stem + pool kernel against its plain version, with and
    without a border map, in each mode: equal. 30x38 has odd stem sizes
    (a leading pool pad), 30x302 is split into column bands (Wo = 151)."""
    x, wt, mul, border = _stem_operands(cuda_device, n, h, w, fold, kind)
    if border.dim() == 1:
        ho, wo = R.root_geometry(h, w, fold)
        border = torch.randn(ho, wo, 64, device=cuda_device)
    add = torch.randn(64, device=cuda_device)
    g = torch.Generator().manual_seed(mode + 10)
    pa = (torch.rand(64, generator=g) + 0.5).to(cuda_device)
    pb = torch.randn(64, generator=g).to(cuda_device)
    pre = {-1: None,
           2: K.Preact(pa * 0.1, pb, None, 2),
           3: K.Preact(pa.to(torch.bfloat16).float(),
                       pb.to(torch.bfloat16).float(),
                       torch.tensor([0.05], device=cuda_device), 3,
                       torch.tensor([0.0390625], device=cuda_device))}[mode]
    for b in (None, border):
        before = R.LAUNCHES[R.STEM_POOL]
        got = R.root_stem_pool(x, wt, mul, add, fold=fold, kind=kind,
                               preact=pre, border=b)
        torch.cuda.synchronize()
        assert R.LAUNCHES[R.STEM_POOL] == before + 1
        want = R.root_stem_pool_reference(x, wt, mul, add, fold=fold,
                                          kind=kind, preact=pre, border=b)
        assert got.shape == want.shape
        assert float((got.float() - want.float()).abs().max()) == 0.0


def _misaligned(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary,
    as a slice of frames can."""
    buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8,
                      device=t.device)
    off = (4 - buf.data_ptr()) % 16
    out = buf[off:off + t.numel() * t.element_size()].view(t.dtype).view(
        t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fold,kind", [("s2d", "f32"), ("wfold", "f32"),
                                       ("wfold", "u8_float"),
                                       ("wfold", "u8")])
def test_cuda_root_stem_pool_takes_misaligned_frames(cuda_device, fold,
                                                     kind):
    """Frames and a border map that do not start on 16 bytes (x[1:] of
    uint8 30x38 frames, say) run, and equal the plain version."""
    x, wt, mul, border = _stem_operands(cuda_device, 3, 30, 38, fold, kind)
    if border.dim() == 1:
        ho, wo = R.root_geometry(30, 38, fold)
        border = torch.randn(ho, wo, 64, device=cuda_device)
    add = torch.randn(64, device=cuda_device)
    xs, bs = _misaligned(x[1:]), _misaligned(border)
    got = R.root_stem_pool(xs, wt, mul, add, fold=fold, kind=kind, border=bs)
    want = R.root_stem_pool_reference(x[1:], wt, mul, add, fold=fold,
                                      kind=kind, border=border)
    assert float((got.float() - want.float()).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shortcut", ["int8_strided", "int8", "bf16"])
def test_cuda_stream_epilogue_matches_plain(cuda_device, shortcut):
    """The stream epilogue at block 1's stride-2 unit's shapes (8 frames),
    each shortcut, with the mode-2 and mode-3 pre-activations fused, and
    the standalone mode-2 / mode-3 pass."""
    g = torch.Generator().manual_seed(1)
    dev = cuda_device
    n, h, c, cb = 8, 28, 256, 64
    hq = torch.randint(0, 128, (n, h, h, cb), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (c, cb), generator=g, dtype=torch.int8)
    mul = torch.rand(c, generator=g) * 1e-3
    add = torch.randn(c, generator=g)
    big = torch.randint(-127, 128, (n, 2 * h, 2 * h, c), generator=g,
                        dtype=torch.int8)
    if shortcut == "int8_strided":
        residual, stride = big, 2
    elif shortcut == "int8":
        residual, stride = big[:, ::2, ::2].contiguous(), 1
    else:
        residual = (torch.randn(n, h, h, c, generator=g) * 3).to(
            torch.bfloat16)
        stride = 1
    pa, pb = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)
    pres = (K.Preact(pa * 0.1, pb, None, 2),
            K.Preact(pa.to(torch.bfloat16).float(),
                     pb.to(torch.bfloat16).float(), torch.tensor([0.05]), 3,
                     torch.tensor([0.0390625])))
    args = [t.to(dev) for t in (hq, wt, mul, add, residual)]
    kw = dict(epilogue="stream", mul=args[2], add=args[3],
              residual=args[4], res_scale=torch.tensor([0.7], device=dev),
              res_stride=stride)
    acc = K.conv_s8_reference(args[0], args[1])
    for pre in pres:
        pre = K.Preact(*[t.to(dev) if isinstance(t, torch.Tensor) else t
                         for t in pre])
        before = K.EPILOGUE_LAUNCHES["stream"]
        got = K.conv_s8(args[0], args[1], **kw, preact=pre)
        want = K.epilogue_reference(acc, **kw, preact=pre)
        torch.cuda.synchronize()
        assert K.EPILOGUE_LAUNCHES["stream"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        alone = K.preact_quant(want[0].contiguous(), pre.pa, pre.pb, pre.s,
                               mode=pre.mode, ds=pre.ds)
        assert torch.equal(alone, want[1])
