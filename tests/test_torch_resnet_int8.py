"""The port's int8 encoder (models/resnet_int8, ops/resnet_int8_cuda) against
the JAX package's, and its CUDA kernels against their plain versions.

The JAX side is the ``trunk`` fixture of tests/test_resnet_int8.py: a
full-width ResNet-50 v2 at 2x64x64, seed 5, with randomised BN statistics.
Its quantised weights and calibrated scales are carried into the port by
``utils.weights.load_jax_int8``, so that the trunks are compared on the same
operands. Tolerances:

- int8 weights, int32 accumulators and the XLA-path phi: equal (the port
  keeps the JAX expression order and its bf16 roundings).
- BN-folded multipliers: rtol 1e-6 (XLA's rsqrt and torch's differ by an
  ulp); calibrated scales: rtol 1e-5.
- The K2 path against JAX's Pallas kernel in interpret mode: rel 1e-4 (it
  is equal when the four multiply-adds are fused where XLA fuses them, and
  6e-3 when they are not).
- The dynamic path: rel 1e-3.

JAX is imported inside fixtures, so that the CUDA cases also run where JAX
is not installed:
``python -m pytest tests/test_torch_resnet_int8.py --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.models import resnet_int8 as T
from human_dynamics_tpu_torch.models.resnet import ResNetV2_50
from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
from human_dynamics_tpu_torch.utils.precision import to_bf16
from human_dynamics_tpu_torch.utils.weights import (
    load_jax_int8,
    load_jax_variables,
)

torch.set_num_threads(1)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def trunk():
    """The JAX trunk, its int8 params (eager, as tests/test_resnet_int8.py
    makes them), scales and outputs; the port trunk on the same weights."""
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
    static = jax.jit(
        lambda q, s, im, pallas: J.apply_int8_static(q, s, im,
                                                     use_pallas=pallas),
        static_argnums=3,
    )
    out = {
        "xla": np.asarray(static(qp, scales, x, False)),
        "k2": np.asarray(static(qp, scales, x, True)),
        "dynamic": np.asarray(jax.jit(J.apply_int8)(qp, x)),
    }
    port = ResNetV2_50(device="meta").to_empty(device="cpu")
    load_jax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    tqp, tscales = load_jax_int8(_np(qp), _np(scales))
    return {
        "J": J, "jnp": jnp, "qp": _np(qp), "scales": _np(scales),
        "out": out, "x": torch.from_numpy(np.array(x)), "port": port,
        "tqp": tqp, "tscales": tscales,
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_prepare_int8_params_matches_jax(trunk):
    got = T.prepare_int8_params(trunk["port"])
    want = trunk["qp"]
    assert set(got) == set(want) - set(T.INT8_ROOT_KEYS)
    for k, v in got.items():
        w = want[k]
        if k.endswith("/wq"):
            assert v.dtype == torch.int8, k
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        elif k in ("root/w", "root/b"):
            assert v.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(v.float().numpy(),
                                          w.astype(np.float32), err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-6, atol=1e-30,
                                       err_msg=k)


def test_calibrated_scales_match_jax(trunk):
    got = T.calibrate_int8_scales(trunk["tqp"], trunk["x"])
    assert set(got) == set(trunk["scales"])
    assert len(got) == 16 * 4 + 1
    for k, v in got.items():
        np.testing.assert_allclose(float(v), trunk["scales"][k], rtol=1e-5,
                                   err_msg=k)
    # margin multiplies every scale; merge takes the elementwise max.
    wider = T.calibrate_int8_scales(trunk["tqp"], trunk["x"], margin=2.0)
    merged = T.merge_calibrations(got, wider)
    for k in got:
        assert float(merged[k]) == float(wider[k]) == 2.0 * float(got[k])


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("ks,stride", [(1, 1), (3, 1), (3, 2), (1, 2)])
def test_conv_s8_reference_matches_lax(trunk, ks, stride, size):
    """The plain int8 conv against jax.lax.conv_general_dilated (the JAX
    package's _conv_s8) on odd and even maps: int32 outputs equal."""
    rng = np.random.RandomState(ks * 10 + stride + size)
    x = rng.randint(-127, 128, (2, size, size, 32)).astype(np.int8)
    w = rng.randint(-127, 128, (ks, ks, 32, 24)).astype(np.int8)
    jnp = trunk["jnp"]
    want = np.asarray(trunk["J"]._conv_s8(jnp.asarray(x), jnp.asarray(w),
                                          stride))
    got = K.conv_s8(torch.from_numpy(x), K.hwio_to_kmajor(torch.from_numpy(w)),
                    stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_static_xla_path_phi_equals_jax(trunk):
    got = T.apply_int8_static(trunk["tqp"], trunk["tscales"], trunk["x"])
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), trunk["out"]["xla"])


def test_static_k2_path_matches_jax_interpret(trunk):
    got = T.apply_int8_static(trunk["tqp"], trunk["tscales"], trunk["x"],
                              use_pallas=True).numpy()
    assert _rel(got, trunk["out"]["k2"]) <= 1e-4


def test_dynamic_path_matches_jax(trunk):
    got = T.apply_int8(trunk["tqp"], trunk["x"]).numpy()
    assert _rel(got, trunk["out"]["dynamic"]) <= 1e-3


def test_prepare_pallas_unit_matches_jax(trunk):
    """K2's operands: the JAX ones, with the weights transposed to k-major
    and the (1, C) multipliers flattened."""
    from human_dynamics_tpu.ops import resnet_int8_pallas as P

    pre = "block2/unit_1/bottleneck_v2/"
    jnp = trunk["jnp"]
    want = P.prepare_pallas_unit(
        {k: jnp.asarray(v) for k, v in trunk["qp"].items()},
        {k: jnp.asarray(v) for k, v in trunk["scales"].items()}, pre, True)
    got = K.prepare_pallas_unit(trunk["tqp"], trunk["tscales"], pre, True)
    assert set(got) == set(K.SC_KEYS) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        w = w.T if k.startswith("w") else w.reshape(-1)
        np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


def _random_unit(rng, cin, cb, cout):
    """Operands of one unit in the JAX layout, as in
    tests/test_resnet_int8.py::test_pallas_unit_matches_dense_oracle."""
    def mk(shape, scale=1.0):
        return rng.randn(*shape).astype(np.float32) * scale

    def mki8(shape):
        return rng.randint(-127, 128, shape).astype(np.int8)

    params = {
        "pA": np.abs(mk((1, cin))) + 0.5,
        "pB": mk((1, cin), 0.3),
        "w1": mki8((cin, cb)),
        "q1m": np.abs(mk((1, cb), 1e-3)) + 1e-4,
        "q1a": mk((1, cb), 0.3),
        "w2": mki8((3, 3, cb, cb)).reshape(9 * cb, cb),
        "q2m": np.abs(mk((1, cb), 1e-4)) + 1e-5,
        "q2a": mk((1, cb), 0.3),
        "w3": mki8((cb, cout)),
        "d3m": np.abs(mk((1, cout), 1e-4)) + 1e-5,
        "d3a": mk((1, cout), 0.1),
        "wsc": mki8((cin, cout)),
        "dscm": np.abs(mk((1, cout), 1e-3)) + 1e-4,
        "dsca": mk((1, cout), 0.1),
    }
    return params


def _port_unit(params):
    return {
        k: torch.from_numpy(np.ascontiguousarray(
            v.T if k.startswith("w") else v.reshape(-1)))
        for k, v in params.items()
    }


@pytest.mark.parametrize("has_shortcut", [False, True])
def test_fused_bottleneck_unit_matches_jax_interpret(trunk, has_shortcut):
    """One K2 unit on the CPU (the plain version) against the Pallas kernel
    in interpret mode, n=2, 6x5, Cin 16, Cb 8, Cout 16: equal."""
    from human_dynamics_tpu.ops.resnet_int8_pallas import (
        fused_bottleneck_unit as jax_unit,
    )

    jnp = trunk["jnp"]
    rng = np.random.RandomState(3)
    params = _random_unit(rng, 16, 8, 16)
    if not has_shortcut:
        params = {k: v for k, v in params.items() if k in K.PARAM_KEYS}
    x = (rng.randn(2, 6, 5, 16).astype(np.float32) * 0.5)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_unit(xj, {k: jnp.asarray(v) for k, v in params.items()},
                    h=6, w=5, has_shortcut=has_shortcut, interpret=True)
    got = K.fused_bottleneck_unit(
        torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16),
        _port_unit(params), h=6, w=5, has_shortcut=has_shortcut,
    )
    assert got.dtype == torch.bfloat16 and got.shape == (2, 6, 5, 16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_unported_int8_options_raise(trunk):
    for opt in ("int8_stream", "int8_root"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.apply_int8_static(trunk["tqp"], trunk["tscales"], trunk["x"],
                                **{opt: True})


def test_load_jax_int8_is_strict(trunk):
    qp = dict(trunk["qp"])
    # The int8_root keys are dropped by name and nothing else.
    tqp, _ = load_jax_int8(qp, None)
    assert not set(T.INT8_ROOT_KEYS) & set(tqp)
    with pytest.raises(ValueError, match="no port counterpart"):
        load_jax_int8({**qp, "root/extra": qp["root/b32"]}, None)
    qp.pop("block4/unit_3/bottleneck_v2/conv3/wq")
    with pytest.raises(ValueError, match="missing"):
        load_jax_int8(qp, None)
    with pytest.raises(ValueError, match="shape"):
        load_jax_int8(trunk["qp"], {"root/out": np.ones(2, np.float32)})


def test_to_bf16_casts_floats_only():
    net = torch.nn.Linear(3, 2)
    net.register_buffer("steps", torch.zeros(2, dtype=torch.int64))
    assert to_bf16(net) is net
    assert net.weight.dtype == net.bias.dtype == torch.bfloat16
    assert net.steps.dtype == torch.int64
    d = to_bf16({"a": torch.ones(2), "q": torch.ones(2, dtype=torch.int8)})
    assert d["a"].dtype == torch.bfloat16 and d["q"].dtype == torch.int8


def test_wrappers_check_operands():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="k\\*k\\*Cin"):
        K.conv_s8(x, torch.zeros(8, 20, dtype=torch.int8))
    with pytest.raises(ValueError, match="mul"):
        K.conv_s8(x, w, epilogue="requant")
    with pytest.raises(ValueError, match="residual"):
        K.conv_s8(x, w, epilogue="residual", mul=torch.ones(8),
                  add=torch.zeros(8))
    with pytest.raises(ValueError, match="int8"):
        K.conv_s8(x.float(), w)
    with pytest.raises(ValueError, match="CUDA or all CPU"):
        K.conv_s8(x, w.to("meta"))
    with pytest.raises(ValueError, match="bf16"):
        K.preact_quant(torch.zeros(2, 16), torch.ones(16), torch.zeros(16))


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (GPU only)
# ---------------------------------------------------------------------------

# (n, h, w, cin, cout, k, stride): the trunk's geometries at small n, plus
# ragged M and N tiles.
CUDA_CONVS = [
    (2, 56, 56, 64, 64, 1, 1), (2, 56, 56, 64, 64, 3, 1),
    (2, 56, 56, 64, 64, 3, 2), (2, 56, 56, 256, 512, 1, 2),
    (3, 14, 14, 256, 1024, 1, 1), (3, 7, 7, 512, 512, 3, 1),
    (1, 9, 11, 32, 40, 3, 2),
]


def _cuda_inputs(dev, n, h, w, cin, cout, k, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                       dtype=torch.int8)
    mul = torch.rand(cout, generator=g) * 1e-4 + 1e-6
    add = torch.randn(cout, generator=g)
    return [t.to(dev) for t in (x, wt, mul, add)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", CUDA_CONVS)
def test_cuda_conv_matches_plain(cuda_device, geom):
    n, h, w, cin, cout, k, stride = geom
    x, wt, mul, add = _cuda_inputs(cuda_device, *geom[:6])
    want = K.conv_s8_reference(x, wt, stride)
    before = K.LAUNCHES[K.CONV]
    got = K.conv_s8(x, wt, stride)
    torch.cuda.synchronize()
    assert K.LAUNCHES[K.CONV] == before + 1
    assert torch.equal(got, want)
    res_bf = torch.randn(want.shape, device=cuda_device).to(torch.bfloat16)
    res_f = torch.randn(want.shape, device=cuda_device)
    for epi, kw in (
        ("requant", dict(relu=True)), ("requant", dict(fma=True)),
        ("dequant", dict(relu=True)), ("dequant", dict(residual=res_bf)),
        ("dequant_f32", {}), ("residual", dict(residual=res_f)),
        ("residual", dict(residual=res_bf)),
    ):
        got = K.conv_s8(x, wt, stride, epilogue=epi, mul=mul, add=add, **kw)
        plain = K.epilogue_reference(want, epi, mul, add, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), (epi, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
def test_cuda_preact_matches_plain(cuda_device, mode):
    g = torch.Generator(device="cpu").manual_seed(mode)
    x = (torch.randn(3, 14, 14, 256, generator=g) * 2).to(torch.bfloat16)
    pa = torch.rand(256, generator=g) + 0.5
    pb = torch.randn(256, generator=g) * 0.3
    if mode == 1:
        pa, pb = pa.to(torch.bfloat16).float(), pb.to(torch.bfloat16).float()
    s = torch.tensor([0.05])
    x, pa, pb, s = (t.to(cuda_device) for t in (x, pa, pb, s))
    got = K.preact_quant(x, pa, pb, s, mode=mode)
    want = K.preact_quant_reference(x, pa, pb, s, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cb,cout,h", [(256, 128, 512, 28),
                                           (512, 128, 512, 28),
                                           (1024, 512, 2048, 7)])
def test_cuda_fused_block_matches_plain(cuda_device, cin, cb, cout, h):
    """K2 on two units (the first with a projection shortcut when
    Cin != Cout) against fused_block_reference on the card."""
    rng = np.random.RandomState(cin + h)
    first = _port_unit(_random_unit(rng, cin, cb, cout))
    second = _port_unit(_random_unit(rng, cout, cb, cout))
    has_sc = cin != cout
    if not has_sc:
        first = {k: v for k, v in first.items() if k in K.PARAM_KEYS}
    second = {k: v for k, v in second.items() if k in K.PARAM_KEYS}
    units = [{k: v.to(cuda_device) for k, v in u.items()}
             for u in (first, second)]
    x = torch.from_numpy(rng.randn(4, h, h, cin).astype(np.float32) * 0.5)
    x = x.to(torch.bfloat16).to(cuda_device)
    kw = dict(h=h, w=h, unit_specs=(has_sc, False))
    before = K.LAUNCHES[K.BLOCK]
    got = K.fused_block(x, units, **kw)
    torch.cuda.synchronize()
    # One pre-activation and three convs per unit, plus the shortcut conv.
    assert K.LAUNCHES[K.BLOCK] == before + 2 * 4 + has_sc
    want = K.fused_block_reference(x, units, **kw)
    assert torch.equal(got, want)
