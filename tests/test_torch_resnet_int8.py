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
    assert set(got) == set(want)
    assert set(T.INT8_ROOT_KEYS) <= set(got)
    for k, v in got.items():
        w = want[k]
        if "/wq" in k:
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


def test_load_jax_int8_is_strict(trunk):
    qp = dict(trunk["qp"])
    # Every key is carried, the int8_root stems' included.
    tqp, _ = load_jax_int8(qp, None)
    assert set(tqp) == set(qp)
    for k in T.INT8_ROOT_KEYS:
        np.testing.assert_array_equal(tqp[k].numpy(), qp[k])
    with pytest.raises(ValueError, match="missing"):
        load_jax_int8({k: v for k, v in qp.items() if k != "root/wq_s2d"},
                      None)
    with pytest.raises(ValueError, match="no port counterpart"):
        load_jax_int8({**qp, "root/extra": qp["root/b32"]}, None)
    qp.pop("block4/unit_3/bottleneck_v2/conv3/wq")
    with pytest.raises(ValueError, match="missing"):
        load_jax_int8(qp, None)
    with pytest.raises(ValueError, match="shape"):
        load_jax_int8(trunk["qp"], {"root/out": np.ones(2, np.float32)})


def _unfused_static(plan, images):
    """run_int8_static as it was before the pre-activations were fused: a
    standalone preact_quant per unit (fused_block_reference for K2); the
    epilogues' multiply-adds fused, as XLA contracts them."""
    x = T._root(plan["head"], images)
    for u in plan["steps"]:
        if u["kind"] == "k2":
            x = K.fused_block_reference(x, u["params"], h=x.shape[1],
                                        w=x.shape[2],
                                        unit_specs=tuple(u["specs"]))
            continue
        stride = u["stride"]
        pq = K.preact_quant(x, u["pa"], u["pb"], u["s_p"], mode=1)
        if "wsc" in u:
            shortcut = K.conv_s8(pq, u["wsc"], stride, epilogue="dequant",
                                 mul=u["msc"], add=u["asc"], fma=True)
        else:
            shortcut = T._subsample(x, stride)
        h = K.conv_s8(pq, u["w1"], 1, epilogue="requant", mul=u["m1"],
                      add=u["a1"], relu=True, fma=True)
        h = K.conv_s8(h, u["w2"], stride, epilogue="requant", mul=u["m2"],
                      add=u["a2"], relu=True, fma=True)
        x = K.conv_s8(h, u["w3"], 1, epilogue="dequant", mul=u["m3"],
                      add=u["a3"], residual=shortcut, fma=True)
    return T._head(plan["head"], x)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_preact_plan_equals_unfused(trunk, use_pallas, monkeypatch):
    """The static trunk with every pre-activation but the first fused into
    the conv before it: phi bit-equal to the unfused composition, with one
    standalone preact_quant per call."""
    plan = T.prepare_int8_static(trunk["tqp"], trunk["tscales"],
                                 use_pallas=use_pallas)
    assert plan["steps"][-1]["next"] is None
    assert all(u["next"] is not None for u in plan["steps"][:-1])
    assert plan["first"].mode == 1  # block 1 unit 1 is never a K2 unit
    calls = []
    real = T.preact_quant
    monkeypatch.setattr(T, "preact_quant",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    got = T.run_int8_static(plan, trunk["x"])
    assert len(calls) == 1
    monkeypatch.setattr(T, "preact_quant", real)
    assert torch.equal(got, _unfused_static(plan, trunk["x"]))


def test_conv_plan_covers_the_trunk(trunk, monkeypatch):
    """conv_plan on every conv call of the static trunk (2x64x64: block 4's
    M = 8 is ragged): the 1x1 stride-1 convs take the TMA path, the rest
    the gather; 64-byte K slices exactly on the TMA path where Cin = 64;
    64-channel tiles exactly where Cout = 64."""
    calls = []
    real = T.conv_s8
    monkeypatch.setattr(T, "conv_s8",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    T.apply_int8_static(trunk["tqp"], trunk["tscales"], trunk["x"])
    assert len(calls) == 52
    paths = []
    for args in calls:
        xq, wt, stride = args
        ks, ho, wo = K.conv_geometry(xq, wt, stride)
        cin, cout = xq.shape[-1], wt.shape[0]
        plan = K.conv_plan(ks, stride, cin, cout)
        paths.append(plan.path)
        assert plan.path == ("tma" if (ks, stride) == (1, 1) else "gather")
        assert plan.bk == (64 if cin == 64 and plan.path == "tma" else 128)
        assert plan.bn == (64 if cout == 64 else 128)
        assert cout % plan.bn == 0
        assert cin % plan.bk == 0 or plan.path == "gather"
    assert paths.count("tma") == 36 and paths.count("gather") == 16
    assert any(c[0].shape[0] * c[0].shape[1] * c[0].shape[2] % 128
               for c in calls if K.conv_geometry(c[0], c[1], c[2])[0] == 1)


@pytest.mark.parametrize("ks,stride,cin,cout,want", [
    (1, 1, 64, 64, ("tma", 64, 64)), (1, 1, 64, 256, ("tma", 128, 64)),
    (1, 1, 2048, 512, ("tma", 128, 128)), (3, 1, 64, 64, ("gather", 64, 128)),
    (3, 2, 512, 512, ("gather", 128, 128)), (1, 2, 256, 512,
                                             ("gather", 128, 128)),
    (3, 2, 32, 40, ("gather", 64, 128)), (1, 1, 48, 2056, ("tma", 128, 64)),
])
def test_conv_plan_geometries(ks, stride, cin, cout, want):
    assert tuple(K.conv_plan(ks, stride, cin, cout)) == want


def test_conv_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 1, 24, 64), (1, 1, 64, 12), (2, 1, 64, 64),
                 (3, 0, 64, 64)):
        with pytest.raises(ValueError):
            K.conv_plan(*args)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("epilogue,res_dtype", [
    ("dequant", torch.bfloat16), ("dequant", None),
    ("residual", torch.bfloat16), ("residual", torch.float32),
])
def test_fused_epilogue_reference_is_epilogue_then_preact(epilogue, res_dtype,
                                                          mode):
    """The plain fused epilogue: (out, pq) with out the plain epilogue and
    pq preact_quant_reference of out, bit for bit; conv_s8 on the CPU
    returns the same pair."""
    g = torch.Generator().manual_seed(mode)
    x = torch.randint(-127, 128, (2, 5, 6, 32), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (24, 9 * 32), generator=g, dtype=torch.int8)
    mul = torch.rand(24, generator=g) * 1e-5
    add = torch.randn(24, generator=g)
    res = (None if res_dtype is None
           else torch.randn(2, 5, 6, 24, generator=g).to(res_dtype))
    pa = torch.rand(24, generator=g) + 0.5
    pb = torch.randn(24, generator=g) * 0.3
    if mode == 1:
        pa, pb = pa.to(torch.bfloat16).float(), pb.to(torch.bfloat16).float()
    s = torch.tensor([0.05]) if mode == 1 else None
    pre = K.Preact(pa, pb, s, mode)
    acc = K.conv_s8_reference(x, wt)
    out, pq = K.epilogue_reference(acc, epilogue, mul, add, residual=res,
                                   preact=pre)
    want = K.epilogue_reference(acc, epilogue, mul, add, residual=res)
    assert torch.equal(out, want)
    assert torch.equal(pq, K.preact_quant_reference(want, pa, pb, s,
                                                    mode=mode))
    assert 0 < int((pq > 0).sum()) < pq.numel()
    got, got_pq = K.conv_s8(x, wt, epilogue=epilogue, mul=mul, add=add,
                            residual=res, preact=pre)
    assert torch.equal(got, out) and torch.equal(got_pq, pq)


def test_fused_preact_checks_operands():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(8, 16, dtype=torch.int8)
    one = torch.ones(8)
    with pytest.raises(ValueError, match="no bf16"):
        K.conv_s8(x, w, epilogue="requant", mul=one, add=one,
                  preact=K.Preact(one, one, None, 0))
    with pytest.raises(ValueError, match="pa must be"):
        K.conv_s8(x, w, epilogue="dequant", mul=one, add=one,
                  preact=K.Preact(torch.ones(4), one, None, 0))
    with pytest.raises(ValueError, match="mode 1 needs"):
        K.conv_s8(x, w, epilogue="dequant", mul=one, add=one,
                  preact=K.Preact(one, one, None, 1))
    with pytest.raises(ValueError, match="pq must be"):
        K.fused_block_pq(torch.zeros(1, 2, 2, 16, dtype=torch.bfloat16),
                         [_port_unit(_random_unit(np.random.RandomState(0),
                                                  16, 8, 16))],
                         h=2, w=2, unit_specs=(True,),
                         pq=torch.zeros(1, 2, 2, 8, dtype=torch.int8))


@pytest.mark.parametrize("has_shortcut", [False, True])
def test_fused_block_pq_carries_preacts(has_shortcut):
    """K2's chain with the pre-activations carried in and out: the first
    unit's pq handed in and the next unit's pq handed out equal the
    standalone passes, and the chain's output equals fused_block's."""
    rng = np.random.RandomState(4)
    units = [_port_unit(_random_unit(rng, 16, 8, 16)) for _ in range(3)]
    specs = (has_shortcut, False)
    if not has_shortcut:
        units[0] = {k: v for k, v in units[0].items() if k in K.PARAM_KEYS}
    units[1] = {k: v for k, v in units[1].items() if k in K.PARAM_KEYS}
    x = torch.from_numpy(rng.randn(2, 6, 5, 16).astype(np.float32))
    x = x.to(torch.bfloat16)
    pq_in = K.preact_quant_reference(x, units[0]["pA"], units[0]["pB"])
    nxt = K.unit_preact(units[2])
    out, pq = K.fused_block_pq(x, units[:2], h=6, w=5, unit_specs=specs,
                               pq=pq_in, next_preact=nxt)
    want = K.fused_block(x, units[:2], h=6, w=5, unit_specs=specs)
    assert torch.equal(out, want)
    assert torch.equal(pq, K.preact_quant_reference(want, nxt.pa, nxt.pb))
    out2, none = K.fused_block_pq(x, units[:2], h=6, w=5, unit_specs=specs)
    assert torch.equal(out2, want) and none is None


# (n, h, w, Cin, Cb, Cout, has_shortcut): the trunk's K2 units at 120
# frames and the units of test_cuda_fused_block_matches_plain.
K2_UNITS = [
    (120, 28, 28, 256, 128, 512, True), (120, 28, 28, 512, 128, 512, False),
    (120, 14, 14, 512, 256, 1024, True), (120, 14, 14, 1024, 256, 1024, False),
    (120, 7, 7, 1024, 512, 2048, True), (120, 7, 7, 2048, 512, 2048, False),
    (4, 28, 28, 256, 128, 512, True), (4, 14, 14, 512, 256, 1024, True),
    (4, 7, 7, 1024, 512, 2048, True),
]


@pytest.mark.parametrize("unit", K2_UNITS)
def test_k2_plan_geometries(unit):
    """k2_plan's tiles: within the shared memory a block may take, with as
    many weight-ring slots as it leaves (up to 8), one pass over phase A's
    pixels (the tile's rows and their halo), and row tiles
    that cover every output row of every frame exactly once; 7-row tiles
    at 28x28 and 14x14, the whole frame at 7x7."""
    n, h, w, cin, cb, cout, sc = unit
    plan = K.k2_plan(*unit)
    assert plan.smem_bytes <= K.K2_SMEM_MAX == 232448
    smem = lambda stages: K._k2_smem(h, w, cin, cb, plan.rows,
                                     plan.warp_rows, sc, stages)
    assert plan.smem_bytes == smem(plan.stages)
    assert 3 <= plan.stages <= 8
    assert plan.stages == 8 or smem(plan.stages + 1) > K.K2_SMEM_MAX
    assert min(plan.rows + 2, h) * w <= 64 * plan.warp_rows
    covered = [r for t in range(plan.tiles)
               for r in range(t * plan.rows, min((t + 1) * plan.rows, h))]
    assert covered == list(range(h))
    assert plan.grid == n * plan.tiles
    assert plan.rows == 7 and plan.warp_rows == {28: 4, 14: 2, 7: 1}[h]


def test_k2_plan_refuses_what_the_kernel_does_not_take():
    for args in ((2, 7, 7, 48, 32, 48, False), (2, 7, 7, 64, 8, 64, False),
                 (2, 7, 7, 64, 32, 96, False), (2, 7, 7, 64, 32, 0, True),
                 (2, 4, 4000, 2048, 512, 2048, False)):
        with pytest.raises(ValueError):
            K.k2_plan(*args)
    # Wide maps get one-row tiles in several passes; ragged tiles are even.
    assert K.k2_plan(1, 224, 224, 64, 64, 64, False)[:3] == (1, 224, 4)
    assert K.k2_plan(1, 31, 20, 64, 64, 64, False)[:2] == (8, 4)


def test_fused_block_cuda_path_refuses_shapes(monkeypatch):
    """On the CUDA path fused_block raises ValueError, before any launch,
    for units the kernel does not take (Cb 8) and for operands of the
    wrong shape; nothing falls back to the plain version."""
    monkeypatch.setattr(K, "_device_of", lambda tensors, what: "cuda")
    rng = np.random.RandomState(0)
    unit = _port_unit(_random_unit(rng, 16, 8, 16))
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="multiples of 32"):
        K.fused_block(x, [unit], h=4, w=4, unit_specs=(True,))
    unit = _port_unit(_random_unit(rng, 32, 32, 32))
    unit["q2a"] = unit["q2a"][:16]
    with pytest.raises(ValueError, match="q2a"):
        K.fused_block(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16), [unit],
                      h=4, w=4, unit_specs=(True,))
    assert K.LAUNCHES == before


def test_build_key_covers_every_header(tmp_path, monkeypatch):
    """The library's cache key changes with the source, with any .cuh
    header under csrc/ and with nothing else there."""
    from human_dynamics_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    key = _build._source_key(str(src))
    (tmp_path / "notes.txt").write_text("not a source")
    assert _build._source_key(str(src)) == key
    (tmp_path / "h.cuh").write_text("// v2\n")
    key2 = _build._source_key(str(src))
    assert key2 != key
    src.write_text('#include "h.cuh"\n// edited\n')
    assert _build._source_key(str(src)) not in (key, key2)


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
# ragged M and N tiles, plus the frame counts of a streaming encoder call
# (8 and 14 at B=1; 70, 64 and a flush's remainder at B=8).
CUDA_CONVS = [
    (2, 56, 56, 64, 64, 1, 1), (2, 56, 56, 64, 64, 3, 1),
    (2, 56, 56, 64, 64, 3, 2), (2, 56, 56, 256, 512, 1, 2),
    (3, 14, 14, 256, 1024, 1, 1), (3, 7, 7, 512, 512, 3, 1),
    (1, 9, 11, 32, 40, 3, 2),
    (8, 56, 56, 256, 64, 1, 1), (14, 28, 28, 128, 128, 3, 1),
    (70, 14, 14, 1024, 256, 1, 1), (64, 28, 28, 128, 128, 3, 2),
    (26, 7, 7, 512, 512, 3, 1),
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
        ("dequant", dict(residual=res_bf, fma=True)),
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
                                           (512, 256, 1024, 14),
                                           (1024, 512, 2048, 7)])
def test_cuda_fused_block_matches_plain(cuda_device, cin, cb, cout, h):
    """K2 on two units (the first with a projection shortcut when
    Cin != Cout) against fused_block_reference on the card, and the next
    unit's pre-activation the chain hands on, in both modes."""
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
    # One launch of the K2 kernel per unit.
    assert K.LAUNCHES[K.BLOCK] == before + 2
    want = K.fused_block_reference(x, units, **kw)
    assert torch.equal(got, want)
    for mode in (0, 1):
        nxt = _preact_operands(cuda_device, cout, mode, seed=mode)
        out, pq = K.fused_block_pq(x, units, next_preact=nxt, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(pq, K.preact_quant_reference(want, *nxt[:3],
                                                        mode=mode))


# (n, h, w, cin, cout, k, stride) for the fused pre-activation: both paths,
# Cin 64 (64-byte K slices), ragged M (n*h*w not a multiple of 128), Cin
# below the K slice and a Cout tail.
CUDA_FUSED = [
    (2, 56, 56, 64, 256, 1, 1), (5, 7, 7, 512, 2048, 1, 1),
    (3, 14, 14, 1024, 256, 1, 1), (2, 7, 7, 512, 512, 3, 1),
    (2, 28, 28, 64, 64, 3, 2), (1, 9, 11, 32, 40, 1, 1),
]


def _preact_operands(dev, c, mode, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    pa = torch.rand(c, generator=g) + 0.5
    pb = torch.randn(c, generator=g) * 0.3
    if mode == 1:
        pa, pb = pa.to(torch.bfloat16).float(), pb.to(torch.bfloat16).float()
    s = torch.tensor([0.05]) if mode == 1 else None
    return K.Preact(pa.to(dev), pb.to(dev), None if s is None else s.to(dev),
                    mode)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", CUDA_FUSED)
def test_cuda_conv_fused_preact_matches_plain(cuda_device, geom):
    """The conv on the path conv_plan picks, with the next unit's
    pre-activation fused into its bf16 epilogues, against
    epilogue_reference(..., preact=...) (= the epilogue, then
    preact_quant_reference): both outputs equal."""
    n, h, w, cin, cout, k, stride = geom
    x, wt, mul, add = _cuda_inputs(cuda_device, *geom[:6], seed=7)
    mul = mul * 0.1
    path = K.conv_plan(k, stride, cin, cout).path
    acc = K.conv_s8_reference(x, wt, stride)
    res_bf = torch.randn(acc.shape, device=cuda_device).to(torch.bfloat16)
    res_f = torch.randn(acc.shape, device=cuda_device)
    for mode in (0, 1):
        pre = _preact_operands(cuda_device, cout, mode, seed=mode)
        for epi, kw in (("dequant", dict(residual=res_bf)),
                        ("dequant", dict(relu=True)),
                        ("residual", dict(residual=res_f)),
                        ("residual", dict(residual=res_bf))):
            before = dict(K.PATH_LAUNCHES)
            out, pq = K.conv_s8(x, wt, stride, epilogue=epi, mul=mul,
                                add=add, preact=pre, **kw)
            want, want_pq = K.epilogue_reference(acc, epi, mul, add,
                                                 preact=pre, **kw)
            torch.cuda.synchronize()
            assert K.PATH_LAUNCHES[path] == before[path] + 1
            assert torch.equal(out, want), (mode, epi, kw.keys())
            assert torch.equal(pq, want_pq), (mode, epi, kw.keys())
            assert 0 < int((pq > 0).sum()) < pq.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(120, 56, 56, 64), (3, 5, 7, 200),
                                   (2, 3, 3, 4096)])
@pytest.mark.parametrize("mode", [0, 1])
def test_cuda_preact_loads_match_plain(cuda_device, shape, mode):
    """The standalone pre-activation's channel-group layout: 64 channels
    (8 groups, 32 rows a block), a group count that does not divide 256,
    and more groups than threads in a block."""
    g = torch.Generator(device="cpu").manual_seed(11)
    x = (torch.randn(shape, generator=g) * 2).to(torch.bfloat16)
    x = x.to(cuda_device)
    pre = _preact_operands(cuda_device, shape[-1], mode, seed=3)
    got = K.preact_quant(x, pre.pa, pre.pb, pre.s, mode=mode)
    want = K.preact_quant_reference(x, pre.pa, pre.pb, pre.s, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [0.05, 1 / 3, 0.0123, 7.0, 1e-3, 3.3e4, 1e-12,
                               1e-30])
def test_cuda_preact_mode1_every_bf16(cuda_device, s):
    """Mode 1's quotient p / s on every positive finite bf16 p (pa = 1,
    pb = 0), standalone and fused into a dequant epilogue whose output is
    its bf16 residual (mul = add = 0): equal to the plain division, for
    scales inside and outside the kernel's fast range."""
    p = torch.arange(0x7F80, dtype=torch.int16).view(torch.bfloat16)
    x = p.reshape(1, 30, 17, 64).to(cuda_device)
    pre = K.Preact(torch.ones(64, device=cuda_device),
                   torch.zeros(64, device=cuda_device),
                   torch.tensor([s], device=cuda_device), 1)
    want = K.preact_quant_reference(x, *pre[:3], mode=1)
    got = K.preact_quant(x, *pre[:3], mode=1)
    xq = torch.ones(1, 30, 17, 16, dtype=torch.int8, device=cuda_device)
    wt = torch.ones(64, 16, dtype=torch.int8, device=cuda_device)
    zero = torch.zeros(64, device=cuda_device)
    out, pq = K.conv_s8(xq, wt, epilogue="dequant", mul=zero, add=zero,
                        residual=x, preact=pre)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(out, x) and torch.equal(pq, want)
