"""The port's fused SMPL op (human_dynamics_tpu_torch.ops.smpl_cuda) against
the JAX Pallas kernel in interpret mode, and its CUDA kernel against the
plain PyTorch version on the card.

Tolerances are those of tests/test_ops_pallas.py: verts and joints 2e-4,
j_posed 1e-4, rots 1e-5 (float32 sums taken in another order); gradients
atol 5e-3, rtol 1e-3. On the card the kernel's vertex planes are held to
the plain fp32 version at 1e-5: its 3xTF32 products are as close as fp32
ones, while a dropped lo term (one TF32 product) would be off by ~4e-4.

The JAX reference is imported inside a fixture, so that the CUDA cases of
this file also run where JAX is not installed:
``python -m pytest tests/test_torch_ops_smpl.py --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

from human_dynamics_tpu_torch.core import smpl_forward, synthetic_smpl_model
from human_dynamics_tpu_torch.ops import smpl_cuda
from human_dynamics_tpu_torch.ops.smpl_cuda import (
    blend_skin,
    blend_skin_reference,
    prepare_fused_constants,
    smpl_forward_fused,
)

torch.set_num_threads(1)

ATOL_VERTS = 2e-4
ATOL_JOINTS = 2e-4
ATOL_J_POSED = 1e-4
ATOL_ROTS = 1e-5
ATOL_PLANES_FP32 = 1e-5


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's SMPL functions (CPU, Pallas in interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from human_dynamics_tpu.core import smpl as jsmpl
    from human_dynamics_tpu.ops import smpl_pallas

    return jnp, jsmpl, smpl_pallas


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, n):
    rng = np.random.RandomState(seed)
    beta = rng.randn(n, 10).astype(np.float32) * 0.3
    theta = rng.randn(n, 72).astype(np.float32) * 0.3
    return beta, theta


def _assert_smpl_close(got, want):
    np.testing.assert_allclose(got.verts, want.verts, atol=ATOL_VERTS)
    np.testing.assert_allclose(got.joints, want.joints, atol=ATOL_JOINTS)
    np.testing.assert_allclose(got.j_posed, want.j_posed, atol=ATOL_J_POSED)
    np.testing.assert_allclose(got.rots, want.rots, atol=ATOL_ROTS)


class _Np:
    """SmplForward fields as numpy arrays (either framework)."""

    def __init__(self, out):
        for k in ("verts", "joints", "rots", "j_posed"):
            setattr(self, k, np.asarray(getattr(out, k)))


@pytest.mark.parametrize(
    "num_verts,block_v,n", [(512, 256, 48), (700, 256, 48), (256, 256, 21)]
)
def test_fused_matches_jax_pallas(jax_ref, num_verts, block_v, n):
    """smpl_forward_fused on the CPU (plain blend+skin) against the JAX
    Pallas kernel in interpret mode: exact V, padded V (700 is not a
    multiple of the JAX block) and a ragged N=21."""
    jnp, jsmpl, smpl_pallas = jax_ref
    beta, theta = _inputs(13, n)
    jmodel = jsmpl.synthetic_smpl_model(num_verts=num_verts, num_kps=19)
    want = smpl_pallas.smpl_forward_fused(
        jmodel, jnp.asarray(beta), jnp.asarray(theta),
        constants=smpl_pallas.prepare_fused_constants(jmodel, block_v),
        block_v=block_v, block_n=16, interpret=True,
    )
    model = synthetic_smpl_model(num_verts=num_verts, num_kps=19)
    got = smpl_forward_fused(
        model, torch.from_numpy(beta), torch.from_numpy(theta)
    )
    assert got.verts.shape == (n, num_verts, 3)
    _assert_smpl_close(_Np(got), _Np(want))


@pytest.mark.parametrize("num_verts,n", [(333, 5), (130, 1), (257, 37)])
def test_fused_ragged_shapes_match_jax_pallas(jax_ref, num_verts, n):
    """The CPU path at shapes the kernel treats apart: an odd V (its rows
    are copied in 4-byte pieces), a single frame, and an N that is not a
    multiple of 4 or of the 64-frame tile."""
    jnp, jsmpl, smpl_pallas = jax_ref
    beta, theta = _inputs(17, n)
    jmodel = jsmpl.synthetic_smpl_model(num_verts=num_verts, num_kps=19)
    want = smpl_pallas.smpl_forward_fused(
        jmodel, jnp.asarray(beta), jnp.asarray(theta),
        constants=smpl_pallas.prepare_fused_constants(jmodel, 128),
        block_v=128, block_n=16, interpret=True,
    )
    model = synthetic_smpl_model(num_verts=num_verts, num_kps=19)
    got = smpl_forward_fused(
        model, torch.from_numpy(beta), torch.from_numpy(theta)
    )
    assert got.verts.shape == (n, num_verts, 3)
    _assert_smpl_close(_Np(got), _Np(want))


def test_blend_skin_reference_matches_jax_blend_skin(jax_ref):
    """The plain version against the Pallas kernel on the same planar
    operands (V padded to the JAX block; the port needs no padding)."""
    jnp, jsmpl, smpl_pallas = jax_ref
    rng = np.random.RandomState(5)
    n, v, block_v = 32, 512, 256
    coeffs = rng.randn(n, smpl_cuda.COEF_PAD).astype(np.float32) * 0.1
    rt_t = rng.randn(smpl_cuda.RT_CH * smpl_cuda.JP, n).astype(np.float32)
    dirs = rng.randn(3, smpl_cuda.COEF_PAD, v).astype(np.float32) * 0.1
    vt = rng.randn(3, 1, v).astype(np.float32)
    w = rng.rand(smpl_cuda.JP, v).astype(np.float32)
    want = smpl_pallas._blend_skin(
        *(jnp.asarray(a) for a in (coeffs, rt_t, dirs, vt, w)),
        block_v=block_v, block_n=16, interpret=True,
    )
    got = blend_skin(
        *(torch.from_numpy(a) for a in (coeffs, rt_t, dirs, vt, w))
    )
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_VERTS)


def test_fused_constants_match_jax(jax_ref):
    """The contracted rest-joint tables and planar dirs equal the JAX ones
    (up to the JAX padding of V)."""
    jnp, jsmpl, smpl_pallas = jax_ref
    v = 300
    jc = smpl_pallas.prepare_fused_constants(
        jsmpl.synthetic_smpl_model(num_verts=v, num_kps=19), block_v=128
    )
    c = prepare_fused_constants(synthetic_smpl_model(num_verts=v, num_kps=19))
    np.testing.assert_array_equal(c.dirs.numpy(), np.asarray(jc.dirs)[..., :v])
    np.testing.assert_array_equal(
        c.v_template.numpy(), np.asarray(jc.v_template)[..., :v]
    )
    np.testing.assert_array_equal(
        c.weights_t.numpy(), np.asarray(jc.weights_t)[:, :v]
    )
    np.testing.assert_allclose(
        c.shape_j_dirs.numpy(), np.asarray(jc.shape_j_dirs), atol=1e-6
    )
    np.testing.assert_allclose(
        c.j_template.numpy(), np.asarray(jc.j_template), atol=1e-6
    )


def test_fused_gradients_match_jax(jax_ref):
    """The autograd.Function's backward against jax.grad. The JAX fused
    op's custom VJP is the VJP of the composed smpl_forward, so jax.grad
    of that forward is its gradient, without tracing the Pallas kernel."""
    import jax

    jnp, jsmpl, smpl_pallas = jax_ref
    beta, theta = _inputs(3, 5)
    jmodel = jsmpl.synthetic_smpl_model(num_verts=128, num_kps=19)

    def loss_jax(b, t):
        out = jsmpl.smpl_forward(jmodel, b, t)
        return jnp.sum(out.joints ** 2) + jnp.sum(out.rots)

    want = jax.jit(jax.grad(loss_jax, argnums=(0, 1)))(
        jnp.asarray(beta), jnp.asarray(theta)
    )
    model = synthetic_smpl_model(num_verts=128, num_kps=19)
    b = torch.from_numpy(beta).requires_grad_(True)
    t = torch.from_numpy(theta).requires_grad_(True)
    out = smpl_forward_fused(model, b, t, want_verts=False)
    assert out.verts is None
    loss = torch.sum(out.joints ** 2) + torch.sum(out.rots)
    got = torch.autograd.grad(loss, [b, t])
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=5e-3, rtol=1e-3
        )


def test_fused_verts_gradient_matches_composed():
    """A cotangent on verts flows through the fused op as through the
    composed forward."""
    beta, theta = _inputs(4, 6)
    model = synthetic_smpl_model(num_verts=96, num_kps=19)
    grads = []
    for fn in (smpl_forward_fused, smpl_forward):
        b = torch.from_numpy(beta).requires_grad_(True)
        t = torch.from_numpy(theta).requires_grad_(True)
        out = fn(model, b, t)
        loss = torch.sum(out.verts ** 2) + torch.sum(out.j_posed)
        grads.append(torch.autograd.grad(loss, [b, t]))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-3, rtol=1e-3)


def test_cuda_launcher_rejects_cpu_tensors():
    """CPU tensors handed straight to the CUDA launcher raise before any
    build or launch."""
    model = synthetic_smpl_model(num_verts=64, num_kps=19)
    c = prepare_fused_constants(model)
    coeffs = torch.zeros(4, smpl_cuda.COEF_PAD)
    rt_t = torch.zeros(smpl_cuda.RT_CH * smpl_cuda.JP, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        smpl_cuda._launch_blend_skin_cuda(
            coeffs, rt_t, c.dirs, c.v_template, c.weights_t
        )


def test_cuda_launcher_requires_16_byte_starts():
    """The kernel copies 16-byte pieces from each operand's start: a view
    that starts 4 bytes in raises, its clone passes."""
    model = synthetic_smpl_model(num_verts=64, num_kps=19)
    c = prepare_fused_constants(model)
    coeffs = torch.zeros(5 * smpl_cuda.COEF_PAD)
    rt_t = torch.zeros(smpl_cuda.RT_CH * smpl_cuda.JP, 4)
    view = coeffs[1:1 + 4 * smpl_cuda.COEF_PAD].view(4, smpl_cuda.COEF_PAD)
    assert view.is_contiguous()
    ops = [view, rt_t, c.dirs, c.v_template, c.weights_t]
    with pytest.raises(ValueError, match="coeffs: .*16 bytes"):
        smpl_cuda._check_aligned(ops)
    ops[0] = view.clone()
    smpl_cuda._check_aligned(ops)


def test_blend_skin_checks_operands():
    """Wrong shapes and dtypes raise in the wrapper on any device."""
    model = synthetic_smpl_model(num_verts=64, num_kps=19)
    c = prepare_fused_constants(model)
    rt_t = torch.zeros(smpl_cuda.RT_CH * smpl_cuda.JP, 4)
    with pytest.raises(ValueError, match="coeffs"):
        blend_skin(torch.zeros(4, 217), rt_t, c.dirs, c.v_template,
                   c.weights_t)
    with pytest.raises(ValueError, match="dtype"):
        blend_skin(torch.zeros(4, smpl_cuda.COEF_PAD, dtype=torch.float64),
                   rt_t, c.dirs, c.v_template, c.weights_t)
    with pytest.raises(ValueError, match="differentiable"):
        blend_skin(torch.zeros(4, smpl_cuda.COEF_PAD, requires_grad=True),
                   rt_t, c.dirs, c.v_template, c.weights_t)


@pytest.mark.cuda
@pytest.mark.parametrize("num_verts,n", [(700, 21), (6890, 1440), (6890, 37)])
def test_cuda_kernel_matches_plain(cuda_device, num_verts, n):
    """The CUDA kernel against the plain version on the card, on the
    planes and through the whole fused forward (TF32 off for the plain
    products)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = synthetic_smpl_model(
            num_verts=num_verts, num_kps=25, device=cuda_device
        )
        consts = prepare_fused_constants(model)
        beta, theta = (
            torch.from_numpy(a).to(cuda_device) for a in _inputs(7, n)
        )
        before = smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]
        got = smpl_forward_fused(model, beta, theta, constants=consts)
        torch.cuda.synchronize()
        assert smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] == before + 1
        want = smpl_forward(model, beta, theta)
        _assert_smpl_close(
            _Np(_to_cpu(got)), _Np(_to_cpu(want))
        )
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize(
    "num_verts,n",
    [(6890, 1536), (6890, 1440), (6890, 37), (700, 21), (6890, 1), (333, 5),
     (6890, 24), (6890, 192), (6890, 640)],
)
def test_cuda_planes_match_plain_fp32(cuda_device, num_verts, n):
    """The kernel's three vertex planes against the plain version in fp32
    (matmul TF32 off) at 1e-5: the main path's N = 1536, V = 6890, a
    streaming emission's N = 24 (B=1) and 192 (B=8), a training step's
    N = 640 (4 heads x B*T at B=8, T=20), and ragged shapes
    (V = 6890 is 2 mod 4, 333 is odd; N = 37, 21, 5, 1 are not multiples
    of 4 or of the 64-frame tile)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = synthetic_smpl_model(
            num_verts=num_verts, num_kps=25, device=cuda_device
        )
        consts = prepare_fused_constants(model)
        beta, theta = (
            torch.from_numpy(a).to(cuda_device) for a in _inputs(11, n)
        )
        coeffs, rt_t, _, _ = smpl_cuda.blend_skin_operands(
            model, consts, beta, theta
        )
        ops = (coeffs, rt_t, consts.dirs, consts.v_template, consts.weights_t)
        before = smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]
        got = blend_skin(*ops)
        torch.cuda.synchronize()
        assert smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] == before + 1
        want = blend_skin_reference(*ops)
        for g, w in zip(got, want):
            assert g.shape == (n, num_verts)
            err = float((g - w).abs().max())
            assert err <= ATOL_PLANES_FP32, err
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("n", [21, 640])
def test_cuda_kernel_gradient_matches_plain(cuda_device, n):
    """The gradient through smpl_forward_fused (the kernel forward, the
    composed backward) against the plain forward's, at N = 21 and at a
    training step's N = 640."""
    beta, theta = _inputs(8, n)
    model = synthetic_smpl_model(num_verts=6890, num_kps=25,
                                 device=cuda_device)
    grads = []
    for fn in (smpl_forward_fused, smpl_forward):
        b = torch.from_numpy(beta).to(cuda_device).requires_grad_(True)
        t = torch.from_numpy(theta).to(cuda_device).requires_grad_(True)
        loss = torch.sum(fn(model, b, t).joints ** 2)
        grads.append(torch.autograd.grad(loss, [b, t]))
    for g, w in zip(*grads):
        np.testing.assert_allclose(
            g.cpu().numpy(), w.cpu().numpy(), atol=5e-3, rtol=1e-3
        )


def _to_cpu(out):
    return smpl_cuda.SmplForward(
        *(None if x is None else x.cpu()
          for x in (out.verts, out.joints, out.rots, out.j_posed))
    )
