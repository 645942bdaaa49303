"""Fused SMPL blend shapes + skinning: the CUDA kernel and its wrapper.

Counterpart of ``human_dynamics_tpu/ops/smpl_pallas.py``. The (N, V)-sized
work of an SMPL forward pass runs in one hand-written CUDA kernel
(``csrc/smpl_blend_skin.cu``) that writes only the three vertex planes:

    posed_c = coeffs @ dirs_c + vt_c          (c in x, y, z)
    blend_k = rt_k^T @ weights_t              (k in 0..11)
    vert_x  = b0*px + b1*py + b2*pz + b9      (likewise y, z)

The kernel runs both contractions on the tensor cores (``mma.sync`` TF32
with every product split in three, 3xTF32, for fp32-class results). The
operands keep the JAX kernel's planar layout: coeffs (N, 224) is
beta || vec(R[1:] - I) zero-padded from 217; rt_t (384, N) holds row
k*32 + joint for the 12 transform channels, joints padded 24 -> 32; dirs
(3, 224, V); vt (3, 1, V); weights_t (32, V). Neither N nor V is padded:
the kernel copies rows in pieces as wide as their stride allows and masks
the ragged edges, so it only needs each operand to start on 16 bytes. Rest
joints, Rodrigues, FK and the keypoint regression stay in plain PyTorch.

Which version runs is decided by the device of the tensors: CUDA tensors
launch the kernel, CPU tensors run ``blend_skin_reference``. A failed
build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from human_dynamics_tpu_torch.core.rotations import rodrigues
from human_dynamics_tpu_torch.core.smpl import (
    NUM_JOINTS,
    NUM_POSE_BASIS,
    SmplForward,
    SmplModel,
    global_rigid_transformation,
    pose_feature,
    smpl_forward,
)

COEF_DIM = 10 + NUM_POSE_BASIS  # 217
COEF_PAD = 224
RT_CH = 12                      # 9 rotation + 3 translation channels
JP = 32                         # joints padded 24 -> 32
KERNEL_NAME = "smpl_blend_skin"

# Kernel launches by name; chip_smoke.py resets and reads it to show that
# the main path went through the kernel.
LAUNCHES = {KERNEL_NAME: 0}


@dataclasses.dataclass(frozen=True)
class FusedSmplConstants:
    """Planar constants for the fused kernel, on the model's device."""

    dirs: torch.Tensor             # (3, COEF_PAD, V) [shape; pose] dirs
    v_template: torch.Tensor       # (3, 1, V)
    weights_t: torch.Tensor        # (JP, V) lbs weights, joint-major
    shape_j_dirs: torch.Tensor     # (10, 24*3) beta -> rest joints
    j_template: torch.Tensor       # (24, 3)
    joint_regressor: torch.Tensor  # (V, K)
    num_verts: int


def prepare_fused_constants(model: SmplModel) -> FusedSmplConstants:
    """One-time contraction and re-layout of the SmplModel constants."""
    v = model.num_verts
    dirs = torch.cat([model.shapedirs, model.posedirs], dim=0)
    dirs = dirs.reshape(COEF_DIM, v, 3).permute(2, 0, 1)        # (3, 217, V)
    dirs = torch.nn.functional.pad(dirs, (0, 0, 0, COEF_PAD - COEF_DIM))
    weights_t = torch.nn.functional.pad(
        model.lbs_weights.t(), (0, 0, 0, JP - NUM_JOINTS)
    )
    sd = model.shapedirs.reshape(model.num_betas, v, 3)
    shape_j_dirs = torch.einsum(
        "kvc,vj->kjc", sd, model.j_regressor
    ).reshape(model.num_betas, NUM_JOINTS * 3)
    j_template = torch.einsum("vc,vj->jc", model.v_template, model.j_regressor)
    return FusedSmplConstants(
        dirs=dirs.contiguous(),
        v_template=model.v_template.t().reshape(3, 1, v).contiguous(),
        weights_t=weights_t.contiguous(),
        shape_j_dirs=shape_j_dirs.contiguous(),
        j_template=j_template.contiguous(),
        joint_regressor=model.joint_regressor.contiguous(),
        num_verts=v,
    )


def blend_skin_reference(coeffs, rt_t, dirs, vt, weights_t):
    """Plain PyTorch version of the kernel: the same function, any device.

    Returns the three (N, V) vertex planes.
    """
    n = coeffs.shape[0]
    posed = coeffs @ dirs + vt                                # (3, N, V)
    rt = rt_t.reshape(RT_CH, JP, n)
    b = torch.einsum("kjn,jv->knv", rt, weights_t)            # (12, N, V)
    px, py, pz = posed[0], posed[1], posed[2]
    return (
        b[0] * px + b[1] * py + b[2] * pz + b[9],
        b[3] * px + b[4] * py + b[5] * pz + b[10],
        b[6] * px + b[7] * py + b[8] * pz + b[11],
    )


def _check_operands(coeffs, rt_t, dirs, vt, weights_t) -> Tuple[int, int]:
    n = coeffs.shape[0] if coeffs.dim() == 2 else -1
    v = dirs.shape[2] if dirs.dim() == 3 else -1
    want = {
        "coeffs": (coeffs, (n, COEF_PAD)),
        "rt_t": (rt_t, (RT_CH * JP, n)),
        "dirs": (dirs, (3, COEF_PAD, v)),
        "vt": (vt, (3, 1, v)),
        "weights_t": (weights_t, (JP, v)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, want float32")
    return n, v


def _check_aligned(operands) -> None:
    """The kernel copies whole 16-byte pieces from the start of each
    operand; a view that starts elsewhere (a slice) must be cloned."""
    for name, t in zip(("coeffs", "rt_t", "dirs", "vt", "weights_t"),
                       operands):
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: the CUDA kernel takes operands that start on 16 "
                "bytes; clone the view"
            )


def _launch_blend_skin_cuda(coeffs, rt_t, dirs, vt, weights_t):
    """Launch the CUDA kernel on PyTorch's current stream."""
    operands = (coeffs, rt_t, dirs, vt, weights_t)
    for t in operands:
        if not t.is_cuda:
            raise ValueError(
                f"the CUDA kernel takes CUDA tensors, got one on {t.device}"
            )
    n, v = _check_operands(*operands)
    device = coeffs.device
    for t in operands:
        if t.device != device:
            raise ValueError(f"operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous operands")
    _check_aligned(operands)

    lib = _kernel_library()
    out = torch.empty((3, n, v), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.smpl_blend_skin_launch(
            coeffs.data_ptr(), rt_t.data_ptr(), dirs.data_ptr(),
            vt.data_ptr(), weights_t.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            n, v, stream,
        )
    if code != 0:
        msg = lib.smpl_blend_skin_error_string(code).decode()
        raise RuntimeError(f"{KERNEL_NAME} launch failed: {msg} ({code})")
    LAUNCHES[KERNEL_NAME] += 1
    return out[0], out[1], out[2]


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from human_dynamics_tpu_torch.ops._build import load_kernel_library

    lib = load_kernel_library(KERNEL_NAME).lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.smpl_blend_skin_launch.argtypes = [ptr] * 8 + [i32, i32, ptr]
    lib.smpl_blend_skin_launch.restype = i32
    lib.smpl_blend_skin_error_string.argtypes = [i32]
    lib.smpl_blend_skin_error_string.restype = ctypes.c_char_p
    lib.smpl_blend_skin_layout.argtypes = [i32]
    lib.smpl_blend_skin_layout.restype = i32
    layout = tuple(lib.smpl_blend_skin_layout(i) for i in range(4))
    if layout != (COEF_PAD, RT_CH, JP, NUM_JOINTS):
        raise RuntimeError(
            f"{KERNEL_NAME} was built for layout {layout}, the wrapper "
            f"expects {(COEF_PAD, RT_CH, JP, NUM_JOINTS)}"
        )
    return lib


def blend_skin(coeffs, rt_t, dirs, vt, weights_t):
    """The fused blend + skin step: the kernel for CUDA tensors, the plain
    version for CPU tensors. Returns the three (N, V) vertex planes.

    Not differentiable on either device; ``smpl_forward_fused`` is.
    """
    operands = (coeffs, rt_t, dirs, vt, weights_t)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise ValueError(
            "blend_skin is not differentiable; use smpl_forward_fused"
        )
    if all(t.is_cuda for t in operands):
        return _launch_blend_skin_cuda(*operands)
    if all(t.device.type == "cpu" for t in operands):
        _check_operands(*operands)
        return blend_skin_reference(*operands)
    raise ValueError(
        "blend_skin operands must all be CUDA or all CPU tensors, got "
        f"{sorted({str(t.device) for t in operands})}"
    )


def blend_skin_operands(model, constants, beta, theta):
    """The small per-frame work ahead of the kernel: rest joints from the
    precontracted beta tables, Rodrigues, FK, and the kernel's planar
    operands.

    Returns (coeffs (N, 224), rt_t (384, N), rots, j_posed).
    """
    n = beta.shape[0]
    joints_rest = (
        (beta @ constants.shape_j_dirs).reshape(n, NUM_JOINTS, 3)
        + constants.j_template
    )
    rots = rodrigues(theta.reshape(n, NUM_JOINTS, 3))
    j_posed, world_rot, rel_t = global_rigid_transformation(
        rots, joints_rest, model.parents
    )
    coeffs = torch.nn.functional.pad(
        torch.cat([beta, pose_feature(rots)], dim=1),
        (0, COEF_PAD - COEF_DIM),
    )
    # Channel-major transforms: row k*JP + joint.
    rt = torch.cat([world_rot.reshape(n, NUM_JOINTS, 9), rel_t], dim=-1)
    rt_t = torch.nn.functional.pad(
        rt.permute(2, 1, 0), (0, 0, 0, JP - NUM_JOINTS)
    ).reshape(RT_CH * JP, n)
    return coeffs.contiguous(), rt_t.contiguous(), rots, j_posed


def _fused_primal(model, constants, beta, theta, want_verts):
    coeffs, rt_t, rots, j_posed = blend_skin_operands(
        model, constants, beta, theta
    )
    vx, vy, vz = blend_skin(
        coeffs, rt_t, constants.dirs, constants.v_template,
        constants.weights_t,
    )
    # Keypoint regression straight off the planes: (N, V) @ (V, K).
    jr = constants.joint_regressor
    joints = torch.stack([vx @ jr, vy @ jr, vz @ jr], dim=2)
    verts = torch.stack([vx, vy, vz], dim=2) if want_verts else None
    return SmplForward(verts, joints, rots, j_posed)


class _FusedSmplFunction(torch.autograd.Function):
    """Forward through the kernel; backward differentiates the composed
    ``smpl_forward``, which computes the same function (the JAX package's
    custom VJP does the same)."""

    @staticmethod
    def forward(ctx, beta, theta, model, constants, want_verts):
        ctx.set_materialize_grads(False)  # unused outputs get None
        out = _fused_primal(model, constants, beta, theta, want_verts)
        ctx.save_for_backward(beta, theta)
        ctx.model = model
        ctx.want_verts = want_verts
        outs = (out.joints, out.rots, out.j_posed)
        return outs + ((out.verts,) if want_verts else ())

    @staticmethod
    def backward(ctx, *grads):
        beta, theta = ctx.saved_tensors
        with torch.enable_grad():
            b = beta.detach().requires_grad_(True)
            t = theta.detach().requires_grad_(True)
            out = smpl_forward(ctx.model, b, t)
            outs = (out.joints, out.rots, out.j_posed)
            if ctx.want_verts:
                outs = outs + (out.verts,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            gb, gt = torch.autograd.grad(
                [o for o, _ in pairs], [b, t], [g for _, g in pairs],
                allow_unused=True,
            )
        return gb, gt, None, None, None


def smpl_forward_fused(
    model: SmplModel,
    beta: torch.Tensor,
    theta: torch.Tensor,
    constants: Optional[FusedSmplConstants] = None,
    want_verts: bool = True,
) -> SmplForward:
    """Drop-in for ``core.smpl.smpl_forward`` with the (N, V)-sized work in
    the fused kernel. Differentiable in beta and theta."""
    if constants is None:
        constants = prepare_fused_constants(model)
    outs = _FusedSmplFunction.apply(beta, theta, model, constants, want_verts)
    joints, rots, j_posed = outs[:3]
    return SmplForward(outs[3] if want_verts else None, joints, rots, j_posed)
