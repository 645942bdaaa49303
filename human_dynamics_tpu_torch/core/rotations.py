"""Batched rotation functions (axis-angle <-> rotation matrix, pose deltas).

PyTorch counterpart of ``human_dynamics_tpu/core/rotations.py``. Every
function is vectorised over arbitrary leading batch dims and is
differentiable with autograd.

``rodrigues`` keeps the reference's epsilon guard exactly: 1e-8 is added
to every *component* of theta before the norm, not to the norm itself.
"""

from __future__ import annotations

import torch


def skew_symmetric(vec: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with [[0, -z, y], [z, 0, -x], [-y, x, 0]]."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    zero = torch.zeros_like(x)
    rows = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return rows.reshape(vec.shape[:-1] + (3, 3))


def rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=-1, keepdim=True)
    r = theta / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    outer = r[..., :, None] * r[..., None, :]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return cos * eye + (1.0 - cos) * outer + sin * skew_symmetric(r)


def rot_to_axis_angle(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3).

    Below theta = 1e-5 the unnormalised components are returned, as the
    reference does.
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos)

    m21 = rot[..., 2, 1] - rot[..., 1, 2]
    m02 = rot[..., 0, 2] - rot[..., 2, 0]
    m10 = rot[..., 1, 0] - rot[..., 0, 1]
    denom = torch.sqrt(m21 * m21 + m02 * m02 + m10 * m10)
    small = torch.abs(theta) < 1e-5
    safe_denom = torch.where(small, torch.ones_like(denom), denom)
    axis = torch.stack(
        [
            torch.where(small, m21, m21 / safe_denom),
            torch.where(small, m02, m02 / safe_denom),
            torch.where(small, m10, m10 / safe_denom),
        ],
        dim=-1,
    )
    return theta[..., None] * axis


def lrotmin(theta: torch.Tensor) -> torch.Tensor:
    """72-D pose (..., 72) -> 207-D pose-blendshape feature (R[1:] - I)."""
    lead = theta.shape[:-1]
    rots = rodrigues(theta[..., 3:].reshape(lead + (23, 3)))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return (rots - eye).reshape(lead + (207,))


def rotation_deltas(rot_prev: torch.Tensor, rot_curr: torch.Tensor) -> torch.Tensor:
    """Frame-to-frame rotation change R_prev @ R_curr^T, (..., 3, 3)."""
    return torch.einsum("...ij,...kj->...ik", rot_prev, rot_curr)
