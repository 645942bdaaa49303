"""Weak-perspective camera projection and the optimal-camera solve.

PyTorch counterpart of ``human_dynamics_tpu/core/projection.py``. The 2x2
solve in ``procrustes2d_vis`` uses the closed-form inverse, as there.
"""

from __future__ import annotations

from typing import Tuple

import torch


def orth_proj_idrot(x: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """s * (x_xy + t) with identity rotation.

    Args:
        x: (..., K, 3) or (..., K, 2) points; only xy is used.
        camera: (..., 3) [scale, tx, ty].

    Returns:
        (..., K, 2).
    """
    cam = camera[..., None, :]
    x_trans = x[..., :2] + cam[..., 1:]
    return cam[..., :1] * x_trans


def procrustes2d_vis(x: torch.Tensor, x_target: torch.Tensor) -> torch.Tensor:
    """Optimal scale + translation mapping x onto the visible x_target.

    Solves min_{s,t} sum_k v_k || s * (x_k + t) - x_target_k ||^2 per batch
    element, with the scale clamped to [0.7, 10].

    Args:
        x: (..., K, 2) or (..., K, 3) points (z dropped).
        x_target: (..., K, 3); the last channel is visibility.

    Returns:
        (..., 3) [scale, tx, ty], detached from the graph.
    """
    vis = (x_target[..., 2] > 0).to(x.dtype)
    vis_vec = vis[..., None]
    xt = x_target[..., :2]
    xp = x[..., :2]

    num_vis = torch.sum(vis, dim=-1, keepdim=True)[..., None]
    mu1 = torch.sum(vis_vec * xp, dim=-2, keepdim=True) / num_vis
    mu2 = torch.sum(vis_vec * xt, dim=-2, keepdim=True) / num_vis
    xmu = vis_vec * (xp - mu1)
    y = vis_vec * (xt - mu2)

    a11 = torch.sum(xmu[..., 0] * xmu[..., 0], dim=-1) + 1e-6
    a12 = torch.sum(xmu[..., 0] * xmu[..., 1], dim=-1)
    a22 = torch.sum(xmu[..., 1] * xmu[..., 1], dim=-1) + 1e-6
    b11 = torch.sum(xmu[..., 0] * y[..., 0], dim=-1)
    b12 = torch.sum(xmu[..., 0] * y[..., 1], dim=-1)
    b21 = torch.sum(xmu[..., 1] * y[..., 0], dim=-1)
    b22 = torch.sum(xmu[..., 1] * y[..., 1], dim=-1)
    det = a11 * a22 - a12 * a12
    trace_ainv_b = (a22 * b11 - a12 * b21 - a12 * b12 + a11 * b22) / det
    scale = torch.clamp(trace_ainv_b / 2.0, 0.7, 10.0)

    trans = mu2.squeeze(-2) / scale[..., None] - mu1.squeeze(-2)
    return torch.cat([scale[..., None], trans], dim=-1).detach()


def orth_proj_optcam(
    x: torch.Tensor, x_gt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project x with the per-example optimal (detached) camera.

    Returns (proj_x (..., K, 2), best_cam (..., 3)).
    """
    best_cam = procrustes2d_vis(x, x_gt)
    return orth_proj_idrot(x, best_cam), best_cam
