"""Training losses.

Counterpart of ``human_dynamics_tpu/train/losses.py``. The weighted losses
keep TF's SUM_BY_NONZERO_WEIGHTS reduction: sum(w * l) / count(w != 0),
the count taken over the weights broadcast against the losses and at
least 1 (so an all-masked loss is 0, not NaN). That denominator changes a
loss's scale against a plain mean whenever visibility masks are sparse.

Each loss takes ``mesh``: None computes the loss of the batch it is given;
a mesh makes it this rank's share of the loss of the global batch, whose
other rows the other ranks along the mesh's batch axes hold (``data``, and
``time`` on a (data, time) mesh; a ``model`` axis's ranks hold the same
rows). The share is the rank's sum divided by the global count: the
nonzero weights summed over the ranks (an ``all_reduce``, outside
autograd), or the element count times the number of ranks, every rank
holding an equal block. The shares of all ranks add up to the global loss,
and so do their gradients. Where the ranks hold unequal numbers of valid
elements (frame pairs across a time shard's edge), the invalid ones carry
weight 0 and the loss is a weighted one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from human_dynamics_tpu_torch.parallel.halo import halo_pad
from human_dynamics_tpu_torch.parallel.mesh import TIME_AXIS, Mesh, all_sum

from human_dynamics_tpu_torch.core.projection import orth_proj_optcam


def _sum_by_nonzero_weights(losses: torch.Tensor, weights: torch.Tensor,
                            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """sum(w * l) / max(1, #nonzero w broadcast against l)."""
    weighted = losses * weights
    nonzero = torch.broadcast_to(weights != 0.0, losses.shape).sum()
    if mesh is not None:
        nonzero = all_sum(nonzero, mesh, mesh.batch_axes)
    return weighted.sum() / torch.clamp(nonzero, min=1).to(losses.dtype)


def _mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """mean(x); with a mesh this rank's share of the global batch's mean."""
    if mesh is None:
        return torch.mean(x)
    return x.sum() / (x.numel() * mesh.axis_size(mesh.batch_axes))


def keypoint_l1_loss(kp_gt: torch.Tensor, kp_pred: torch.Tensor,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Visibility-weighted L1 keypoint loss; kp_gt (..., K, 3) with the
    visibility channel, kp_pred (..., K, 2)."""
    gt = kp_gt.reshape(-1, 3)
    pred = kp_pred.reshape(-1, 2)
    vis = gt[:, 2:3].to(pred.dtype)
    return _sum_by_nonzero_weights(torch.abs(gt[:, :2] - pred), vis, mesh)


def keypoint_l1_loss_optcam(
    kp_gt: torch.Tensor, kp_pred: torch.Tensor, mesh: Optional[Mesh] = None,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 after the per-frame optimal (detached) camera.

    kp_gt (B, T, K, 3); kp_pred (B, T, K, 2); ``valid`` (T,), when given,
    weighs each frame's keypoints (0 leaves the frame out of the loss and
    its count; its camera is still fitted). Returns (loss, best_cam
    (B, T, 3)).
    """
    b, t = kp_gt.shape[:2]
    gt = kp_gt.reshape(b * t, -1, 3)
    pred = kp_pred.reshape(b * t, -1, 2)
    pred_sim, best_cam = orth_proj_optcam(pred, gt)
    if valid is not None:
        vis = gt[..., 2:] * valid.repeat(b)[:, None, None]
        gt = torch.cat([gt[..., :2], vis], dim=-1)
    return keypoint_l1_loss(gt, pred_sim, mesh), best_cam.reshape(b, t, 3)


def masked_mse(params_gt: torch.Tensor, params_pred: torch.Tensor,
               has_gt: torch.Tensor, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """0.5 * weighted MSE with a per-row mask."""
    w = has_gt.to(params_pred.dtype).reshape(-1, 1)
    return 0.5 * _sum_by_nonzero_weights((params_gt - params_pred) ** 2, w,
                                         mesh)


def align_by_pelvis(joints: torch.Tensor) -> torch.Tensor:
    """Subtract the hip midpoint; LSP order, hips at 3 (L) and 2 (R).
    joints (..., 14, 3)."""
    pelvis = (joints[..., 3, :] + joints[..., 2, :]) / 2.0
    return joints - pelvis[..., None, :]


def loss_3d(
    poses_gt: torch.Tensor,
    poses_pred: torch.Tensor,
    shapes_gt: torch.Tensor,
    shapes_pred: torch.Tensor,
    joints_gt: torch.Tensor,
    joints_pred: torch.Tensor,
    has_gt3d_smpl: torch.Tensor,
    has_gt3d_joints: torch.Tensor,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pose-rotmat MSE, shape MSE and pelvis-aligned joint MSE, each masked
    by availability.

    poses_*, shapes_*: N = B*T' rows of any trailing shape; joints_*
    (B, T', 14, 3); has_gt3d_* (N,) flags, already repeated per frame.
    """
    n = has_gt3d_smpl.shape[0]
    jg = align_by_pelvis(joints_gt.reshape(-1, joints_gt.shape[-2], 3))
    jp = align_by_pelvis(joints_pred.reshape(-1, joints_pred.shape[-2], 3))
    loss_pose = masked_mse(poses_gt.reshape(n, -1),
                           poses_pred.reshape(n, -1), has_gt3d_smpl, mesh)
    loss_shape = masked_mse(shapes_gt.reshape(n, -1),
                            shapes_pred.reshape(n, -1), has_gt3d_smpl, mesh)
    loss_joints = masked_mse(jg.reshape(n, -1), jp.reshape(n, -1),
                             has_gt3d_joints, mesh)
    return loss_pose, loss_shape, loss_joints


def beta_smoothness_loss(shapes: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """0.5 * MSE between consecutive betas; shapes (B, T, 10).

    On a mesh with a ``time`` axis ``shapes`` is this rank's (Bl, Tl, 10)
    block: its last frame pairs with the next rank's first, taken with its
    gradient by a differentiable halo, and the last rank's last frame
    pairs with nothing (weight 0): the B·(T-1)·10 differences of the whole
    batch over its ranks."""
    if mesh is None or TIME_AXIS not in mesh.shape:
        return 0.5 * _mean((shapes[:, :-1] - shapes[:, 1:]) ** 2, mesh)
    seq = halo_pad(shapes, mesh, TIME_AXIS)[:, 1:]
    valid = torch.ones(shapes.shape[1], 1, dtype=shapes.dtype,
                       device=shapes.device)
    valid[-1] = float(mesh.index(TIME_AXIS) < mesh.shape[TIME_AXIS] - 1)
    return 0.5 * _sum_by_nonzero_weights(
        (seq[:, :-1] - seq[:, 1:]) ** 2, valid, mesh)


def shape_prior_loss(shapes: torch.Tensor,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """L2 prior on betas."""
    return _mean(shapes ** 2, mesh)


# LSGAN losses on discriminator outputs (N, 24).

def lsgan_encoder_loss(out_fake: torch.Tensor,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    return _mean(torch.sum((out_fake - 1.0) ** 2, dim=1), mesh)


def lsgan_disc_fake_loss(out_fake: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    return _mean(torch.sum(out_fake ** 2, dim=1), mesh)


def lsgan_disc_real_loss(out_real: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    return _mean(torch.sum((out_real - 1.0) ** 2, dim=1), mesh)


def hallucinator_mse(movie_strip: torch.Tensor, hal_strip: torch.Tensor,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """mean((movie_strip - hal_strip)^2); the gradient flows into both."""
    return _mean((movie_strip - hal_strip) ** 2, mesh)
