"""Evaluation metrics on the device: the per-tube error dict as scalars.

Counterpart of ``human_dynamics_tpu/eval/metrics_device.py``, as plain
functions on tensors. The numpy library (``eval/metrics.py``) is the
behavioral oracle. This module computes the SAME per-tube aggregates on
the predictions' device, so the evaluator fetches a handful of scalars per
tube instead of the verts/joints arrays (a 500-frame tube's verts are
~41 MB).

Aggregation contract: the harness aggregates mean-of-means
(``metrics.mean_of_dict_values``: nanmean over a tube's per-frame values,
then nanmean over tubes). Each function here therefore returns the
TUBE-level nanmean directly (masked means where the numpy path writes NaN
rows), so ``Evaluator(device_metrics=True)`` plugs into the same
aggregation unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from human_dynamics_tpu_torch.core.rotations import rot_to_axis_angle
from human_dynamics_tpu_torch.core.smpl import smpl_forward


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean of values[mask]; NaN when the mask is empty (matches nanmean of
    an all-NaN list). where-form, so that NaNs in MASKED entries (e.g. the
    ridge solve of an all-invisible frame) cannot contaminate it."""
    return (torch.where(mask, values, torch.zeros_like(values)).sum()
            / mask.to(values.dtype).sum())


def accel_magnitude(joints: torch.Tensor,
                    frame_mask: torch.Tensor) -> torch.Tensor:
    """Tube mean of ||second finite difference|| (the reference's
    eval_util.py:14-27 + the harness's per-tube nanmean). joints (N, K, 3)
    -> scalar; an accel frame is valid when all three frames it touches
    are real."""
    accel = torch.diff(joints, n=2, dim=0)
    keep = frame_mask[:-2] & frame_mask[1:-1] & frame_mask[2:]
    per_frame = torch.linalg.vector_norm(accel, dim=2).mean(dim=1)
    return _masked_mean(per_frame, keep)


def accel_error(joints_gt: torch.Tensor, joints_pred: torch.Tensor,
                vis: torch.Tensor) -> torch.Tensor:
    """Tube mean of ||accel_gt - accel_pred|| over accel frames whose three
    frames are all visible (eval_util.py:63-94)."""
    accel = (torch.diff(joints_pred, n=2, dim=0)
             - torch.diff(joints_gt, n=2, dim=0))
    err = torch.linalg.vector_norm(accel, dim=2)
    keep = vis[:-2] & vis[1:-1] & vis[2:]
    return _masked_mean(err.mean(dim=1), keep)


def align_by_pelvis(joints: torch.Tensor) -> torch.Tensor:
    """(..., 14, 3); LSP hips at idx 3 (L) / 2 (R) (eval_util.py:158-174)."""
    pelvis = (joints[..., 3, :] + joints[..., 2, :]) / 2.0
    return joints - pelvis[..., None, :]


def similarity_align(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Batched orthogonal Procrustes: align s1 (N, K, 3) onto s2.

    Same math as metrics.compute_similarity_transform_batch: one batched
    SVD of the (N, 3, 3) cross-covariances (eval_util.py:177-232). The sign
    of det(U V^T) fixes the reflection, so the SVD's sign conventions do
    not change the result.
    """
    x1 = s1.transpose(-1, -2)                                 # (N, 3, K)
    x2 = s2.transpose(-1, -2)
    d = x1.shape[-2]

    mu1 = x1.mean(dim=-1, keepdim=True)
    mu2 = x2.mean(dim=-1, keepdim=True)
    x1c = x1 - mu1
    x2c = x2 - mu2

    var1 = (x1c ** 2).sum(dim=(-2, -1))                       # (N,)
    k = torch.einsum("nik,njk->nij", x1c, x2c)                # (N, 3, 3)

    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(torch.einsum("nij,nkj->nik", u, v))
    z = torch.eye(d, dtype=s1.dtype, device=s1.device).repeat(
        s1.shape[0], 1, 1)
    z[:, -1, -1] = torch.sign(det)
    r = torch.einsum("nij,njk,nlk->nil", v, z, u)             # V Z U^T

    scale = torch.einsum("nij,nji->n", r, k) / var1
    t = mu2 - scale[:, None, None] * torch.einsum("nij,njk->nik", r, mu1)
    s1_hat = scale[:, None, None] * torch.einsum("nij,njk->nik", r, x1) + t
    return s1_hat.transpose(-1, -2)


def error_3d(gt3ds: torch.Tensor, preds: torch.Tensor,
             vis: torch.Tensor) -> tuple:
    """Tube-mean MPJPE and PA-MPJPE over visible frames
    (eval_util.py:30-60). gt3ds/preds (N, 14, 3); vis (N,) bool."""
    gt_a = align_by_pelvis(gt3ds)
    pred_a = align_by_pelvis(preds)
    per_frame = torch.linalg.vector_norm(gt_a - pred_a, dim=2).mean(dim=1)
    # The Procrustes alignment of invisible frames is computed but masked
    # out of the mean.
    pred_sym = similarity_align(pred_a, gt_a)
    per_frame_pa = torch.linalg.vector_norm(gt_a - pred_sym,
                                            dim=2).mean(dim=1)
    return _masked_mean(per_frame, vis), _masked_mean(per_frame_pa, vis)


def opt_cams(got: torch.Tensor, want: torch.Tensor,
             vis: torch.Tensor) -> torch.Tensor:
    """Ridge-regularised optimal [scale, tx, ty] per frame mapping got onto
    want over visible points, then the transformed points: the device twin
    of metrics.compute_opt_cams_batch (eval_util.py:235-260) with the 2x2
    solve in closed form."""
    w = vis.to(got.dtype)[..., None]                          # (N, K, 1)
    n_vis = torch.clamp(w.sum(dim=1), min=1.0)                # (N, 1)
    mu1 = (got * w).sum(dim=1) / n_vis                        # (N, 2)
    mu2 = (want * w).sum(dim=1) / n_vis
    x = (got - mu1[:, None]) * w
    y = (want - mu2[:, None]) * w

    a11 = (x[..., 0] * x[..., 0]).sum(dim=1) + 1e-6
    a12 = (x[..., 0] * x[..., 1]).sum(dim=1)
    a22 = (x[..., 1] * x[..., 1]).sum(dim=1) + 1e-6
    b11 = (x[..., 0] * y[..., 0]).sum(dim=1)
    b12 = (x[..., 0] * y[..., 1]).sum(dim=1)
    b21 = (x[..., 1] * y[..., 0]).sum(dim=1)
    b22 = (x[..., 1] * y[..., 1]).sum(dim=1)
    det = a11 * a22 - a12 * a12
    scale = (a22 * b11 - a12 * b21 - a12 * b12 + a11 * b22) / det / 2.0

    safe = torch.where(scale.abs() > 1e-12, scale,
                       torch.full_like(scale, float("nan")))
    trans = mu2 / safe[:, None] - mu1
    return safe[:, None, None] * (got + trans[:, None])


def kp_errors(
    kps_gt: torch.Tensor,
    kps_pred_px: torch.Tensor,
    alpha: float,
    min_visible: int,
    frame_mask: Optional[torch.Tensor] = None,
) -> tuple:
    """Tube-mean kp px error, PA kp error, PCK@alpha; frames with fewer
    than min_visible visible kps are masked (the numpy path marks them NaN
    and nanmeans; eval_util.py:97-137)."""
    vis = kps_gt[..., 2] != 0                                 # (N, K)
    gt_xy = kps_gt[..., :2]
    n_vis = vis.sum(dim=1)
    valid = n_vis >= max(min_visible, 1)
    if frame_mask is not None:
        valid = valid & frame_mask

    w = vis.to(kps_pred_px.dtype)
    denom = torch.clamp(n_vis, min=1)
    diffs = torch.linalg.vector_norm(gt_xy - kps_pred_px, dim=2)
    err = (diffs * w).sum(dim=1) / denom

    pred_pa = opt_cams(kps_pred_px, gt_xy, vis)
    diffs_pa = torch.linalg.vector_norm(gt_xy - pred_pa, dim=2)
    err_pa = (diffs_pa * w).sum(dim=1) / denom
    pck = ((diffs_pa < alpha) * w).sum(dim=1) / denom

    return (
        _masked_mean(err, valid),
        _masked_mean(err_pa, valid),
        _masked_mean(pck, valid),
    )


def verts_error(verts_gt: torch.Tensor, verts_pred: torch.Tensor,
                vis: torch.Tensor) -> torch.Tensor:
    """Tube-mean per-vertex error over visible frames
    (eval_util.py:140-153)."""
    per_frame = torch.linalg.vector_norm(verts_gt - verts_pred,
                                         dim=2).mean(dim=1)
    return _masked_mean(per_frame, vis)


def make_compute_errors_device(smpl):
    """A function computing the whole per-tube error dict (the reference's
    eval.py:114-193 keys, tube-level scalars) on the inputs' device, with
    ``smpl`` (an SmplModel on that device) closed over. Flags select the
    computed subset; the caller fetches <= 9 scalars."""

    @torch.inference_mode()
    def compute(
        kps_gt: torch.Tensor,                       # (N, K, 3) px + vis
        kps_pred: torch.Tensor,                     # (N, K, 2) normalised
        joints_gt: Optional[torch.Tensor] = None,   # (N, 14, 3)
        joints_pred: Optional[torch.Tensor] = None,  # (N, 14, 3)
        poses_gt: Optional[torch.Tensor] = None,    # (N, 72) axis-angle
        poses_pred: Optional[torch.Tensor] = None,  # (N, 24, 3, 3)
        shape_gt: Optional[torch.Tensor] = None,    # (10,)
        shapes_pred: Optional[torch.Tensor] = None,  # (N, 10)
        num_frames: Optional[int] = None,           # real frames <= N
        img_size: int = 224,
        has_3d: bool = False,
        min_visible: int = 6,
        compute_mesh: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """With ``num_frames``, the rows from ``num_frames`` on are padding
        and are masked out of every aggregate. Padded poses_pred must be
        identity rotations (rot_to_axis_angle of a zero matrix is NaN)."""
        n_total = kps_gt.shape[0]
        dev = kps_gt.device
        frame_mask = torch.arange(n_total, device=dev) < (
            n_total if num_frames is None else num_frames)
        kps_gt_f = kps_gt.float()
        err_kp, err_kp_pa, err_pck = kp_errors(
            kps_gt_f,
            (kps_pred.float() + 1.0) * 0.5 * img_size,
            alpha=0.05 * img_size,
            min_visible=min_visible,
            frame_mask=frame_mask,
        )
        out = {
            "accel": accel_magnitude(joints_pred, frame_mask),
            "kp": err_kp,
            "kp_pa": err_kp_pa,
            "kp_pck": err_pck,
        }
        if not has_3d:
            return out

        vis = (kps_gt_f[:, :14, 2].sum(dim=1) > min_visible) & frame_mask
        joints_gt_f = joints_gt.float()
        out["accel_error"] = accel_error(joints_gt_f, joints_pred, vis)
        out["joints"], out["joints_pa"] = error_3d(joints_gt_f, joints_pred,
                                                   vis)

        if compute_mesh:
            n = poses_gt.shape[0]
            shapes_gt_t = shape_gt.reshape(1, 10).expand(n, 10)
            poses_pred_aa = rot_to_axis_angle(poses_pred).reshape(n, 72)
            zeros = torch.zeros_like(poses_gt)
            gt_tpose = smpl_forward(smpl, shapes_gt_t, zeros).verts
            pred_tpose = smpl_forward(smpl, shapes_pred, zeros).verts
            out["mesh_tpose"] = verts_error(gt_tpose, pred_tpose, vis)
            gt_posed = smpl_forward(smpl, shapes_gt_t, poses_gt).verts
            pred_posed = smpl_forward(smpl, shapes_pred, poses_pred_aa).verts
            out["mesh_posed"] = verts_error(gt_posed, pred_posed, vis)
        return out

    return compute
