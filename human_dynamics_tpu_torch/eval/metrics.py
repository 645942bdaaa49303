"""Evaluation metric library (MPJPE, PA-MPJPE, PCK, accel error, ...).

A copy of ``human_dynamics_tpu/eval/metrics.py``, the numpy
oracle of both packages: the port imports nothing of the JAX package.

Behavioral parity target: the reference's src/evaluation/eval_util.py
(already numpy there; SURVEY.md §7 stage 5 calls for a near-direct
behavior match). Implemented vectorized over frames — the reference loops
per frame with per-frame SVDs; here the Procrustes solve is one batched
``np.linalg.svd`` over the whole sequence, which matters because eval
touches every frame of every test tube.

All functions take/return numpy; eval is host-side (predictions arrive
from the device in one transfer).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_accel(joints: np.ndarray) -> np.ndarray:
    """Mean magnitude of the 2nd finite difference (eval_util.py:14-27).

    joints (N, K, 3) -> (N-2,).
    """
    velocities = joints[1:] - joints[:-1]
    acceleration = velocities[1:] - velocities[:-1]
    return np.mean(np.linalg.norm(acceleration, axis=2), axis=1)


def compute_error_accel(
    joints_gt: np.ndarray,
    joints_pred: np.ndarray,
    vis: Optional[np.ndarray] = None,
) -> np.ndarray:
    """|| (x-1 - 2x + x+1)_gt - (.)_pred || per accel frame.

    An accel frame i is valid only when all three frames i, i+1, i+2 it
    touches are visible. Returns (M,) for the M valid frames. Behavioral
    parity: eval_util.py:63-94.
    """
    accel_err = np.linalg.norm(
        np.diff(joints_pred, n=2, axis=0) - np.diff(joints_gt, n=2, axis=0),
        axis=2,
    )
    if vis is None:
        keep = np.ones(len(accel_err), dtype=bool)
    else:
        v = np.asarray(vis, dtype=bool)
        keep = v[:-2] & v[1:-1] & v[2:]
    return np.mean(accel_err[keep], axis=1)


def align_by_pelvis(
    joints: np.ndarray, get_pelvis: bool = False
):
    """Pelvis (midpoint of LSP hips, idx 3/2) to origin
    (eval_util.py:158-174). Batched: joints (..., 14, 3)."""
    pelvis = (joints[..., 3, :] + joints[..., 2, :]) / 2.0
    aligned = joints - pelvis[..., None, :]
    if get_pelvis:
        return aligned, pelvis
    return aligned


def compute_similarity_transform_batch(
    s1: np.ndarray, s2: np.ndarray
) -> np.ndarray:
    """Batched orthogonal-Procrustes alignment of s1 onto s2.

    s1, s2: (N, K, 3) point sets. Returns aligned s1_hat (N, K, 3).
    Vectorized form of eval_util.py:177-232 (one batched SVD instead of a
    python loop of per-frame SVDs).
    """
    # Work in (N, D, K) like the reference (D = 2 or 3).
    x1 = np.transpose(s1, (0, 2, 1)).astype(np.float64)
    x2 = np.transpose(s2, (0, 2, 1)).astype(np.float64)
    d = x1.shape[1]

    mu1 = x1.mean(axis=2, keepdims=True)
    mu2 = x2.mean(axis=2, keepdims=True)
    x1c = x1 - mu1
    x2c = x2 - mu2

    var1 = np.sum(x1c**2, axis=(1, 2))                      # (N,)
    k = np.einsum("nik,njk->nij", x1c, x2c)                 # (N, D, D)

    u, _, vh = np.linalg.svd(k)
    v = np.transpose(vh, (0, 2, 1))
    det = np.linalg.det(np.einsum("nij,nkj->nik", u, v))    # det(U V^T)
    z = np.tile(np.eye(d), (len(s1), 1, 1))
    z[:, -1, -1] = np.sign(det)
    r = np.einsum("nij,njk,nlk->nil", v, z, u)              # V Z U^T

    scale = np.einsum("nij,nji->n", r, k) / var1            # trace(RK)/var1
    t = mu2 - scale[:, None, None] * np.einsum("nij,njk->nik", r, mu1)
    s1_hat = scale[:, None, None] * np.einsum(
        "nij,njk->nik", r, x1
    ) + t
    return np.transpose(s1_hat, (0, 2, 1))


def compute_similarity_transform(
    s1: np.ndarray, s2: np.ndarray
) -> np.ndarray:
    """Single point-set Procrustes, matching the reference's (K, D) or
    (D, K) call signature (eval_util.py:177-232)."""
    if s1.shape[0] in (2, 3):
        # (D, K) layout.
        return compute_similarity_transform_batch(
            s1.T[None], s2.T[None]
        )[0].T
    return compute_similarity_transform_batch(s1[None], s2[None])[0]


def compute_error_3d(
    gt3ds: np.ndarray, preds: np.ndarray, vis: Optional[np.ndarray] = None
) -> Tuple[list, list]:
    """Per-frame MPJPE and PA-MPJPE on 14 joints (eval_util.py:30-60).

    Returns (errors, errors_pa) lists over visible frames.
    """
    assert len(gt3ds) == len(preds)
    gt3ds = np.asarray(gt3ds, np.float64).reshape(len(gt3ds), -1, 3)
    preds = np.asarray(preds, np.float64)

    keep = (
        np.ones(len(gt3ds), bool) if vis is None else np.asarray(vis, bool)
    )
    gt_a = align_by_pelvis(gt3ds[keep])
    pred_a = align_by_pelvis(preds[keep])

    joint_error = np.sqrt(np.sum((gt_a - pred_a) ** 2, axis=2))
    errors = list(np.mean(joint_error, axis=1))

    pred_sym = compute_similarity_transform_batch(pred_a, gt_a)
    pa_error = np.sqrt(np.sum((gt_a - pred_sym) ** 2, axis=2))
    errors_pa = list(np.mean(pa_error, axis=1))
    return errors, errors_pa


def compute_opt_cams_batch(
    got: np.ndarray, want: np.ndarray, vis: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched optimal weak-perspective cam [scale, tx, ty] mapping
    got -> want on the visible points of each frame.

    got, want: (N, K, 2); vis: (N, K) boolean. Returns
    (new_got (N, K, 2), cams (N, 3)). Solves the same ridge-regularized
    least squares as the reference (eval_util.py:235-260) — minimize
    ||s * (x + t) - y|| over visible points, with a 1e-6 ridge on the
    2x2 normal matrix — but as one batched ``np.linalg.solve`` instead
    of a per-frame inverse, and with a guarded scale: frames whose
    optimal scale is ~0 (e.g. all-invisible) yield NaN cams by design
    rather than tripping a divide warning.
    """
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    w = np.asarray(vis, dtype=np.float64)[..., None]          # (N, K, 1)

    n_vis = np.maximum(w.sum(axis=1), 1.0)                    # (N, 1)
    mu1 = (got * w).sum(axis=1) / n_vis                       # (N, 2)
    mu2 = (want * w).sum(axis=1) / n_vis
    x = (got - mu1[:, None]) * w                              # (N, K, 2)
    y = (want - mu2[:, None]) * w

    # Normal equations: (X^T X + eps I) s R = X^T Y, isotropic scale only.
    ata = np.einsum("nki,nkj->nij", x, x) + 1e-6 * np.eye(2)
    atb = np.einsum("nki,nkj->nij", x, y)
    scale = np.trace(np.linalg.solve(ata, atb), axis1=1, axis2=2) / 2.0

    safe = np.where(np.abs(scale) > 1e-12, scale, np.nan)
    trans = mu2 / safe[:, None] - mu1                         # (N, 2)
    new_got = safe[:, None, None] * (got + trans[:, None])
    cams = np.concatenate([safe[:, None], trans], axis=1)
    return new_got, cams


def compute_opt_cam_with_vis(
    got: np.ndarray, want: np.ndarray, vis: np.ndarray
):
    """Single-frame wrapper over :func:`compute_opt_cams_batch`
    (reference signature: eval_util.py:235-260)."""
    new_got, cams = compute_opt_cams_batch(got[None], want[None], vis[None])
    return new_got[0], cams[0]


def compute_error_kp(
    kps_gt: np.ndarray,
    kps_pred: np.ndarray,
    alpha: float = 0.05,
    min_visible: int = 6,
) -> Tuple[list, list, list]:
    """Pixel keypoint error, PA keypoint error, PCK@alpha, vectorized
    over frames. NaN marks frames with fewer than `min_visible` visible
    keypoints. Behavioral parity: eval_util.py:97-137.
    """
    kps_gt = np.asarray(kps_gt, dtype=np.float64)
    kps_pred = np.asarray(kps_pred, dtype=np.float64)
    assert len(kps_gt) == len(kps_pred)

    vis = kps_gt[..., 2].astype(bool)                         # (N, K)
    gt_xy = kps_gt[..., :2]
    n_vis = vis.sum(axis=1)
    valid = n_vis >= max(min_visible, 1)

    w = vis.astype(np.float64)
    denom = np.maximum(n_vis, 1)
    diffs = np.linalg.norm(gt_xy - kps_pred, axis=2)          # (N, K)
    err = (diffs * w).sum(axis=1) / denom

    with np.errstate(invalid="ignore"):
        pred_pa, _ = compute_opt_cams_batch(kps_pred, gt_xy, vis)
        diffs_pa = np.linalg.norm(gt_xy - pred_pa, axis=2)
        err_pa = (diffs_pa * w).sum(axis=1) / denom
        pck = ((diffs_pa < alpha) * w).sum(axis=1) / denom

    nan = np.where(valid, 0.0, np.nan)
    return list(err + nan), list(err_pa + nan), list(pck + nan)


def compute_error_verts(
    verts_gt: np.ndarray, verts_pred: np.ndarray
) -> np.ndarray:
    """Mean per-vertex error per frame (eval_util.py:140-153)."""
    assert len(verts_gt) == len(verts_pred)
    error_per_vert = np.sqrt(np.sum((verts_gt - verts_pred) ** 2, axis=2))
    return np.mean(error_per_vert, axis=1)


# Dict accumulators (eval_util.py:265-313) -----------------------------------

def update_dict_entries(accumulator: dict, appender: dict) -> None:
    for k in appender:
        accumulator.setdefault(k, []).append(appender[k])


def extend_dict_entries(accumulator: dict, appender: dict) -> None:
    for k, v in appender.items():
        accumulator.setdefault(k, [])
        if hasattr(v, "__iter__"):
            accumulator[k].extend(v)
        else:
            accumulator[k].append(v)


def concat_dict_entries(dictionary: dict) -> None:
    for k, v in dictionary.items():
        dictionary[k] = np.concatenate(v)


def mean_of_dict_values(dictionary: dict) -> None:
    """Mean-of-means aggregation, rounded to 5 places
    (eval_util.py:291-299)."""
    for k, v in dictionary.items():
        all_values = [np.nanmean(values) for values in v]
        dictionary[k] = float(round(np.nanmean(all_values), 5))


def axis_angle_to_rot_mat(poses_aa: np.ndarray) -> np.ndarray:
    """(72,) -> (24, 3, 3) via cv2.Rodrigues (eval_util.py:318-329)."""
    import cv2

    return np.array(
        [cv2.Rodrigues(p)[0] for p in poses_aa.reshape(-1, 3)]
    )


def rot_mat_to_axis_angle(rot_matrices: np.ndarray) -> np.ndarray:
    """(24, 3, 3) -> (72,) via cv2.Rodrigues (eval_util.py:332-344)."""
    import cv2

    return np.array(
        [cv2.Rodrigues(r)[0] for r in rot_matrices]
    ).reshape(72)
