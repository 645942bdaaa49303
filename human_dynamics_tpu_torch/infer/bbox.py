"""Keypoint track -> smooth bounding-box parameters.

A numpy/scipy copy of ``human_dynamics_tpu/infer/bbox.py`` (the reference's
src/util/smooth_bbox.py; [cx, cy, scale] maps the person's height to
150 px), kept in the port because importing the JAX package's ``infer``
subpackage imports JAX. Host-side, once per track.

Detections are collected into one (N, 3) array with NaN rows for missed
frames, gaps are filled with one ``np.interp`` per parameter, and the
smoothing is one 2-D median filter and one axis-0 gaussian.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def kp_to_bbox_param(
    kp: Optional[np.ndarray], vis_thresh: float
) -> Optional[np.ndarray]:
    """Kx3 keypoints -> [cx, cy, scale] or None.

    Center is the midpoint of the visible-keypoint extent; scale maps the
    extent diagonal ("person height") to 150 px. Detections with <0.5 px
    extent are rejected. Parity: smooth_bbox.py:37-61.
    """
    if kp is None:
        return None
    visible = np.asarray(kp)[np.asarray(kp)[:, 2] > vis_thresh, :2]
    if visible.size == 0:
        return None
    lo, hi = visible.min(axis=0), visible.max(axis=0)
    height = float(np.hypot(*(hi - lo)))
    if height < 0.5:
        return None
    return np.concatenate([(lo + hi) / 2.0, [150.0 / height]])


def get_all_bbox_params(
    kps: Sequence[Optional[np.ndarray]], vis_thresh: float = 2
) -> Tuple[np.ndarray, int, int]:
    """Per-frame bbox params with linear interpolation over gaps.

    Returns ``(bbox_params (M, 3), start (incl), end (excl))`` where
    frames before the first and after the last detection are dropped and
    interior gaps are linearly interpolated. Parity: smooth_bbox.py:64-105.
    """
    per_frame = np.full((len(kps), 3), np.nan)
    for i, kp in enumerate(kps):
        param = kp_to_bbox_param(kp, vis_thresh=vis_thresh)
        if param is not None:
            per_frame[i] = param

    detected = np.flatnonzero(~np.isnan(per_frame[:, 0]))
    if detected.size == 0:
        return np.empty((0, 3)), -1, 0
    start, end = int(detected[0]), int(detected[-1]) + 1

    frames = np.arange(start, end)
    filled = np.stack(
        [np.interp(frames, detected, per_frame[detected, c]) for c in range(3)],
        axis=1,
    )
    return filled, start, end


def smooth_bbox_params(
    bbox_params: np.ndarray, kernel_size: int = 11, sigma: float = 8
) -> np.ndarray:
    """Median filter (zero-padded, matching scipy.signal.medfilt) then
    gaussian filter along time, per parameter. Parity: smooth_bbox.py:108-123.
    """
    medianed = ndimage.median_filter(
        bbox_params, size=(kernel_size, 1), mode="constant", cval=0.0
    )
    return ndimage.gaussian_filter1d(medianed, sigma, axis=0)


def get_smooth_bbox_params(
    kps: List[Optional[np.ndarray]],
    vis_thresh: float = 2,
    kernel_size: int = 11,
    sigma: float = 3,
) -> Tuple[np.ndarray, int, int]:
    """Interpolated + median + gaussian smoothed [cx, cy, scale] per frame.

    Returns (smoothed (start+M, 3) with zero rows before `start`, start,
    end). Parity: smooth_bbox.py:10-34.
    """
    bbox_params, start, end = get_all_bbox_params(kps, vis_thresh)
    smoothed = smooth_bbox_params(bbox_params, kernel_size, sigma)
    return np.vstack((np.zeros((start, 3)), smoothed)), start, end
