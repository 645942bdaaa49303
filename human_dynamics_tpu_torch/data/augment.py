"""Tube (video-consistent) augmentation on the device, for a batch of tubes.

Counterpart of ``human_dynamics_tpu/data/augment.py``: temporally coherent
jitter by reflecting-boundary random walks, one flip per tube (the 25-kp
L/R swap and the SMPL pose mirror), in-plane rotation with the global
pose updated. The image chain (resize, edge pad, crop, rotate) is one
affine warp per frame: each output pixel pulls from the inverse of
``crop(center + trans, scale=2^s, rot=theta)`` by bilinear sampling with
the edge clamped.

The JAX package maps one tube's function over the batch (``vmap``); here
every function takes the tubes as a leading dimension, so a batch is one
call. The random walks draw from an explicit ``torch.Generator``, so their
numbers are not JAX's: the same sampled parameters give the same outputs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from human_dynamics_tpu_torch.core.rotations import (
    rodrigues,
    rot_to_axis_angle,
)

# COCO-25 L/R swap.
COCO25_FLIP_INDS = np.array(
    [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 16, 15, 18, 17,
     20, 19, 22, 21, 24, 23]
)

# SMPL 72-D mirror permutation and sign flips.
POSE_SWAP_INDS = np.array([
    0, 1, 2, 6, 7, 8, 3, 4, 5, 9, 10, 11, 15, 16, 17, 12, 13, 14, 18,
    19, 20, 24, 25, 26, 21, 22, 23, 27, 28, 29, 33, 34, 35, 30, 31, 32,
    36, 37, 38, 42, 43, 44, 39, 40, 41, 45, 46, 47, 51, 52, 53, 48, 49,
    50, 57, 58, 59, 54, 55, 56, 63, 64, 65, 60, 61, 62, 69, 70, 71, 66,
    67, 68
])
POSE_SIGN_FLIP = np.tile([1.0, -1.0, -1.0], 24).astype(np.float32)

# LSP-14 L/R swap.
JOINTS3D_FLIP_INDS = np.array([5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13])


def bounded_random_walk(
    generator: torch.Generator,
    minval: float,
    maxval: float,
    delta_min: float,
    delta_max: float,
    t: int,
    dim: int = 1,
    integer: bool = False,
    num_tubes: int = 1,
) -> torch.Tensor:
    """(num_tubes, t, dim) reflecting-boundary random walks in [min, max],
    on the generator's device. The fold ``|((walk + start - min + size)
    mod 2*size) - size| + min`` reflects the cumulative walk."""
    dev = generator.device
    if maxval <= minval:
        return torch.ones(num_tubes, t, dim, device=dev) * minval
    if integer:
        start = torch.randint(minval, maxval, (num_tubes, 1, dim),
                              generator=generator, device=dev).float()
        steps = torch.randint(delta_min, delta_max, (num_tubes, t, dim),
                              generator=generator, device=dev)
        walk = torch.cumsum(steps.float(), dim=1)
    else:
        start = (torch.rand(num_tubes, 1, dim, generator=generator,
                            device=dev) * (maxval - minval) + minval)
        walk = torch.cumsum(
            torch.rand(num_tubes, t, dim, generator=generator, device=dev)
            * (delta_max - delta_min) + delta_min,
            dim=1,
        )
    size = maxval - minval
    out = torch.abs((walk + start - minval + size) % (2 * size) - size) + minval
    return torch.round(out) if integer else out


def _index(x: torch.Tensor, inds: np.ndarray, dim: int) -> torch.Tensor:
    return x.index_select(dim, torch.as_tensor(inds, device=x.device))


def reflect_pose(pose: torch.Tensor) -> torch.Tensor:
    """Mirror (..., 72) SMPL poses."""
    sign = torch.as_tensor(POSE_SIGN_FLIP, device=pose.device)
    return _index(pose, POSE_SWAP_INDS, -1) * sign


def reflect_joints3d(joints: torch.Tensor) -> torch.Tensor:
    """Mirror (..., 14, 3) 3-D joints and re-centre them."""
    flipped = _index(joints, JOINTS3D_FLIP_INDS, -2)
    flipped = flipped * torch.tensor([-1.0, 1.0, 1.0], device=joints.device)
    return flipped - flipped.mean(dim=-2, keepdim=True)


def flip_kps(kps: torch.Tensor, img_width: float) -> torch.Tensor:
    """Mirror (..., 25, 3) 2-D keypoints in an image of width w (x -> w - x
    - 1) with the 25-kp L/R swap."""
    new_x = img_width - kps[..., 0] - 1.0
    out = torch.stack([new_x, kps[..., 1], kps[..., 2]], dim=-1)
    return _index(out, COCO25_FLIP_INDS, -2)


def _rot_z(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about z by the angle of (cos, sin)."""
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([
        torch.stack([cos, -sin, zero], dim=-1),
        torch.stack([sin, cos, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def rotate_global_pose(pose: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """In-plane rotation of (..., 72) poses' global rotation by theta (...):
    R0' = Rz(theta)^T R0."""
    rz = _rot_z(torch.cos(theta), torch.sin(theta))
    r0_new = rz.transpose(-1, -2) @ rodrigues(pose[..., :3])
    return torch.cat([rot_to_axis_angle(r0_new), pose[..., 3:]], dim=-1)


class TubeAugmentParams(NamedTuple):
    """Sampled augmentation, one sample per tube, applied per frame:
    trans (B, T, 2) integer-valued centre jitter, scale (B, T) log2 scale
    jitter, rotate (B, T) radians, flip (B,) bool."""

    trans: torch.Tensor
    scale: torch.Tensor
    rotate: torch.Tensor
    flip: torch.Tensor


def sample_tube_params(
    generator: torch.Generator,
    num_tubes: int,
    t: int,
    trans_max: int = 20,
    delta_trans_max: int = 3,
    scale_max: float = 0.3,
    delta_scale_max: float = 0.05,
    rotate_max: float = 0.0,
    delta_rotate_max: float = 0.0,
) -> TubeAugmentParams:
    """Random walks and one flip for each of ``num_tubes`` tubes."""
    trans = bounded_random_walk(
        generator, -trans_max, trans_max + 1, -delta_trans_max,
        delta_trans_max + 1, t, dim=2, integer=True, num_tubes=num_tubes,
    )
    scale = bounded_random_walk(
        generator, -scale_max, scale_max, -delta_scale_max, delta_scale_max,
        t, num_tubes=num_tubes,
    )[..., 0]
    rotate = bounded_random_walk(
        generator, -rotate_max, rotate_max, -delta_rotate_max,
        delta_rotate_max, t, num_tubes=num_tubes,
    )[..., 0]
    flip = torch.rand(num_tubes, generator=generator,
                      device=generator.device) < 0.5
    return TubeAugmentParams(trans, scale, rotate, flip)


def _bilinear_sample(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample images (N, H, W, C) at float coords (N, ..., 2) [x, y] with
    the edge clamped -> (N, ..., C) float32. uint8 images are read as
    value / 255 (each sampled value, as dividing the whole image would)."""
    n, h, w, c = images.shape
    flat = images.reshape(n, h * w, c)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0

    def at(ix, iy):
        ix = torch.clamp(ix, 0, w - 1).long()
        iy = torch.clamp(iy, 0, h - 1).long()
        idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
        v = torch.gather(flat, 1, idx).reshape(coords.shape[:-1] + (c,))
        return v.float() / 255.0 if v.dtype == torch.uint8 else v

    v00 = at(x0, y0)
    v01 = at(x0 + 1, y0)
    v10 = at(x0, y0 + 1)
    v11 = at(x0 + 1, y0 + 1)
    fx, fy = fx[..., None], fy[..., None]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def augment_tube(
    images: torch.Tensor,
    labels: torch.Tensor,
    centers: torch.Tensor,
    poses: torch.Tensor,
    gt3ds: torch.Tensor,
    params: TubeAugmentParams,
    output_size: int = 224,
    apply_rotation: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jitter, scale, rotate and flip B tubes into crops with their labels.

    images (B, T, H, W, 3), float in [0, 1] or uint8; labels (B, T, 3, K)
    keypoints channel-first in source pixels; centers (B, T, 2); poses
    (B, T, 72); gt3ds (B, T, 14, 3). Returns crops (B, T, S, S, 3) in
    [-1, 1], labels (B, T, 3, K) normalised to [-1, 1] and zeroed where
    invisible, poses and gt3ds.
    """
    b, t_len, h, w = images.shape[:4]
    s_out = output_size
    half = s_out / 2.0
    dev = images.device

    scale_factor = 2.0 ** params.scale                        # (B, T)
    # The jittered centre in source pixels; the crop starts at
    # (centre + trans) * factor - half.
    center_j = centers.float() + params.trans                # (B, T, 2)
    theta = params.rotate
    cos, sin = torch.cos(theta), torch.sin(theta)

    # The output pixel grid relative to the crop centre.
    xs = torch.arange(s_out, dtype=torch.float32, device=dev) - half
    gx, gy = torch.meshgrid(xs, xs, indexing="xy")           # (S, S)

    # Inverse map: rotate about the crop centre by +theta, unscale, offset
    # by the jittered centre.
    co, si = cos[..., None, None], sin[..., None, None]
    sf = scale_factor[..., None, None]
    rx = co * gx - si * gy
    ry = si * gx + co * gy
    src_x = (rx + sf * center_j[..., 0, None, None]) / sf
    src_y = (ry + sf * center_j[..., 1, None, None]) / sf
    coords = torch.stack([src_x, src_y], dim=-1).reshape(
        b * t_len, s_out, s_out, 2)
    crops = _bilinear_sample(
        images.reshape((b * t_len,) + images.shape[2:]), coords
    ).reshape(b, t_len, s_out, s_out, -1)

    # Keypoints: scale, express in crop coordinates, rotate about the crop
    # centre (kp_rot = R^T (kp - c)).
    vis = labels[:, :, 2, :]                                  # (B, T, K)
    kp_scaled = labels[:, :, :2, :] * scale_factor[..., None, None]
    crop_origin = scale_factor[..., None] * center_j - half   # (B, T, 2)
    kp_crop = kp_scaled - crop_origin[..., None]
    kx = kp_crop[:, :, 0] - half
    ky = kp_crop[:, :, 1] - half
    kx_r = cos[..., None] * kx + sin[..., None] * ky
    ky_r = -sin[..., None] * kx + cos[..., None] * ky
    kps_t = torch.stack([kx_r + half, ky_r + half, vis], dim=2)  # (B,T,3,K)

    # 3-D joints rotate about their mean; the global pose is updated. Both
    # only when the rotation range is not zero.
    if apply_rotation:
        r = _rot_z(cos, sin)
        mean = gt3ds.mean(dim=(-2, -1), keepdim=True)
        gt3ds = (gt3ds - mean) @ r + mean
        poses = rotate_global_pose(poses, theta)

    # Flip whole tubes.
    flip = params.flip
    kps_flipped = flip_kps(kps_t.transpose(-1, -2), float(s_out)).transpose(
        -1, -2)
    kps_t = torch.where(flip[:, None, None, None], kps_flipped, kps_t)
    crops = torch.where(flip[:, None, None, None, None],
                        torch.flip(crops, dims=[3]), crops)
    poses = torch.where(flip[:, None, None], reflect_pose(poses), poses)
    gt3ds = torch.where(flip[:, None, None, None], reflect_joints3d(gt3ds),
                        gt3ds)

    # Keypoints to [-1, 1], the invisible zeroed.
    final_vis = (kps_t[:, :, 2, :] > 0).float()
    final = torch.stack([
        2.0 * (kps_t[:, :, 0, :] / s_out) - 1.0,
        2.0 * (kps_t[:, :, 1, :] / s_out) - 1.0,
        final_vis,
    ], dim=2)
    final = final * final_vis[:, :, None, :]

    # [0, 1] -> [-1, 1].
    crops = (crops - 0.5) * 2.0
    return crops, final, poses, gt3ds


def augment_batch(
    images: torch.Tensor,
    labels: torch.Tensor,
    centers: torch.Tensor,
    poses: torch.Tensor,
    gt3ds: torch.Tensor,
    params: TubeAugmentParams,
    output_size: int = 224,
    apply_rotation: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training batch's augmentation: uint8 frames (B, T, H, W, 3) ->
    crops in [-1, 1], keypoints (B, T, K, 3), poses (B, T, 72), gt3ds."""
    crops, kps, poses, gt3ds = augment_tube(
        images, labels, centers, poses, gt3ds, params,
        output_size=output_size, apply_rotation=apply_rotation,
    )
    return crops, kps.transpose(-1, -2), poses, gt3ds
