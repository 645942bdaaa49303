"""Composite visualisations: the mesh on the crop, the mesh in the original
image, skeleton overlays, the video-level bbox.

Counterpart of ``human_dynamics_tpu/viz/composite.py`` (the reference's
visualize_img / visualize_img_orig / make_square / compute_video_bbox,
src/util/render/nmr_renderer.py:265-520), with the crop -> original-image
camera chain (nmr_renderer.py:388-404): a weak-perspective camera fit in
the 224 crop is re-expressed in normalised original-image coordinates.
Host numpy; the original image is resized by ``infer.crop.resize_img``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from human_dynamics_tpu_torch.infer.crop import resize_img
from human_dynamics_tpu_torch.viz.renderer import VisRenderer
from human_dynamics_tpu_torch.viz.skeleton import draw_skeleton, draw_text


def make_square(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad the shorter side (nmr_renderer.py:491-504)."""
    img_size = np.max(img.shape[:2])
    pad_vals = img_size - np.array(img.shape[:2])
    img = np.pad(
        img, ((0, pad_vals[0]), (0, pad_vals[1]), (0, 0)), mode="constant"
    )
    return img, pad_vals


def remove_pads(img: np.ndarray, pad_vals) -> np.ndarray:
    """Undo make_square (nmr_renderer.py:507-516)."""
    if pad_vals[0] != 0:
        img = img[:-pad_vals[0], :]
    if pad_vals[1] != 0:
        img = img[:, :-pad_vals[1]]
    return img


def crop_to_orig_cam(
    cam: np.ndarray,
    start_pt: np.ndarray,
    undo_scale,
    crop_size: float,
    img_size: float,
) -> np.ndarray:
    """Weak-perspective cam in the crop -> normalized original image
    (nmr_renderer.py:388-404)."""
    cam_crop = np.hstack(
        [crop_size * cam[0] * 0.5, cam[1:] + (2.0 / cam[0]) * 0.5]
    )
    cam_orig = np.hstack([
        cam_crop[0] * undo_scale,
        cam_crop[1:] + (start_pt - crop_size) / cam_crop[0],
    ])
    new_cam = np.hstack([
        cam_orig[0] * (2.0 / img_size),
        cam_orig[1:] - (1 / ((2.0 / img_size) * cam_orig[0])),
    ])
    return new_cam.astype(np.float32)


def visualize_img(
    img: np.ndarray,
    cam: np.ndarray,
    kp_pred: np.ndarray,
    vert: np.ndarray,
    renderer: VisRenderer,
    kp_gt: Optional[np.ndarray] = None,
    text: Optional[Dict] = None,
    rotated_view: bool = False,
    mesh_color: str = "blue",
    pad_vals=None,
    no_text: bool = False,
):
    """Skeleton overlay + mesh overlay (+ rotated view) for one frame.

    img: (S, S, 3) in [-1, 1]; kps normalized to [-1, 1].
    Returns (skel_img, rend_img[, rot_img]) each in [0, 1]
    (nmr_renderer.py:265-330).
    """
    text = dict(text or {})
    img_size = img.shape[0]
    text.update({"sc": cam[0], "tx": cam[1], "ty": cam[2]})
    if kp_gt is not None:
        gt_vis = kp_gt[:, 2].astype(bool)
        loss = np.sum((kp_gt[gt_vis, :2] - kp_pred[gt_vis]) ** 2)
        text["kpl"] = loss

    input_img = ((img + 1) * 0.5) * 255.0
    rend_img = renderer(
        vert, cam=cam, img=input_img, color_name=mesh_color,
        img_size=img_size,
    )
    if not no_text:
        rend_img = draw_text(rend_img, text)

    pred_joint = ((kp_pred + 1) * 0.5) * img_size
    skel_img = draw_skeleton(input_img, pred_joint)
    if kp_gt is not None:
        gt_joint = ((kp_gt[:, :2] + 1) * 0.5) * img_size
        skel_img = draw_skeleton(
            skel_img, gt_joint, draw_edges=False, vis=gt_vis
        )

    if pad_vals is not None:
        skel_img = remove_pads(skel_img, pad_vals)
        rend_img = remove_pads(rend_img, pad_vals)
    if rotated_view:
        rot_img = renderer.rotated(
            vert, 90, cam=cam, color_name=mesh_color, img_size=img_size
        )
        if pad_vals is not None:
            rot_img = remove_pads(rot_img, pad_vals)
        return skel_img / 255, rend_img / 255, rot_img / 255
    return skel_img / 255, rend_img / 255


def orig_view(
    cam,
    kp_pred,
    start_pt,
    scale,
    proc_img_shape,
    img: np.ndarray,
    max_img_size: int = 300,
    bbox=None,
    crop_cam=None,
):
    """The original image (in [-1, 1]) resized to at most ``max_img_size``
    and squared, with the crop's keypoints and camera re-expressed in it
    (nmr_renderer.py:333-404): returns (img, pad_vals, kp_orig, cam)."""
    if np.max(img.shape[:2]) > max_img_size:
        scale_orig = max_img_size / float(np.max(img.shape[:2]))
        img, _ = resize_img(img, scale_orig)
        undo_scale = (1.0 / np.array(scale)) * scale_orig
    else:
        undo_scale = 1.0 / np.array(scale)

    if bbox is not None:
        assert crop_cam is not None
        img = img[bbox[0]:bbox[1], bbox[2]:bbox[3]]
        start_pt = np.array([0, 0])

    img, pad_vals = make_square(img)
    img_size = np.max(img.shape[:2])

    pred_joint = ((kp_pred + 1) * 0.5) * proc_img_shape[0]
    pred_joint_orig = (
        pred_joint + start_pt - proc_img_shape[0]
    ) * undo_scale
    kp_orig = 2 * (pred_joint_orig / img_size) - 1

    if bbox is not None:
        use_cam = crop_cam
    else:
        use_cam = crop_to_orig_cam(
            np.asarray(cam), np.asarray(start_pt), undo_scale,
            proc_img_shape[0], img_size,
        )
    return img, pad_vals, kp_orig, use_cam


def visualize_img_orig(
    cam,
    kp_pred,
    vert,
    renderer: VisRenderer,
    start_pt,
    scale,
    proc_img_shape,
    img: np.ndarray = None,
    rotated_view: bool = False,
    mesh_color: str = "blue",
    max_img_size: int = 300,
    no_text: bool = False,
    bbox=None,
    crop_cam=None,
):
    """Render predictions back in original-image space
    (nmr_renderer.py:333-419). img in [-1, 1]."""
    img, pad_vals, kp_orig, use_cam = orig_view(
        cam, kp_pred, start_pt, scale, proc_img_shape, img, max_img_size,
        bbox, crop_cam,
    )
    return visualize_img(
        img=img,
        cam=use_cam,
        kp_pred=kp_orig,
        vert=vert,
        renderer=renderer,
        rotated_view=rotated_view,
        mesh_color=mesh_color,
        pad_vals=pad_vals,
        no_text=no_text,
    )


def compute_video_bbox(cams, kps, proc_infos, margin: int = 10):
    """Video-level person bbox over all frames + per-frame cams adjusted
    to that crop (nmr_renderer.py:519-634, essential math).

    Args:
        cams: (N, 3) crop-space cams.
        kps: (N, K, 2) normalized predicted kps.
        proc_infos: list of dicts with start_pt, scale, im_shape (the
            crop metadata from infer.crop.process_image).

    Returns:
        bbox [y0, y1, x0, x1] in original-image coords, and (N, 3) cams
        expressed for that crop.
    """
    crop_size = proc_infos[0]["im_shape"][0]
    all_pts = []
    for i, info in enumerate(proc_infos):
        undo_scale = 1.0 / np.array(info["scale"])
        pred_joint = ((np.asarray(kps[i]) + 1) * 0.5) * crop_size
        orig = (pred_joint + info["start_pt"] - crop_size) * undo_scale
        all_pts.append(orig)
    all_pts = np.concatenate(all_pts, axis=0)
    x0, y0 = np.floor(all_pts.min(axis=0)).astype(int) - margin
    x1, y1 = np.ceil(all_pts.max(axis=0)).astype(int) + margin
    bbox = np.array([max(y0, 0), y1, max(x0, 0), x1])

    new_size = max(y1 - bbox[0], x1 - bbox[2])
    new_cams = []
    for i, info in enumerate(proc_infos):
        undo_scale = 1.0 / np.array(info["scale"])
        cam_orig_space = crop_to_orig_cam(
            np.asarray(cams[i]),
            np.asarray(info["start_pt"]) - np.array([bbox[2], bbox[0]])
            * np.array(info["scale"]),
            undo_scale,
            crop_size,
            new_size,
        )
        new_cams.append(cam_orig_space)
    return bbox, np.stack(new_cams)
