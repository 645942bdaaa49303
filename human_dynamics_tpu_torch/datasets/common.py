"""Shared converter utilities.

Counterpart of ``human_dynamics_tpu/datasets/common.py``: the JPEG coder
(cv2 in place of the reference's TF session, src/datasets/common.py:12-84),
the person-centred crop of the 300 px train records
(video_in_the_wild_to_tfrecords.py:114-189) and the 224 px test records
(make_test_tfrecords.py:164-258), and tube cleaning
(video_in_the_wild_to_tfrecords.py:274-328).

cv2 is imported inside the functions that use it. ``crop_person`` resizes
the uint8 frame with ``cv2.resize`` itself, as the JAX package does through
its ``infer/crop.resize_img``: cv2's fixed-point bilinear arithmetic on
8-bit images gives other pixels, and so other JPEG bytes, than the float64
resize of the port's demo crops (``infer/crop.resize_img``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Universal 25-kp order (SURVEY.md §2.1 fixed contracts; the canonical
# list at video_in_the_wild_to_tfrecords.py:85-111 == read_upenn.py:42-68).
COCO25_JOINT_NAMES = [
    "R Heel", "R Knee", "R Hip", "L Hip", "L Knee", "L Heel",
    "R Wrist", "R Elbow", "R Shoulder", "L Shoulder", "L Elbow",
    "L Wrist", "Neck", "Head", "Nose", "L Eye", "R Eye", "L Ear",
    "R Ear", "L Big Toe", "R Big Toe", "L Small Toe", "R Small Toe",
    "L Ankle", "R Ankle",
]
FACE_INDICES = list(range(14, 19))


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """RGB uint8/float [0,255] -> JPEG bytes."""
    import cv2

    img = np.asarray(image)
    if np.issubdtype(img.dtype, np.floating):
        img = np.clip(img, 0, 255).astype(np.uint8)
    ok, buf = cv2.imencode(
        ".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
        [cv2.IMWRITE_JPEG_QUALITY, quality],
    )
    assert ok
    return buf.tobytes()


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8."""
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def load_image(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def resize_img(img: np.ndarray,
               scale_factor: float) -> Tuple[np.ndarray, list]:
    """cv2.resize (INTER_LINEAR) of an (H, W, C) frame by ``scale_factor``,
    in the frame's own dtype, and the actual [fy, fx] factors of the
    floored size (the reference's src/util/common.py:7-14)."""
    import cv2

    new_size = (np.floor(np.array(img.shape[0:2]) * scale_factor)).astype(int)
    new_img = cv2.resize(img, (new_size[1], new_size[0]))
    actual_factor = [
        new_size[0] / float(img.shape[0]),
        new_size[1] / float(img.shape[1]),
    ]
    return new_img, actual_factor


def crop_person(
    image: np.ndarray,
    gt2d: np.ndarray,
    bbox_param: np.ndarray,
    crop_size: int,
    vis_thresh: float = 0.0,
    encode: bool = True,
) -> Dict:
    """Person-centered crop used by every converter.

    Scale by bbox scale (person height -> 150 px), edge-pad by
    crop_size, crop crop_size x crop_size around the scaled center, and
    transform the keypoints along. crop_size = 300 for train records
    (2x of 150 leaves augmentation slack), 224 for test records.

    Returns dict(image, image_data, image_shape, label (3, K), center,
    scale_factors, start_pt) per video_in_the_wild:114-189 /
    make_test_tfrecords:164-258. With ``encode=False`` the crop is not
    JPEG-encoded and ``image_data`` is None (for callers that do not keep
    it).
    """
    center = bbox_param[:2]
    scale = bbox_param[2]

    image_scaled, scale_factors = resize_img(image, scale)
    vis = gt2d[:, 2] > vis_thresh
    joints_scaled = np.copy(gt2d[:, :2])
    joints_scaled[:, 0] *= scale_factors[1]
    joints_scaled[:, 1] *= scale_factors[0]
    center_scaled = np.round(center * np.asarray(scale_factors)[::-1])
    center_scaled = center_scaled.astype(int)
    # (The reference multiplies [cx, cy] by [fy, fx]
    # (video_in_the_wild:132) — identical for isotropic resize; we pair
    # the axes correctly.)

    # The crop of the frame edge-padded by crop_size on each side: the
    # padded frame's rows and columns, sliced as the JAX package slices
    # them, index the scaled frame clamped to its edges (np.pad's "edge"
    # mode), so only the crop is copied, not the padded frame.
    h_scaled, w_scaled = image_scaled.shape[:2]
    height, width = h_scaled + 2 * crop_size, w_scaled + 2 * crop_size
    center_scaled = center_scaled + crop_size
    joints_scaled = joints_scaled + crop_size

    margin = crop_size // 2
    start_pt = (center_scaled - margin).astype(int)
    end_pt = (center_scaled + margin).astype(int)
    end_pt[0] = min(end_pt[0], width)
    end_pt[1] = min(end_pt[1], height)
    rows = np.arange(height)[start_pt[1]:end_pt[1]] - crop_size
    cols = np.arange(width)[start_pt[0]:end_pt[0]] - crop_size
    crop = image_scaled.take(np.clip(rows, 0, h_scaled - 1), axis=0).take(
        np.clip(cols, 0, w_scaled - 1), axis=1)
    joints_scaled[:, 0] -= start_pt[0]
    joints_scaled[:, 1] -= start_pt[1]
    center_scaled = center_scaled - start_pt

    label = np.vstack([joints_scaled.T, vis[None].astype(np.float64)])
    return {
        "image": crop,
        "image_data": encode_jpeg(crop) if encode else None,
        "image_shape": list(crop.shape[:2]),
        "label": label,                        # (3, K)
        "center": center_scaled,
        "scale_factors": scale_factors,
        "scale": scale,
        "start_pt": start_pt,
    }


def clean_tube(
    kps: List[Optional[np.ndarray]],
    vis_thresh: float = 0.0,
    min_vis_count: int = 6,
    min_length: int = 40,
    max_length: int = 500,
) -> List[Tuple[int, int]]:
    """Trim/split a keypoint track into usable tube segments.

    Mirrors clean_video (video_in_the_wild_to_tfrecords.py:274-328):
    drops frames with too few visible kps or face-only detections, and
    keeps contiguous runs with min_length <= len <= max_length (longer
    runs are chunked).
    """
    def frame_ok(kp):
        if kp is None:
            return False
        vis = kp[:, 2] > vis_thresh
        if vis.sum() < min_vis_count:
            return False
        body = np.ones(len(kp), bool)
        body[FACE_INDICES] = False
        if not np.any(vis & body):
            return False        # face-only detection
        return True

    ok = [frame_ok(kp) for kp in kps]
    segments = []
    start = None
    for i, good in enumerate(ok + [False]):
        if good and start is None:
            start = i
        elif not good and start is not None:
            segments.append((start, i))
            start = None

    out = []
    for s, e in segments:
        while e - s > max_length:
            out.append((s, s + max_length))
            s += max_length
        if e - s >= min_length:
            out.append((s, e))
    return out
