"""The canonical temporal tfrecord schema.

A copy of ``human_dynamics_tpu/data/schema.py`` (the port imports nothing
of the JAX package); it differs only in ``read_test_example``, which
imports cv2 only for records that hold JPEG frames, so that records with
``image/phis`` read where cv2 is not installed.

Write/read parity with the reference's converters so released records and
newly-written ones interoperate:
- convert_to_example_temporal (the reference's src/datasets/common.py:187-311)
- read_from_example (common.py:86-163)
- the training-side parse (data_utils.py:119-337).

Keypoint layout contract (SURVEY.md §2.1): universal 25 kps stored as
14 common ('image/xys' (N,2,14) + 'image/visibilities' (N,14)) +
5 face pts ('image/face_pts' (N,3,5)) + 6 toe pts ('image/toe_pts'
(N,3,6)); labels are passed channel-first (N, 3, K).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from human_dynamics_tpu_torch.data.tfrecord import (
    decode_example,
    encode_example,
)


def convert_to_example_temporal(
    image_datas: Optional[List[bytes]],
    image_paths: List[str],
    image_shapes: np.ndarray,
    labels: np.ndarray,
    centers: np.ndarray,
    gt3ds: Optional[np.ndarray],
    scale_factors: np.ndarray,
    start_pts: np.ndarray,
    cams: Optional[np.ndarray],
    poses: Optional[np.ndarray] = None,
    shape: Optional[np.ndarray] = None,
    phis: Optional[np.ndarray] = None,
    image_datas_og: Optional[List[bytes]] = None,
    time_pts: Optional[np.ndarray] = None,
    image_format: Optional[str] = None,
) -> bytes:
    """Build a serialized temporal Example (common.py:187-311).

    labels: (N, 3, K) with K in {14, 19, 25}.
    image_format: frame encoding of image_datas — "jpg" (default,
    unwritten) or "raw_u8" (pre-decoded uint8 bytes; see
    TemporalExample.image_format).
    Returns serialized bytes (the reference returns a proto object).
    """
    n = len(labels)
    labels = np.array(labels)

    face_pts = None
    toe_pts = None
    if labels.shape[2] == 19:
        face_pts = labels[:, :, -5:]
        labels = labels[:, :, :-5]
    elif labels.shape[2] == 25:
        toe_pts = labels[:, :, -6:]
        face_pts = labels[:, :, -11:-6]
        labels = labels[:, :, :-11]

    if poses is None:
        has_3d = 0
        poses = -np.ones((n, 72))
        shape = -np.ones(10)
    else:
        poses = np.array(poses)
        has_3d = 1
    if gt3ds is None:
        has_3d_joints = 0
        gt3ds = np.zeros((n, 14, 3))
        cams = np.zeros((n, 3))
    else:
        gt3ds = np.array(gt3ds)
        has_3d_joints = 1

    feat: Dict[str, object] = {
        "mosh/shape": np.asarray(shape, np.float32).ravel(),
        "meta/has_3d": np.asarray([has_3d], np.int64),
        "meta/has_3d_joints": np.asarray([has_3d_joints], np.int64),
        "meta/N": np.asarray([n], np.int64),
        "image/filenames": [p.encode() if isinstance(p, str) else p
                            for p in image_paths],
        "image/heightwidths": np.asarray(image_shapes, np.int64).ravel(),
        "image/xys": labels[:, 0:2].astype(np.float32).ravel(),
        "image/visibilities": labels[:, 2].astype(np.int64).ravel(),
        "image/centers": np.asarray(centers, np.int64).ravel(),
        "mosh/gt3ds": np.asarray(gt3ds, np.float32).ravel(),
        "mosh/poses": np.asarray(poses, np.float32).ravel(),
        "image/scale_factors": np.asarray(
            scale_factors, np.float32
        ).ravel(),
        "image/crop_pts": np.asarray(start_pts, np.int64).ravel(),
        "image/cams": np.asarray(cams, np.float32).ravel(),
    }
    if image_datas is not None:
        feat["image/encoded"] = list(image_datas)
        if image_format is not None and image_format != "jpg":
            feat["image/format"] = [image_format.encode()]
    if face_pts is not None:
        feat["image/face_pts"] = face_pts.astype(np.float32).ravel()
    if toe_pts is not None:
        feat["image/toe_pts"] = toe_pts.astype(np.float32).ravel()
    if phis is not None:
        feat["image/phis"] = np.asarray(phis, np.float32).ravel()
    if image_datas_og is not None:
        feat["image/encoded_og"] = list(image_datas_og)
    if time_pts is not None:
        feat["meta/time_pts"] = np.asarray(time_pts, np.int64)
    return encode_example(feat)


@dataclasses.dataclass
class TemporalExample:
    """Decoded temporal example (training-side view).

    kps: (N, K, 3) assembled from xys+vis+face+toe (K = 14/19/25).
    """

    n: int
    kps: np.ndarray                       # (N, K, 3)
    poses: np.ndarray                     # (N, 24, 3)
    shape: np.ndarray                     # (10,)
    gt3ds: np.ndarray                     # (N, 14, 3)
    has_3d: int
    has_3d_joints: int
    centers: np.ndarray                   # (N, 2)
    image_shapes: np.ndarray              # (N, 2)
    scale_factors: np.ndarray
    start_pts: np.ndarray                 # (N, 2)
    cams: np.ndarray                      # (N, 3) or empty
    image_datas: Optional[List[bytes]] = None
    phis: Optional[np.ndarray] = None     # (N, 2048)
    image_paths: Optional[List[bytes]] = None
    time_pts: Optional[np.ndarray] = None
    # Frame encoding of image_datas: b"jpg" (default) or b"raw_u8"
    # (pre-decoded HxWx3 uint8 bytes; datasets/reencode_records.py) —
    # raw trades ~4x storage for zero decode cost on input-bound hosts.
    image_format: bytes = b"jpg"


def _assemble_kps(feats, n: int) -> np.ndarray:
    """xys/vis/face/toe -> (N, K, 3) (common.py:135-144 layout)."""
    xys = np.asarray(feats["image/xys"], np.float32).reshape(n, 2, 14)
    vis = np.asarray(feats["image/visibilities"], np.float32).reshape(
        n, 1, 14
    )
    parts = [np.concatenate([xys, vis], axis=1)]  # (N, 3, 14)
    if "image/face_pts" in feats:
        parts.append(
            np.asarray(feats["image/face_pts"], np.float32).reshape(n, 3, 5)
        )
    if "image/toe_pts" in feats:
        parts.append(
            np.asarray(feats["image/toe_pts"], np.float32).reshape(n, 3, 6)
        )
    kps = np.concatenate(parts, axis=2)  # (N, 3, K)
    return np.transpose(kps, (0, 2, 1))


def parse_temporal_example(serialized: bytes) -> TemporalExample:
    """Serialized Example -> TemporalExample (data_utils.py:119-337)."""
    feats = decode_example(serialized)
    n = int(np.asarray(feats["meta/N"])[0])

    kps = _assemble_kps(feats, n)
    poses = np.asarray(feats["mosh/poses"], np.float32).reshape(n, 24, 3)
    shape = np.asarray(feats["mosh/shape"], np.float32)
    gt3ds = np.asarray(feats["mosh/gt3ds"], np.float32).reshape(n, -1, 3)
    gt3ds = gt3ds[:, :14]

    phis = None
    if "image/phis" in feats:
        phis = np.asarray(feats["image/phis"], np.float32).reshape(n, -1)

    return TemporalExample(
        n=n,
        kps=kps,
        poses=poses,
        shape=shape,
        gt3ds=gt3ds,
        has_3d=int(np.asarray(feats["meta/has_3d"])[0]),
        has_3d_joints=int(np.asarray(feats["meta/has_3d_joints"])[0]),
        centers=np.asarray(feats["image/centers"], np.int64).reshape(n, 2),
        image_shapes=np.asarray(
            feats["image/heightwidths"], np.int64
        ).reshape(n, 2),
        scale_factors=np.asarray(
            feats["image/scale_factors"], np.float32
        ),
        start_pts=np.asarray(feats["image/crop_pts"], np.int64).reshape(
            n, 2
        ),
        cams=np.asarray(feats.get("image/cams", np.zeros(0)), np.float32),
        image_datas=feats.get("image/encoded"),
        phis=phis,
        image_paths=feats.get("image/filenames"),
        time_pts=(
            np.asarray(feats["meta/time_pts"], np.int64)
            if "meta/time_pts" in feats else None
        ),
        image_format=(
            bytes(feats["image/format"][0])
            if "image/format" in feats else b"jpg"
        ),
    )


def read_test_example(serialized: bytes) -> Dict:
    """Test-record reader matching read_from_example (common.py:86-163):
    decodes JPEG images (via cv2) and returns the same dict keys."""
    ex = parse_temporal_example(serialized)
    images = None
    if ex.image_datas is not None:
        import cv2

        images = [
            cv2.cvtColor(
                cv2.imdecode(
                    np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR
                ),
                cv2.COLOR_BGR2RGB,
            )
            for d in ex.image_datas
        ]
    return {
        "N": ex.n,
        "centers": ex.centers,
        "kps": ex.kps,
        "gt3ds": ex.gt3ds,
        "images": images,
        "im_shapes": ex.image_shapes,
        "im_paths": ex.image_paths,
        "poses": ex.poses,
        "scales": ex.scale_factors,
        "shape": ex.shape,
        "start_pts": ex.start_pts,
        "time_pts": ex.time_pts,
        "phis": ex.phis,
    }
