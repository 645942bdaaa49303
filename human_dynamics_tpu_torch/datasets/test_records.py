"""Test tfrecord writer (per-person tubes, no augmentation).

Counterpart of ``human_dynamics_tpu/datasets/test_records.py`` (the
reference's save_seq_to_test_tfrecord / add_to_tfrecord / process_image,
src/datasets/make_test_tfrecords.py:22-258): 224 crops at the smoothed
person bbox with crop-undo metadata (center/scale/start_pt) so the renderer
can map predictions back to the original frames. The same cv2, schema and
record writer as the JAX package's give byte-equal records.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from human_dynamics_tpu_torch.data.schema import convert_to_example_temporal
from human_dynamics_tpu_torch.data.tfrecord import TFRecordWriter
from human_dynamics_tpu_torch.datasets.common import crop_person, load_image
from human_dynamics_tpu_torch.infer.bbox import get_smooth_bbox_params


def add_tube_to_writer(
    writer: TFRecordWriter,
    image_paths: List[str],
    gt2ds: np.ndarray,            # (N, K, 3)
    gt3ds: Optional[np.ndarray],  # (N, 14, 3)
    poses: Optional[np.ndarray],  # (N, 72)
    shape: Optional[np.ndarray],  # (10,)
    vis_thresh: float = 0.1,
    img_size: int = 224,
    sigma: float = 8,
    images: Optional[List[np.ndarray]] = None,
) -> None:
    """One person tube -> one serialized test example
    (make_test_tfrecords.py:84-161)."""
    bbox_params, t1, t2 = get_smooth_bbox_params(
        list(gt2ds), vis_thresh, sigma=sigma
    )

    results = {k: [] for k in (
        "image_data", "im_path", "image_shape", "label", "center",
        "scale", "start_pt",
    )}
    for i in range(t1, t2):
        image = (
            images[i] if images is not None else load_image(image_paths[i])
        )
        ret = crop_person(
            image, gt2ds[i], bbox_params[i], crop_size=img_size,
            vis_thresh=vis_thresh,
        )
        results["image_data"].append(ret["image_data"])
        results["im_path"].append(image_paths[i])
        results["image_shape"].append(ret["image_shape"])
        results["label"].append(ret["label"])
        results["center"].append(ret["center"])
        results["scale"].append(ret["scale"])
        results["start_pt"].append(ret["start_pt"])

    if gt3ds is not None:
        gt3ds = gt3ds[t1:t2]
    if poses is not None:
        poses = poses[t1:t2]

    serialized = convert_to_example_temporal(
        cams=[] if gt3ds is None else np.zeros((t2 - t1, 3)),
        centers=np.asarray(results["center"]),
        gt3ds=gt3ds,
        image_datas=results["image_data"],
        image_paths=results["im_path"],
        image_shapes=np.asarray(results["image_shape"]),
        labels=np.asarray(results["label"]),
        scale_factors=np.asarray(results["scale"]),
        start_pts=np.asarray(results["start_pt"]),
        time_pts=np.asarray([t1, t2]),
        poses=poses,
        shape=shape,
    )
    writer.write(serialized)


def save_seq_to_test_tfrecord(
    out_name: str,
    im_paths,
    all_gt2ds,
    all_gt3ds=None,
    all_poses=None,
    all_shapes=None,
    vis_thresh: float = 0.1,
    img_size: int = 224,
    sigma: float = 3,
    separate_tubes: bool = False,
    all_images=None,
) -> None:
    """One sequence -> one tfrecord with P person examples
    (make_test_tfrecords.py:22-81)."""
    p = len(all_gt2ds)
    if all_gt3ds is None:
        all_gt3ds = [None] * p
    if all_poses is None:
        all_poses = [None] * p
    if all_shapes is None:
        all_shapes = [None] * p

    with TFRecordWriter(out_name) as writer:
        for i in range(p):
            paths = im_paths[i] if separate_tubes else im_paths
            add_tube_to_writer(
                writer,
                image_paths=paths,
                gt2ds=np.asarray(all_gt2ds[i]),
                gt3ds=all_gt3ds[i],
                poses=all_poses[i],
                shape=all_shapes[i],
                vis_thresh=vis_thresh,
                img_size=img_size,
                sigma=sigma,
                images=all_images,
            )
