"""Train tfrecord writer: tubes -> 300px crops -> (optional) augmentation
and phi extraction on the device -> sharded records.

Counterpart of ``human_dynamics_tpu/datasets/tube_writer.py`` (the
reference's add_to_tfrecord / process_videos,
src/datasets/video_in_the_wild_to_tfrecords.py:192-415): smooth bbox per
tube, 300x300 crops on the host (2x the 150px person height leaves slack
for the 224 training crops), tube-consistent augmentation, phi
pre-extraction, 50 tubes per shard, idempotent shard skip.

The tube's uint8 crops go to the device once; the batched
``data/augment.augment_tube`` (a tube axis of 1) cuts the 224 crops there,
and they stay there for the phis. Only the labels, the phis and, with
``save_img``, the uint8 JPEG sources come back. A tube's augmentation is
drawn from a CPU ``torch.Generator`` seeded with ``seed + rng_key`` and
then moved to the device, so the card and the CPU write the same draws
(they differ from the JAX package's, which come from its PRNG).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from human_dynamics_tpu_torch.data import augment as data_augment
from human_dynamics_tpu_torch.data.schema import convert_to_example_temporal
from human_dynamics_tpu_torch.data.tfrecord import TFRecordWriter
from human_dynamics_tpu_torch.datasets.common import (
    crop_person,
    encode_jpeg,
    load_image,
)
from human_dynamics_tpu_torch.infer.bbox import get_smooth_bbox_params

CROP = 300
OUT = 224


class TubeConverter:
    """Writes training tubes into sharded tfrecords."""

    def __init__(
        self,
        out_dir: str,
        feature_extractor=None,
        augment: bool = True,
        trans_max: int = 20,
        delta_trans_max: int = 3,
        scale_max: float = 0.3,
        delta_scale_max: float = 0.05,
        tubes_per_shard: int = 50,
        save_img: bool = False,
        seed: int = 0,
    ):
        """With a ``feature_extractor`` the augmentation runs on its
        ``device``."""
        self.out_dir = out_dir
        self.feature_extractor = feature_extractor
        self.augment = augment and feature_extractor is not None
        self.aug_params = dict(
            trans_max=trans_max, delta_trans_max=delta_trans_max,
            scale_max=scale_max, delta_scale_max=delta_scale_max,
        )
        self.tubes_per_shard = tubes_per_shard
        self.save_img = save_img
        self.seed = seed
        # Threads that read and crop a tube's frames; the records do not
        # depend on their number.
        self.workers = min(8, os.cpu_count() or 1)
        os.makedirs(out_dir, exist_ok=True)

    def shard_path(self, prefix: str, shard_id: int, num_shards: int):
        return os.path.join(
            self.out_dir,
            f"{prefix}_{shard_id:03d}_of_{num_shards:03d}.tfrecord",
        )

    def process_tube(
        self,
        image_paths: List[str],
        gt2ds: np.ndarray,          # (N, 25, 3)
        poses: Optional[np.ndarray] = None,
        shape: Optional[np.ndarray] = None,
        gt3ds: Optional[np.ndarray] = None,
        vis_thresh: float = 0.0,
        sigma: float = 3,
        images: Optional[List[np.ndarray]] = None,
        rng_key: int = 0,
    ) -> Optional[bytes]:
        """One tube -> serialized temporal example (or None if empty)."""
        bbox_params, t1, t2 = get_smooth_bbox_params(
            list(gt2ds), vis_thresh, sigma=sigma
        )
        if t2 <= t1:
            return None

        fe = self.feature_extractor
        keep_crops = fe is None and self.save_img

        def crop(i):
            image = (
                images[i] if images is not None
                else load_image(image_paths[i])
            )
            return crop_person(
                image, gt2ds[i], bbox_params[i], crop_size=CROP,
                vis_thresh=vis_thresh, encode=keep_crops,
            )

        # cv2's decode and resize release the GIL: the frames are read and
        # cropped in parallel, in order.
        with ThreadPoolExecutor(self.workers) as pool:
            rets = list(pool.map(crop, range(t1, t2)))
        image_datas, image_shapes, labels = [], [], []
        centers, scale_factors, start_pts = [], [], []
        crops = []
        for ret in rets:
            image_datas.append(ret["image_data"])
            image_shapes.append(ret["image_shape"])
            labels.append(ret["label"])
            centers.append(ret["center"])
            scale_factors.append(ret["scale_factors"])
            start_pts.append(ret["start_pt"])
            if fe is not None:
                crops.append(ret["image"])

        phis = None
        if fe is not None:
            crops224, labels = self._augment_tube(
                crops, labels, centers, rng_key
            )
            image_shapes = [[OUT, OUT]] * len(crops224)
            centers = [np.array([OUT // 2, OUT // 2])] * len(crops224)
            phis = fe.compute_all_phis(crops224)
            image_datas = (
                [encode_jpeg(im) for im in _jpeg_sources(crops224)]
                if self.save_img else None
            )
        elif not keep_crops:
            image_datas = None

        return convert_to_example_temporal(
            image_datas=image_datas,
            image_paths=image_paths[t1:t2],
            image_shapes=np.asarray(image_shapes),
            labels=np.asarray(labels),
            centers=np.asarray(centers),
            gt3ds=None if gt3ds is None else gt3ds[t1:t2],
            scale_factors=np.asarray(scale_factors),
            start_pts=np.asarray(start_pts),
            cams=None if gt3ds is None else np.zeros((t2 - t1, 3)),
            poses=None if poses is None else poses[t1:t2],
            shape=shape,
            phis=phis,
            time_pts=np.asarray([t1, t2]),
        )

    def _augment_tube(self, crops, labels, centers, rng_key):
        """Tube-consistent 300->224 augmentation on the extractor's device:
        (T, 224, 224, 3) crops in [-1, 1] left there, and the labels
        normalised to [-1, 1] and zeroed where invisible (the
        precomputed-phi training contract), as a list of (3, K) arrays."""
        dev = self.feature_extractor.device
        t = len(crops)
        # Pad ragged 300-crops (edge crops can be smaller) to 300x300. The
        # uint8 crops go up as they are: augment_tube reads value / 255 in
        # float32, which is the float32 of the JAX package's float64
        # crop / 255 for every uint8 value.
        imgs = np.zeros((1, t, CROP, CROP, 3), np.uint8)
        for i, c in enumerate(crops):
            imgs[0, i, :c.shape[0], :c.shape[1]] = c
        params = data_augment.sample_tube_params(
            torch.Generator().manual_seed(self.seed + rng_key), 1, t,
            **self.aug_params,
        )
        crops224, out_labels, _, _ = data_augment.augment_tube(
            torch.from_numpy(imgs).to(dev),
            torch.as_tensor(np.stack(labels)[None], dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.stack(centers)[None], dtype=torch.float32,
                            device=dev),
            torch.zeros((1, t, 72), device=dev),
            torch.zeros((1, t, 14, 3), device=dev),
            data_augment.TubeAugmentParams(*(p.to(dev) for p in params)),
            output_size=OUT,
        )
        return crops224[0], list(out_labels[0].cpu().numpy())

    def write_tubes(self, prefix: str, tubes: List[dict]) -> List[str]:
        """tubes: list of kwargs for process_tube. Returns shard paths.
        Idempotent: existing shards are skipped
        (video_in_the_wild:348-350)."""
        num_shards = max(
            1, int(np.ceil(len(tubes) / self.tubes_per_shard))
        )
        paths = []
        for shard_id in range(num_shards):
            path = self.shard_path(prefix, shard_id, num_shards)
            paths.append(path)
            if os.path.exists(path):
                continue
            chunk = tubes[
                shard_id * self.tubes_per_shard:
                (shard_id + 1) * self.tubes_per_shard
            ]
            tmp = path + ".tmp"
            with TFRecordWriter(tmp) as writer:
                for i, tube_kwargs in enumerate(chunk):
                    serialized = self.process_tube(
                        rng_key=shard_id * self.tubes_per_shard + i,
                        **tube_kwargs,
                    )
                    if serialized is not None:
                        writer.write(serialized)
            os.replace(tmp, path)
        return paths


def _jpeg_sources(crops224: torch.Tensor) -> np.ndarray:
    """[-1, 1] crops -> the uint8 frames the JAX package's
    ``encode_jpeg(((im + 1) * 0.5) * 255.0)`` encodes: the same float32
    operations, clipped and truncated on the device."""
    u8 = (((crops224 + 1) * 0.5) * 255.0).clamp(0, 255).to(torch.uint8)
    return u8.cpu().numpy()
