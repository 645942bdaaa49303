"""PoseFlow track JSON -> per-tracklet keypoint lists.

A numpy copy of ``human_dynamics_tpu/infer/tracks.py`` (the reference's
get_labels_poseflow, demo_video.py:61-121), kept in the port because
importing the JAX package's ``infer`` subpackage imports JAX. The JSON is
what AlphaPose + PoseFlow write:

    { "<frame_name>": [ {"keypoints": [x,y,score]*K, "idx": track_id},
                        ... ], ... }
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def get_labels_poseflow(
    json_path: str, num_frames: int, min_kp_count: int = 20
) -> List[List[Optional[np.ndarray]]]:
    """Load tracklets; returns per-person lists of per-frame (K,3) or None.

    Tracklets shorter than min_kp_count frames are dropped; the result is
    sorted longest-first (demo_video.py:108-121).
    """
    with open(json_path, "r") as f:
        data = json.load(f)
    if len(data.keys()) != num_frames:
        frame_ids = sorted(data.keys())
        if frame_ids and _frame_number(frame_ids[0]) != 0:
            raise ValueError(
                "PoseFlow did not find people in the first frame "
                f"({frame_ids[0]}); unsupported (demo_video.py:83-86)."
            )

    all_kps_dict = {}
    all_kps_count = {}
    for i, key in enumerate(sorted(data.keys())):
        track_ids = []
        for person in data[key]:
            kps = np.array(person["keypoints"]).reshape(-1, 3)
            idx = int(person["idx"])
            if idx not in all_kps_dict:
                all_kps_dict[idx] = [None] * i
                all_kps_count[idx] = 0
            all_kps_dict[idx].append(kps)
            track_ids.append(idx)
            all_kps_count[idx] += 1
        for idx in set(all_kps_dict.keys()).difference(track_ids):
            all_kps_dict[idx].append(None)

    all_kps_list = []
    all_counts_list = []
    for k in all_kps_dict:
        if all_kps_count[k] >= min_kp_count:
            all_kps_list.append(all_kps_dict[k])
            all_counts_list.append(all_kps_count[k])

    sort_idx = np.argsort(all_counts_list)[::-1]
    return [all_kps_list[i] for i in sort_idx]


def _frame_number(name: str) -> int:
    import re

    nums = re.findall(r"\d+", name)
    return int(nums[0]) if nums else -1
