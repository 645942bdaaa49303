"""InstaVariety (OpenPose/detect-and-track 2D tracks) -> train tfrecords.

Counterpart of ``human_dynamics_tpu/datasets/insta_variety.py`` (the
reference's video_in_the_wild_to_tfrecords.py /
insta_variety_to_tfrecords.py): per-frame JSON keypoint tracks ->
tube cleaning (visibility trimming, face-only rejection, 40<=len<=500)
-> smooth bbox -> 300 crops -> tube-consistent augmentation (num_copy
copies) -> phi extraction -> 50 tubes/shard.

Two track layouts are supported (the reference ships one converter per
layout; here one module with --layout):

- 'openpose' (get_seq_labels, video_in_the_wild:445-494): a directory
  of per-video json files, each a list over frames of
  {people: [{pose_keypoints_2d: [x,y,score]*25}]}, or the
  PoseFlow-style dict consumed by infer.tracks.
- 'detect_and_track' (get_seq_labels,
  insta_variety_to_tfrecords.py:444-516): per-video shot_split dirs of
  per-FRAME jsons keyed by joint NAME ({x, y, logits} + "imloc"); vis =
  logits >= 0.1, 'Head' forced invisible; train/test split = first 2000
  codes of a shuffled video-list file.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np

from human_dynamics_tpu_torch.datasets.common import clean_tube


def load_track_json(path: str) -> List[Optional[np.ndarray]]:
    """One track json -> per-frame (25, 3) kps or None."""
    with open(path) as f:
        data = json.load(f)
    frames = []
    if isinstance(data, list):
        for frame in data:
            people = frame.get("people", [])
            if not people:
                frames.append(None)
                continue
            kp = np.array(
                people[0]["pose_keypoints_2d"], np.float64
            ).reshape(-1, 3)
            frames.append(kp[:25])
    else:
        # PoseFlow-style dict: take the longest tracklet.
        from human_dynamics_tpu_torch.infer.tracks import get_labels_poseflow

        tracks = get_labels_poseflow(path, num_frames=len(data))
        frames = tracks[0] if tracks else []
    return frames


# Universal-25 joint names in record order (the detect-and-track jsons
# key keypoints by name; insta_variety_to_tfrecords.py:87-111).
UNIVERSAL_25_NAMES = (
    "R Heel", "R Knee", "R Hip", "L Hip", "L Knee", "L Heel",
    "R Wrist", "R Elbow", "R Shoulder", "L Shoulder", "L Elbow",
    "L Wrist", "Neck", "Head", "Nose", "L Eye", "R Eye", "L Ear",
    "R Ear", "L Big Toe", "R Big Toe", "L Small Toe", "R Small Toe",
    "L Ankle", "R Ankle",
)

# Parts the detect-and-track model does not predict reliably; forced
# invisible (insta_variety_to_tfrecords.py:494-500 zeroes 'Head').
DT_INVISIBLE = frozenset({"Head"})

DT_LOGIT_THRESH = 0.1


def load_dt_frame_json(path: str):
    """One detect-and-track per-FRAME json -> ((25, 3) kps, imloc).

    Layout (get_seq_labels, insta_variety_to_tfrecords.py:444-516):
    {joint_name: {x, y, logits}, ..., "imloc": frame filename}; vis =
    logits >= 0.1, except joints in DT_INVISIBLE which become (0, 0, 0).
    """
    with open(path) as f:
        data = json.load(f)
    kps = np.zeros((25, 3), np.float64)
    for i, name in enumerate(UNIVERSAL_25_NAMES):
        if name in DT_INVISIBLE or name not in data:
            continue
        j = data[name]
        kps[i] = (j["x"], j["y"], float(j["logits"] >= DT_LOGIT_THRESH))
    return kps, data.get("imloc")


def gather_tubes_detect_and_track(
    data_root: str,
    frame_root: str,
    num_copies: int = 1,
    video_codes=None,
):
    """Yield tube dicts from the detect-and-track shot_split layout.

    data_root/{video_code}/shot_split/{seq_num}/*.json — one json per
    frame; each shot sequence is a tube. Frame paths resolve as
    frame_root/{video_code}/{imloc}.
    """
    if video_codes is None:
        video_codes = sorted(
            d for d in os.listdir(data_root)
            if os.path.isdir(os.path.join(data_root, d, "shot_split"))
        )
    for code in video_codes:
        shot_dir = os.path.join(data_root, code, "shot_split")
        if not os.path.isdir(shot_dir):
            continue
        for seq in sorted(os.listdir(shot_dir)):
            seq_dir = os.path.join(shot_dir, seq)
            json_files = sorted(glob.glob(os.path.join(seq_dir, "*.json")))
            if not json_files:
                continue
            kps, frame_paths = [], []
            for jf in json_files:
                kp, imloc = load_dt_frame_json(jf)
                kps.append(kp)
                frame_paths.append(
                    os.path.join(frame_root, code, imloc or "")
                )
            for start, end in clean_tube(kps):
                tube_kps = np.stack(kps[start:end])
                for _ in range(num_copies):
                    yield dict(
                        image_paths=frame_paths[start:end],
                        gt2ds=tube_kps,
                    )


def split_video_codes(list_file: str, split: str, num_train: int = 2000):
    """Train/test split over the shuffled video-code list file: the
    first num_train codes train, the rest test
    (insta_variety_to_tfrecords.py:452-459)."""
    with open(list_file) as f:
        codes = [x.strip() for x in f if x.strip()]
    if split == "train":
        return codes[:num_train]
    if split == "test":
        return codes[num_train:]
    raise ValueError(f"bad split: {split}")


def gather_tubes(
    track_dir: str,
    frame_root: str,
    num_copies: int = 1,
):
    """Yield tube dicts for TubeConverter from a directory of tracks."""
    for track_path in sorted(glob.glob(os.path.join(track_dir, "*.json"))):
        video_name = os.path.splitext(os.path.basename(track_path))[0]
        frame_dir = os.path.join(frame_root, video_name)
        frame_paths = sorted(
            glob.glob(os.path.join(frame_dir, "*.jpg"))
            + glob.glob(os.path.join(frame_dir, "*.png"))
        )
        kps = load_track_json(track_path)
        n = min(len(frame_paths), len(kps))
        if n == 0:
            continue
        for start, end in clean_tube(kps[:n]):
            tube_kps = np.stack(kps[start:end])
            for _ in range(num_copies):
                yield dict(
                    image_paths=frame_paths[start:end],
                    gt2ds=tube_kps,
                )


def convert(
    track_dir: str,
    frame_root: str,
    out_dir: str,
    feature_extractor=None,
    num_copies: int = 1,
    tubes_per_shard: int = 50,
    shuffle_seed: int = 0,
    layout: str = "openpose",
    video_list: str = None,
    split: str = "train",
):
    from human_dynamics_tpu_torch.datasets.tube_writer import TubeConverter

    if layout == "detect_and_track":
        codes = (
            split_video_codes(video_list, split) if video_list else None
        )
        tubes = list(gather_tubes_detect_and_track(
            track_dir, frame_root, num_copies, video_codes=codes
        ))
    elif layout == "openpose":
        tubes = list(gather_tubes(track_dir, frame_root, num_copies))
    else:
        raise ValueError(f"layout {layout!r} not recognized")
    rng = np.random.RandomState(shuffle_seed)
    rng.shuffle(tubes)          # shard shuffling (video_in_the_wild:399)
    conv = TubeConverter(
        os.path.join(out_dir, "train"),
        feature_extractor=feature_extractor,
        tubes_per_shard=tubes_per_shard,
    )
    return conv.write_tubes("insta_variety_train", tubes)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--track_dir", required=True)
    parser.add_argument("--frame_root", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--num_copies", type=int, default=1)
    parser.add_argument("--resnet_ckpt", default=None,
                        help="optional: extract phis with this resnet "
                             "(an npz in the JAX package's layout or a "
                             "TF-slim checkpoint prefix)")
    parser.add_argument("--device", default=None,
                        help="where the phis run (default: the GPU)")
    parser.add_argument(
        "--layout", default="openpose",
        choices=("openpose", "detect_and_track"),
        help="track json layout: per-video OpenPose jsons, or the "
             "detect-and-track shot_split per-frame jsons",
    )
    parser.add_argument("--video_list", default=None,
                        help="shuffled video-code list file "
                             "(detect_and_track split source)")
    parser.add_argument("--split", default="train",
                        choices=("train", "test"))
    args = parser.parse_args()

    fe = None
    if args.resnet_ckpt:
        from human_dynamics_tpu_torch.datasets.phi_extractor import (
            FeatureExtractor,
        )

        fe = FeatureExtractor(args.resnet_ckpt, device=args.device)
    convert(args.track_dir, args.frame_root, args.out_dir, fe,
            args.num_copies, layout=args.layout,
            video_list=args.video_list, split=args.split)


if __name__ == "__main__":
    main()
