"""Penn Action -> temporal tfrecords.

Counterpart of ``human_dynamics_tpu/datasets/penn_action.py`` (the
reference's read_upenn, src/datasets/upenn/read_upenn.py, and
upenn_to_tfrecords_video.py): .mat labels (x/y/visibility per frame),
13 Penn joints mapped into the universal 25 via name matching (Penn has
no heels/toes/face — zero-padded), train/val/test by the 'train' flag,
50 tubes per shard.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Tuple

import numpy as np

from human_dynamics_tpu_torch.datasets.common import COCO25_JOINT_NAMES

UPENN_JOINT_NAMES = [
    "Head", "R Shoulder", "L Shoulder", "R Elbow", "L Elbow",
    "R Wrist", "L Wrist", "R Hip", "L Hip", "R Knee", "L Knee",
    "R Ankle", "L Ankle",
    # Missing parts (zero-filled): read_upenn.py:83-95.
    "Neck", "Nose", "L Eye", "R Eye", "L Ear", "R Ear", "L Big Toe",
    "R Big Toe", "L Small Toe", "R Small Toe", "L Heel", "R Heel",
]


def get_upenn2coco() -> Tuple[List[int], List[str]]:
    """Index map Penn(25-padded) -> universal 25 (read_upenn.py:36-100)."""
    upenn2coco = [
        UPENN_JOINT_NAMES.index(name) for name in COCO25_JOINT_NAMES
    ]
    return upenn2coco, COCO25_JOINT_NAMES


def read_labels(label_path: str):
    """Penn .mat -> (kps (N, 25, 3) padded, is_train)
    (read_upenn.py:103-124)."""
    from scipy.io import loadmat

    anno = loadmat(label_path)
    vis = anno["visibility"]
    x = anno["x"]
    y = anno["y"]
    kps = np.dstack((x, y, vis)).astype(np.float64)     # (N, 13, 3)
    kps = np.concatenate(
        [kps, np.zeros((kps.shape[0], 12, 3))], axis=1
    )                                                    # (N, 25, 3)
    is_train = int(anno["train"].ravel()[0])
    return kps, is_train


def load_sequences(data_dir: str):
    """Yield (seq_name, frame_paths, coco25_kps, is_train)."""
    upenn2coco, _ = get_upenn2coco()
    label_paths = sorted(glob.glob(os.path.join(data_dir, "labels",
                                                "*.mat")))
    for label_path in label_paths:
        seq_name = os.path.splitext(os.path.basename(label_path))[0]
        frame_dir = os.path.join(data_dir, "frames", seq_name)
        frame_paths = sorted(glob.glob(os.path.join(frame_dir, "*.jpg")))
        if not frame_paths:
            continue
        kps, is_train = read_labels(label_path)
        n = min(len(frame_paths), len(kps))
        yield seq_name, frame_paths[:n], kps[:n][:, upenn2coco], is_train


def convert(data_dir: str, out_dir: str, split: str,
            feature_extractor=None, tubes_per_shard: int = 50):
    from human_dynamics_tpu_torch.datasets.test_records import (
        save_seq_to_test_tfrecord,
    )
    from human_dynamics_tpu_torch.datasets.tube_writer import TubeConverter

    # Penn has no val annotations; the reference splits train-flagged
    # sequences into train and holds the rest as test.
    train_tubes = []
    os.makedirs(os.path.join(out_dir, "test"), exist_ok=True)
    for seq_name, frame_paths, kps, is_train in load_sequences(data_dir):
        if is_train and split == "train":
            train_tubes.append(dict(image_paths=frame_paths, gt2ds=kps))
        elif not is_train and split == "test":
            out_name = os.path.join(
                out_dir, "test", f"{seq_name}.tfrecord"
            )
            if os.path.exists(out_name):
                continue
            save_seq_to_test_tfrecord(
                out_name, frame_paths, [kps], vis_thresh=0.0
            )
    if split == "train" and train_tubes:
        conv = TubeConverter(
            os.path.join(out_dir, "train"),
            feature_extractor=feature_extractor,
            tubes_per_shard=tubes_per_shard,
        )
        conv.write_tubes("penn_action_train", train_tubes)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", required=True,
                        help="Penn_Action root (frames/, labels/)")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--split", default="train",
                        choices=["train", "test"])
    parser.add_argument("--resnet_ckpt", default=None,
                        help="optional: extract phis with this resnet "
                             "(an npz in the JAX package's layout)")
    parser.add_argument("--device", default=None,
                        help="where the phis run (default: the GPU)")
    args = parser.parse_args()

    fe = None
    if args.resnet_ckpt:
        from human_dynamics_tpu_torch.datasets.phi_extractor import (
            FeatureExtractor,
        )

        fe = FeatureExtractor(args.resnet_ckpt, device=args.device)
    convert(args.data_dir, args.out_dir, args.split, fe)


if __name__ == "__main__":
    main()
