"""Human3.6M -> temporal tfrecords (train, with 3D labels) and test
records.

Counterpart of ``human_dynamics_tpu/datasets/h36m.py`` (the reference's
src/datasets/h36_to_tfrecords_video.py + h36/read_human36m.py). The
raw-ingestion half (NASA CDF pose files + video decode, read_human36m.py,
here datasets/h36m_raw.py) requires spacepy/CDF and the licensed raw
release; this module consumes the intermediate per-sequence arrays
(frames on disk + 2D/3D joints + mosh pose/shape npz) and produces the
canonical records:

- train: subjects S1, S6, S7, S8; val S5; test S9, S11, cam03 only at
  eval (h36_to_tfrecords_video.py:386-440, eval.py:403-408).
- sequences chunked to max 150-frame examples
  (h36_to_tfrecords_video.py:270-291).
- H36M 32-joint layout mapped to LSP-14 (read_human36m.py:49-64) and
  universal-25 2D kps.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Optional

import numpy as np

TRAIN_SUBJECTS = ("S1", "S6", "S7", "S8")
VAL_SUBJECTS = ("S5",)
TEST_SUBJECTS = ("S9", "S11")
MAX_SEQ_LENGTH = 150

# H36M raw 32-joint index -> LSP-14 order (read_human36m.py:49-64):
# [RFoot RKnee RHip LHip LKnee LFoot RWrist RElbow RShoulder LShoulder
#  LElbow LWrist Neck Head]
H36M_TO_LSP14 = [3, 2, 1, 4, 5, 6, 16, 15, 14, 11, 12, 13, 8, 10]

# LSP-14 -> universal-25 slots (the first 14 universal joints share the
# LSP order; face/toes are zero).
def lsp14_to_coco25(kps14: np.ndarray) -> np.ndarray:
    """(N, 14, 3) -> (N, 25, 3) zero-padded."""
    out = np.zeros((len(kps14), 25, 3), kps14.dtype)
    out[:, :14] = kps14
    return out


def subject_of(seq_name: str) -> str:
    return seq_name.split("_")[0]


def load_sequence(seq_dir: str) -> Optional[Dict]:
    """A preprocessed sequence directory:
        frames/*.jpg, gt2d.npy (N, 14, 3), gt3d.npy (N, 14, 3),
        optionally pose.npy (N, 72) + shape.npy (10,) from mosh.
    """
    frames = sorted(
        glob.glob(os.path.join(seq_dir, "frames", "*.jpg"))
        + glob.glob(os.path.join(seq_dir, "frames", "*.png"))
    )
    gt2d_path = os.path.join(seq_dir, "gt2d.npy")
    gt3d_path = os.path.join(seq_dir, "gt3d.npy")
    if not frames or not os.path.exists(gt2d_path):
        return None
    gt2d = np.load(gt2d_path)
    gt3d = np.load(gt3d_path) if os.path.exists(gt3d_path) else None
    pose = (
        np.load(os.path.join(seq_dir, "pose.npy"))
        if os.path.exists(os.path.join(seq_dir, "pose.npy")) else None
    )
    shape = (
        np.load(os.path.join(seq_dir, "shape.npy"))
        if os.path.exists(os.path.join(seq_dir, "shape.npy")) else None
    )
    n = min(len(frames), len(gt2d))
    if gt2d.shape[1] == 14:
        gt2d = lsp14_to_coco25(gt2d)
    return dict(
        frames=frames[:n],
        gt2d=gt2d[:n],
        gt3d=None if gt3d is None else gt3d[:n],
        pose=None if pose is None else pose[:n],
        shape=shape,
    )


def convert(
    data_dir: str,
    out_dir: str,
    split: str,
    feature_extractor=None,
    mosh_ignore: bool = False,
):
    from human_dynamics_tpu_torch.datasets.test_records import (
        save_seq_to_test_tfrecord,
    )
    from human_dynamics_tpu_torch.datasets.tube_writer import TubeConverter

    subjects = {
        "train": TRAIN_SUBJECTS, "val": VAL_SUBJECTS,
        "test": TEST_SUBJECTS,
    }[split]

    seq_dirs = sorted(
        d for d in glob.glob(os.path.join(data_dir, "*"))
        if os.path.isdir(d) and subject_of(os.path.basename(d)).startswith(
            tuple(subjects)
        )
    )

    if split == "test":
        os.makedirs(os.path.join(out_dir, "test"), exist_ok=True)
        for seq_dir in seq_dirs:
            seq = os.path.basename(seq_dir)
            data = load_sequence(seq_dir)
            if data is None:
                continue
            out_name = os.path.join(out_dir, "test", f"{seq}.tfrecord")
            if os.path.exists(out_name):
                continue
            save_seq_to_test_tfrecord(
                out_name,
                im_paths=data["frames"],
                all_gt2ds=[data["gt2d"]],
                all_gt3ds=[data["gt3d"]],
                all_poses=[data["pose"]] if data["pose"] is not None
                else None,
                all_shapes=[data["shape"]] if data["shape"] is not None
                else None,
            )
        return

    # Train/val: chunk to <=150-frame tubes with 3D labels.
    tubes = []
    for seq_dir in seq_dirs:
        data = load_sequence(seq_dir)
        if data is None:
            continue
        n = len(data["frames"])
        for start in range(0, n, MAX_SEQ_LENGTH):
            end = min(start + MAX_SEQ_LENGTH, n)
            if end - start < 20:
                continue
            tubes.append(dict(
                image_paths=data["frames"][start:end],
                gt2ds=data["gt2d"][start:end],
                gt3ds=None if data["gt3d"] is None
                else data["gt3d"][start:end],
                poses=None if (data["pose"] is None or mosh_ignore)
                else data["pose"][start:end],
                shape=None if (data["shape"] is None or mosh_ignore)
                else data["shape"],
            ))
    conv = TubeConverter(
        os.path.join(out_dir, split),
        feature_extractor=feature_extractor,
    )
    return conv.write_tubes(f"h36m_{split}", tubes)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", required=True,
                        help="preprocessed sequence dirs")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--split", default="train",
                        choices=["train", "val", "test"])
    parser.add_argument("--resnet_ckpt", default=None,
                        help="optional: extract phis with this resnet "
                             "(an npz in the JAX package's layout)")
    parser.add_argument("--mosh_ignore", action="store_true")
    parser.add_argument("--device", default=None,
                        help="where the phis run (default: the GPU)")
    args = parser.parse_args()

    fe = None
    if args.resnet_ckpt:
        from human_dynamics_tpu_torch.datasets.phi_extractor import (
            FeatureExtractor,
        )

        fe = FeatureExtractor(args.resnet_ckpt, device=args.device)
    convert(args.data_dir, args.out_dir, args.split, fe,
            args.mosh_ignore)


if __name__ == "__main__":
    main()
