"""Mosh mocap (pose, shape) -> mocap tfrecords for the adversarial prior.

Counterpart of ``human_dynamics_tpu/datasets/mocap.py`` (the reference's
src/datasets/smpl_to_tfrecords.py):
shuffled (pose 72, shape 10) pairs, 10k per shard, written to
mocap_neutrMosh/neutrSMPL_{dataset}_*.tfrecord; H3.6M test subjects
(S9, S11) excluded (smpl_to_tfrecords.py:237-240). The temporal variant
writes fps-normalized delta-pose windows of length 50
(smpl_to_tfrecords.py:161-186).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Iterator, Tuple

import numpy as np

from human_dynamics_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    encode_example,
)

EXCLUDE_SUBSTRINGS = ("S9", "S11")  # h36m test subjects


def load_mosh_npz(path: str):
    """A mosh npz with 'poses'/(N, 72+) and 'betas'/(10+,)."""
    dd = np.load(path, allow_pickle=True)
    poses = np.asarray(dd["poses"])[:, :72]
    shape = np.asarray(dd["betas"]).reshape(-1)[:10]
    return poses, shape


def iter_pairs(
    mosh_dir: str, dataset: str, exclude_test_subjects: bool = True
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    paths = sorted(
        glob.glob(os.path.join(mosh_dir, dataset, "*.npz"))
        + glob.glob(os.path.join(mosh_dir, f"neutrSMPL_{dataset}",
                                 "*.npz"))
    )
    for path in paths:
        if exclude_test_subjects and any(
            s in os.path.basename(path) for s in EXCLUDE_SUBSTRINGS
        ):
            continue
        poses, shape = load_mosh_npz(path)
        for pose in poses:
            yield pose.astype(np.float32), shape.astype(np.float32)


def write_mocap_records(
    mosh_dir: str,
    out_dir: str,
    dataset: str,
    pairs_per_shard: int = 10_000,
    seed: int = 0,
):
    """Shuffled (pose, shape) shards (smpl_to_tfrecords.py:120-158)."""
    os.makedirs(out_dir, exist_ok=True)
    pairs = list(iter_pairs(mosh_dir, dataset))
    rng = np.random.RandomState(seed)
    rng.shuffle(pairs)

    num_shards = max(1, int(np.ceil(len(pairs) / pairs_per_shard)))
    paths = []
    for shard in range(num_shards):
        path = os.path.join(
            out_dir, f"neutrSMPL_{dataset}_{shard:04d}.tfrecord"
        )
        paths.append(path)
        if os.path.exists(path):
            continue
        with TFRecordWriter(path) as w:
            for pose, shape in pairs[
                shard * pairs_per_shard:(shard + 1) * pairs_per_shard
            ]:
                w.write(encode_example({"pose": pose, "shape": shape}))
    return paths


def write_mocap_temporal_records(
    mosh_dir: str,
    out_dir: str,
    dataset: str,
    window: int = 50,
    target_fps: int = 25,
    source_fps: int = 100,
    seed: int = 0,
):
    """Delta-pose windows (smpl_to_tfrecords.py:161-186): subsample to
    target fps, window length 50, store pose + frame-to-frame deltas."""
    os.makedirs(out_dir, exist_ok=True)
    stride = max(1, source_fps // target_fps)
    windows = []
    paths = sorted(
        glob.glob(os.path.join(mosh_dir, dataset, "*.npz"))
        + glob.glob(os.path.join(mosh_dir, f"neutrSMPL_{dataset}",
                                 "*.npz"))
    )
    for path in paths:
        if any(s in os.path.basename(path) for s in EXCLUDE_SUBSTRINGS):
            continue
        poses, _ = load_mosh_npz(path)
        poses = poses[::stride]
        for s in range(0, len(poses) - window, window):
            windows.append(poses[s:s + window].astype(np.float32))

    rng = np.random.RandomState(seed)
    rng.shuffle(windows)
    path = os.path.join(
        out_dir, f"neutrSMPL_{dataset}_temporal_0000.tfrecord"
    )
    with TFRecordWriter(path) as w:
        for win in windows:
            deltas = win[1:] - win[:-1]
            w.write(encode_example({
                "pose": win.ravel(),
                "delta_pose": deltas.ravel(),
                "T": np.asarray([len(win)], np.int64),
            }))
    return [path]


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mosh_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--datasets", nargs="+",
                        default=["CMU", "H3.6", "jointLim"])
    parser.add_argument("--temporal", action="store_true")
    args = parser.parse_args()

    for ds in args.datasets:
        if args.temporal:
            write_mocap_temporal_records(
                args.mosh_dir,
                os.path.join(args.out_dir, "mocap_neutrMosh_temporal_pose"),
                ds,
            )
        else:
            write_mocap_records(
                args.mosh_dir,
                os.path.join(args.out_dir, "mocap_neutrMosh"),
                ds,
            )


if __name__ == "__main__":
    main()
