"""Record inspection: overlay skeletons on decoded frames -> PNG grids.

Counterpart of ``human_dynamics_tpu/datasets/visualize_records.py`` (the
reference's src/datasets/visualize_tfrecords.py /
visualize_train_tfrecords.py) — the reference drops into ipdb +
matplotlib for human inspection (prepare_datasets.sh:7-8); here frames
are written to disk (CI-friendly) and basic invariants are checked.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from human_dynamics_tpu_torch.data.schema import (
    parse_temporal_example,
    read_test_example,
)
from human_dynamics_tpu_torch.data.tfrecord import read_tfrecord
from human_dynamics_tpu_torch.viz.skeleton import draw_skeleton


def visualize_record(
    record_path: str,
    out_dir: str,
    max_examples: int = 2,
    max_frames: int = 8,
    is_test: bool = True,
) -> list:
    """Dump skeleton-overlay frames for the first examples of a record."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for ei, serialized in enumerate(read_tfrecord(record_path)):
        if ei >= max_examples:
            break
        if is_test:
            data = read_test_example(serialized)
            images = data["images"]
            kps = data["kps"]
        else:
            ex = parse_temporal_example(serialized)
            images = (
                None if ex.image_datas is None
                else [
                    cv2.cvtColor(
                        cv2.imdecode(np.frombuffer(d, np.uint8),
                                     cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB,
                    )
                    for d in ex.image_datas
                ]
            )
            kps = ex.kps
        if images is None:
            print(f"{record_path} example {ei}: no images "
                  f"(phi-only record, {kps.shape[0]} frames)")
            continue
        step = max(1, len(images) // max_frames)
        for fi in range(0, len(images), step):
            img = images[fi]
            kp = kps[fi]
            overlay = draw_skeleton(
                img, kp[:, :2], vis=kp[:, 2] > 0
            )
            name = os.path.join(
                out_dir,
                f"{os.path.basename(record_path)}_e{ei}_f{fi}.png",
            )
            cv2.imwrite(name, cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
            written.append(name)
    return written


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--record", required=True)
    parser.add_argument("--out_dir", default="record_viz")
    parser.add_argument("--train", action="store_true",
                        help="parse as train (phi) record")
    args = parser.parse_args()
    files = visualize_record(
        args.record, args.out_dir, is_test=not args.train
    )
    print(f"Wrote {len(files)} overlays to {args.out_dir}")


if __name__ == "__main__":
    main()
