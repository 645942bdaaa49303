"""Re-encode temporal tfrecords' frames from JPEG to raw uint8.

Counterpart of ``human_dynamics_tpu/datasets/reencode_records.py``; the
output is byte-equal to it.

One-time preprocessing for decode-bound hosts: image-mode training must
decode B*T jpegs per step on the input host (the JAX package measured its
loader's bound on a 1-core host to be the decode itself,
docs/perf_image_training.md). Re-encoding stores each frame's
pre-decoded HxWx3 uint8 bytes in place of the JPEG, so the loader's
`_finalize` becomes a zero-copy `np.frombuffer` reshape. Cost: ~4-20x
record size (vs JPEG q95 at the 224/300 px crops) — the classic
storage-for-host-CPU trade. The reference instead hides decode behind
4-thread queues (its src/data_loader_sequence.py:145-152);
this is the equivalent lever for hosts without spare decode threads.

Everything except `image/encoded` (+ the `image/format` marker) is
byte-preserved: the proto codec round-trips float/int64/bytes lists
exactly, so labels, phis, mosh gt, and crop metadata are untouched.
Test-record `image/encoded_og` frames (variable-size originals used
only by the eval/demo crop-undo path) are left as JPEG.

Usage:
    python -m human_dynamics_tpu_torch.datasets.reencode_records \
        --src <tf_dir>/insta_variety/train --dst <tf_dir>/insta_raw/train
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np

from human_dynamics_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    decode_example,
    encode_example,
    read_tfrecord,
)
from human_dynamics_tpu_torch.datasets.common import decode_jpeg


def reencode_example(serialized: bytes) -> bytes:
    """One Example: jpeg frames -> raw uint8 frames (+ format marker).

    Examples without `image/encoded` (or already raw) pass through
    unchanged. Asserts each decode matches the recorded heightwidth —
    the loader reconstructs shapes from that field.
    """
    feats = decode_example(serialized)
    datas = feats.get("image/encoded")
    if not datas or feats.get("image/format") == [b"raw_u8"]:
        return serialized
    n = int(np.asarray(feats["meta/N"])[0])
    hw = np.asarray(feats["image/heightwidths"], np.int64).reshape(n, 2)
    raw = []
    for d, (h, w) in zip(datas, hw):
        img = decode_jpeg(bytes(d))
        assert img.shape == (int(h), int(w), 3), (img.shape, h, w)
        raw.append(np.ascontiguousarray(img, np.uint8).tobytes())
    feats["image/encoded"] = raw
    feats["image/format"] = [b"raw_u8"]
    return encode_example(feats)


def reencode_file(src: str, dst: str) -> int:
    """Re-encode one shard; returns the number of examples written."""
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    count = 0
    with TFRecordWriter(dst) as w:
        for serialized in read_tfrecord(src):
            w.write(reencode_example(serialized))
            count += 1
    return count


def reencode_dir(src: str, dst: str,
                 pattern: str = "*.tfrecord") -> int:
    """Mirror every shard of `src` into `dst`; skips shards whose
    output already exists (idempotent crash-resume, like the
    converters). Returns total examples written."""
    files = sorted(glob.glob(os.path.join(src, pattern)))
    if not files:
        raise FileNotFoundError(f"no {pattern} under {src}")
    total = 0
    for path in files:
        out = os.path.join(dst, os.path.basename(path))
        if os.path.exists(out):
            continue
        tmp = out + ".tmp"
        n = reencode_file(path, tmp)
        os.replace(tmp, out)
        total += n
        print(f"{path} -> {out}: {n} examples")
    return total


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="shard dir (or file)")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--pattern", default="*.tfrecord")
    args = ap.parse_args(argv)
    if os.path.isfile(args.src):
        n = reencode_file(args.src, args.dst)
        print(f"{args.src} -> {args.dst}: {n} examples")
    else:
        reencode_dir(args.src, args.dst, args.pattern)


if __name__ == "__main__":
    main()
