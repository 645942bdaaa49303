"""Video IO: frame extraction and mp4 assembly.

Counterpart of ``human_dynamics_tpu/viz/video.py`` (the reference's
extract_tracks.py:42-60 and run_video.py:205-234): ffmpeg with the
reference's flags when it is on PATH, else OpenCV's VideoCapture /
VideoWriter. Writing in-memory frames to PNG needs cv2; it is imported only
where it is used.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np


def _has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def dump_frames(
    vid_path: str, out_dir: str, fmt: str = "frame%010d.png"
) -> List[str]:
    """Extract all frames of a video to pngs (extract_tracks.py:42-60).
    Idempotent: skips when the directory already has frames."""
    os.makedirs(out_dir, exist_ok=True)
    existing = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    if existing:
        return [os.path.join(out_dir, f) for f in existing]

    if _has_ffmpeg():
        subprocess.run(
            ["ffmpeg", "-loglevel", "error", "-nostdin",
             "-i", vid_path, os.path.join(out_dir, fmt)],
            check=True,
        )
    else:
        import cv2

        cap = cv2.VideoCapture(vid_path)
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            i += 1
            cv2.imwrite(os.path.join(out_dir, fmt % i), frame)
        cap.release()
    return [
        os.path.join(out_dir, f)
        for f in sorted(os.listdir(out_dir))
        if f.endswith(".png")
    ]


def make_video(
    output_path: str,
    img_dir: Optional[str] = None,
    frames: Optional[List[np.ndarray]] = None,
    fps: int = 25,
    img_fmt: str = "frame%010d.png",
) -> None:
    """Assemble pngs (or in-memory RGB frames, written to a temporary
    directory that is removed afterwards) into an mp4
    (run_video.py:205-234)."""
    import cv2

    if frames is None:
        _encode(cv2, output_path, img_dir, fps, img_fmt)
        return
    with tempfile.TemporaryDirectory() as tmp:
        for i, frame in enumerate(frames):
            f = frame
            if np.issubdtype(f.dtype, np.floating):
                f = (np.clip(f, 0, 1) * 255).astype(np.uint8)
            cv2.imwrite(
                os.path.join(tmp, img_fmt % (i + 1)),
                cv2.cvtColor(f, cv2.COLOR_RGB2BGR),
            )
        _encode(cv2, output_path, tmp, fps, img_fmt)


def _encode(cv2, output_path, img_dir, fps, img_fmt) -> None:
    """The pngs of ``img_dir`` -> ``output_path`` (ffmpeg, else cv2)."""
    if _has_ffmpeg():
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-nostdin",
             "-framerate", str(fps),
             "-i", os.path.join(img_dir, img_fmt),
             "-vcodec", "libx264", "-pix_fmt", "yuv420p",
             # Even dimensions required by yuv420p.
             "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
             output_path],
            check=True,
        )
        return

    paths = sorted(
        os.path.join(img_dir, f)
        for f in os.listdir(img_dir)
        if f.endswith(".png")
    )
    if not paths:
        raise FileNotFoundError(f"No frames in {img_dir}")
    first = cv2.imread(paths[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for p in paths:
        writer.write(cv2.imread(p))
    writer.release()
