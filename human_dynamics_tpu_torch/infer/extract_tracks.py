"""2-D pose tracks for the demo: ffmpeg frame dump + AlphaPose/PoseFlow.

Counterpart of ``human_dynamics_tpu/infer/extract_tracks.py`` (the
reference's extract_tracks.py). The trackers are external projects, not in
this repository: this wrapper runs them as subprocesses when their
checkouts are given, and otherwise raises and asks for the tracked JSON
(``--track_json`` of the demo). Every stage is idempotent, as the
reference's (extract_tracks.py:47-49,64-66,96-98).
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Tuple

from human_dynamics_tpu_torch.viz.video import dump_frames

TRACKED_JSON = "alphapose-results-forvis-tracked.json"


def run_alphapose(
    img_dir: str, out_dir: str, alphapose_dir: Optional[str] = None
) -> str:
    """Per-frame 2D pose detection (extract_tracks.py:63-90)."""
    out_json = os.path.join(out_dir, "alphapose-results.json")
    if os.path.exists(out_json):
        return out_json
    if alphapose_dir is None or not os.path.isdir(alphapose_dir):
        raise FileNotFoundError(
            "AlphaPose repo not found. Either install it and pass "
            "--alphapose_dir, or provide a precomputed tracked json "
            f"({TRACKED_JSON}) to the demo directly."
        )
    cmd = [
        "python3", "demo.py",
        "--indir", os.path.abspath(img_dir),
        "--outdir", os.path.abspath(out_dir),
        "--sp",
        "--format", "cmu",
    ]
    subprocess.run(cmd, cwd=alphapose_dir, check=True)
    return out_json


def run_poseflow(
    img_dir: str, out_dir: str, poseflow_dir: Optional[str] = None
) -> str:
    """Track linking across frames (extract_tracks.py:93-124)."""
    out_json = os.path.join(out_dir, TRACKED_JSON)
    if os.path.exists(out_json):
        return out_json
    if poseflow_dir is None or not os.path.isdir(poseflow_dir):
        raise FileNotFoundError(
            "PoseFlow repo not found; cannot link tracks. Provide "
            f"{TRACKED_JSON} directly."
        )
    alpha_json = os.path.join(out_dir, "alphapose-results.json")
    # PoseFlow writes exactly the path given via --out_json; the demo
    # waits for the tracked name, so pass it directly
    # (extract_tracks.py:95-106).
    cmd = [
        "python3", "tracker-general.py",
        "--imgdir", os.path.abspath(img_dir),
        "--in_json", os.path.abspath(alpha_json),
        "--out_json", os.path.abspath(out_json),
    ]
    subprocess.run(cmd, cwd=poseflow_dir, check=True)
    if not os.path.exists(out_json):
        raise RuntimeError(
            f"PoseFlow ran but did not produce {out_json}."
        )
    return out_json


def compute_tracks(
    vid_path: str,
    out_dir: str,
    alphapose_dir: Optional[str] = None,
    poseflow_dir: Optional[str] = None,
) -> Tuple[str, str]:
    """Video -> (tracked json, frame dir) (extract_tracks.py:127-150)."""
    img_dir = os.path.join(out_dir, "video_frames")
    dump_frames(vid_path, img_dir)

    track_dir = os.path.join(out_dir, "track_output")
    os.makedirs(track_dir, exist_ok=True)
    precomputed = os.path.join(track_dir, TRACKED_JSON)
    if not os.path.exists(precomputed):
        run_alphapose(img_dir, track_dir, alphapose_dir)
        run_poseflow(img_dir, track_dir, poseflow_dir)
    return precomputed, img_dir
