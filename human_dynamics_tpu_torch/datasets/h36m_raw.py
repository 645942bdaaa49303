"""Human3.6M raw ingestion: metadata.xml cameras + pose CDFs + videos
-> the per-sequence intermediate consumed by datasets/h36m.py.

Counterpart of ``human_dynamics_tpu/datasets/h36m_raw.py`` (the
reference's src/datasets/h36/read_human36m.py, :131-260
camera/pose/frames). Differences by design:

- All projection/camera math is vectorized numpy over whole sequences
  (the reference loops per frame / per point).
- CDF reading works through any of: ``spacepy.pycdf``, ``cdflib``, or
  ``.npy``/``.npz`` stand-ins with the same array layout — the NASA CDF
  C library is optional instead of required.
- Output is written directly in the layout ``datasets/h36m.py`` reads
  (``{seq}/frames/*.png``, ``gt2d.npy`` (N, 14, 3) with a visibility
  column, ``gt3d.npy`` (N, 14, 3) meters, ``camera.npz``), so raw ->
  tfrecords is two documented commands instead of an undocumented
  intermediate.

Raw layout expected (the official release unpacked):
    {raw}/metadata.xml
    {raw}/S{i}/Videos/{Action Trial.Camera}.mp4
    {raw}/S{i}/MyPoseFeatures/D2_Positions/{Action Trial.Camera}.cdf
    {raw}/S{i}/MyPoseFeatures/D3_Positions_mono/{...}.cdf
"""

from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

# Raw 32-joint -> the 17 informative joints (read_human36m.py:46), then
# -> LSP-14 (read_human36m.py:49-64 == datasets/h36m.H36M_TO_LSP14).
JOINT_SUBSET_17 = (0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19,
                   25, 26, 27)
SUBSET17_TO_LSP14 = (3, 2, 1, 4, 5, 6, 16, 15, 14, 11, 12, 13, 8, 10)

ACTION_NAMES = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking",
    "TakingPhoto", "Waiting", "Walking", "WakingDog", "WalkTogether",
)

N_SUBJECTS = 11
N_CAMERAS = 4


# ---------------------------------------------------------------------------
# Camera model
# ---------------------------------------------------------------------------

def euler_xyz_to_rotation(angles: Sequence[float]) -> np.ndarray:
    """R = Rx @ Ry @ Rz for extrinsic euler angles (x, y, z), the
    composition H3.6M's metadata uses (read_human36m.py:96-107)."""
    x, y, z = (float(a) for a in angles)
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def project_points(
    points: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    focal: np.ndarray,
    principal: np.ndarray,
    k_radial: np.ndarray,
    p_tangential: np.ndarray,
) -> np.ndarray:
    """Full H3.6M camera: rigid transform + radial (k1..k3) + tangential
    (p1, p2) distortion + pinhole intrinsics.

    points: (..., 3) world-frame mm. Returns (..., 2) pixel coords.
    Vectorized over any leading shape (project_point_radial,
    read_human36m.py:110-129, loops a single frame).
    """
    pts = np.asarray(points, np.float64)
    cam = (pts - np.asarray(translation).reshape(3)) @ np.asarray(
        rotation
    ).T
    xy = cam[..., :2] / cam[..., 2:3]

    r2 = np.sum(xy**2, axis=-1)
    radial = 1.0 + (
        k_radial[0] * r2 + k_radial[1] * r2**2 + k_radial[2] * r2**3
    )
    # The reference applies a scalar (radial + tan) to both coords plus
    # a p-swapped additive term (read_human36m.py:121-127); keep that
    # exact form.
    tan = p_tangential[0] * xy[..., 1] + p_tangential[1] * xy[..., 0]
    distorted = (
        xy * (radial + tan)[..., None]
        + np.stack([p_tangential[1] * r2, p_tangential[0] * r2], axis=-1)
    )
    return distorted * np.asarray(focal) + np.asarray(principal)


def read_cameras_metadata(xml_path: str) -> np.ndarray:
    """All camera parameter tokens from metadata.xml's ``w0`` blob.

    Returns the raw float vector; use :func:`camera_parameters` to slice
    one (subject, camera) pair out. Layout (read_human36m.py:131-168):
    first ``4 cams * 11 subjects * 6`` extrinsics (3 euler + 3 trans),
    then ``4 cams * 9`` intrinsics (2 f, 2 c, 5 distortion).
    """
    root = ET.parse(xml_path).getroot()
    w0 = root.find("w0")
    if w0 is None:
        raise ValueError(f"{xml_path} has no <w0> camera block")
    return np.array(
        w0.text.strip().lstrip("[").rstrip("]").split(), dtype=np.float64
    )


def camera_parameters(
    tokens: np.ndarray, subject: int, camera: int
) -> Dict[str, np.ndarray]:
    """Slice one camera out of the metadata token vector.

    subject/camera are 1-based like the official release. Returns
    {rotation (3,3), translation (3,), focal (2,), principal (2,),
    k_radial (3,), p_tangential (2,)}.
    """
    s, c = subject - 1, camera - 1
    ext = tokens[(c * N_SUBJECTS + s) * 6:][:6]
    intr = tokens[N_CAMERAS * N_SUBJECTS * 6 + c * 9:][:9]
    # metadata distortion order is [k1, k2, k3, p1, p2]
    # (read_human36m.py:164-166 repacks it; we keep named fields).
    return dict(
        rotation=euler_xyz_to_rotation(ext[:3]),
        translation=ext[3:6],
        focal=intr[:2],
        principal=intr[2:4],
        k_radial=np.array([intr[4], intr[5], intr[6]]),
        p_tangential=np.array([intr[7], intr[8]]),
    )


# ---------------------------------------------------------------------------
# Pose files (CDF with optional backends, or npy stand-ins)
# ---------------------------------------------------------------------------

def read_pose_file(path: str, dim: int) -> np.ndarray:
    """Pose trajectories (N, 32, dim) from a CDF file or an npy/npz
    stand-in holding the same ``Pose`` array ([1, N, 32*dim])."""
    if path.endswith((".npy", ".npz")):
        data = np.load(path)
        arr = data["Pose"] if hasattr(data, "keys") else data
    else:
        arr = _read_cdf_pose(path)
    arr = np.asarray(arr)
    if arr.ndim == 3:  # [1, N, D] CDF layout
        arr = arr[0]
    return arr.reshape(len(arr), -1, dim)


def _read_cdf_pose(path: str) -> np.ndarray:
    try:
        from spacepy import pycdf  # type: ignore

        with pycdf.CDF(path) as data:
            return np.array(data["Pose"][...])
    except ImportError:
        pass
    try:
        import cdflib  # type: ignore

        return cdflib.CDF(path).varget("Pose")
    except ImportError as exc:
        raise ImportError(
            "Reading H3.6M .cdf pose files needs spacepy or cdflib "
            "(neither installed). Convert them once elsewhere with "
            "np.save(path + '.npy', cdf['Pose'][...]) and point this "
            "tool at the .npy stand-ins."
        ) from exc


def poses_to_lsp14(poses: np.ndarray) -> np.ndarray:
    """(N, 32, d) raw joints -> (N, 14, d) LSP order."""
    subset = poses[:, JOINT_SUBSET_17]
    return subset[:, SUBSET17_TO_LSP14]


# ---------------------------------------------------------------------------
# Sequence extraction
# ---------------------------------------------------------------------------

def _video_frames(path: str, limit: Optional[int] = None):
    import cv2

    cap = cv2.VideoCapture(path)
    count = 0
    while limit is None or count < limit:
        ok, frame = cap.read()
        if not ok:
            break
        yield frame
        count += 1
    cap.release()


def extract_sequence(
    video_path: str,
    pose2d_path: str,
    pose3d_path: str,
    camera: Dict[str, np.ndarray],
    out_dir: str,
    frame_skip: int = 2,
) -> Optional[str]:
    """One (subject, action, trial, camera) sequence -> the h36m.py
    intermediate: frames/*.png + gt2d.npy + gt3d.npy + camera.npz.

    frame_skip=2 subsamples 50fps -> 25fps (read_human36m.py flag).
    Idempotent: returns early when the frame count already matches.
    """
    import cv2

    gt2d_all = poses_to_lsp14(read_pose_file(pose2d_path, dim=2))
    gt3d_all = poses_to_lsp14(read_pose_file(pose3d_path, dim=3))
    n = min(len(gt2d_all), len(gt3d_all))
    keep = np.arange(0, n, frame_skip)

    frames_dir = os.path.join(out_dir, "frames")
    os.makedirs(frames_dir, exist_ok=True)

    # Labels: 2D with visibility column; 3D mm -> meters
    # (h36_to_tfrecords_video.py:302-313).
    gt2d = np.concatenate(
        [gt2d_all[keep], np.ones((len(keep), 14, 1))], axis=2
    )
    gt3d = gt3d_all[keep] / 1000.0
    np.save(os.path.join(out_dir, "gt2d.npy"), gt2d.astype(np.float32))
    np.save(os.path.join(out_dir, "gt3d.npy"), gt3d.astype(np.float32))
    np.savez(os.path.join(out_dir, "camera.npz"), **camera)

    existing = len(glob.glob(os.path.join(frames_dir, "*.png")))
    if existing >= len(keep):
        return out_dir

    keep_set = set(keep.tolist())
    written = 0
    for i, frame in enumerate(_video_frames(video_path, limit=n)):
        if i not in keep_set:
            continue
        cv2.imwrite(
            os.path.join(frames_dir, f"frame{written:04d}.png"), frame
        )
        written += 1
    if written == 0:
        return None
    return out_dir


def sequence_files(
    raw_dir: str, subject: int, seq_name: str
) -> Dict[str, List[str]]:
    """Per-camera sorted video/pose paths of one captured sequence."""
    base = os.path.join(raw_dir, f"S{subject}")

    def find(sub, ext):
        return sorted(
            glob.glob(os.path.join(base, sub, f"{seq_name}.*{ext}"))
        )

    return dict(
        videos=find("Videos", "mp4"),
        pose2d=(find("MyPoseFeatures/D2_Positions", "cdf")
                or find("MyPoseFeatures/D2_Positions", "npy")),
        pose3d=(find("MyPoseFeatures/D3_Positions_mono", "cdf")
                or find("MyPoseFeatures/D3_Positions_mono", "npy")),
    )


def action_name_map(xml_path: str) -> Dict[tuple, str]:
    """(subject, action_id, trial_id) -> capture name, from the
    metadata ``mapping`` table (read_action_name, read_human36m.py:
    170-181; this parses the table once instead of per query)."""
    root = ET.parse(xml_path).getroot()
    mapping = root.find("mapping")
    out: Dict[tuple, str] = {}
    if mapping is None:
        return out
    for tr in list(mapping):
        cells = [td.text for td in list(tr)]
        if len(cells) < 3 or not cells[0] or not cells[0].isdigit():
            continue
        action_id = int(cells[0]) - 1  # table rows are 1-based + header
        trial_id = int(cells[1])
        for s in range(1, N_SUBJECTS + 1):
            if len(cells) > 1 + s and cells[1 + s]:
                out[(s, action_id, trial_id)] = cells[1 + s]
    return out


def convert_raw(
    raw_dir: str,
    out_dir: str,
    subjects: Sequence[int] = (1, 5, 6, 7, 8, 9, 11),
    frame_skip: int = 2,
    cameras: Sequence[int] = (1, 2, 3, 4),
) -> List[str]:
    """Full raw pass: every (subject, action, trial, camera) ->
    ``{out}/S{s}_{Action}_{trial}_cam{c}/`` intermediates
    (read_human36m.main, :308-447). Returns the written sequence dirs.
    """
    xml_path = os.path.join(raw_dir, "metadata.xml")
    tokens = read_cameras_metadata(xml_path)
    names = action_name_map(xml_path)

    written = []
    for subject in subjects:
        for action_id in range(1, 16):
            for trial_id in (1, 2):
                seq_name = names.get((subject, action_id, trial_id))
                if seq_name is None:
                    continue
                # Corrupt capture skipped by the reference (:353-355).
                if subject == 11 and "Phoning 2" in seq_name:
                    continue
                files = sequence_files(raw_dir, subject, seq_name)
                for cam in cameras:
                    if (len(files["videos"]) < cam
                            or len(files["pose2d"]) < cam
                            or len(files["pose3d"]) < cam):
                        continue
                    action = ACTION_NAMES[action_id - 1]
                    # cam index zero-padded so test record names carry
                    # the 'cam03' tag the eval harness filters h36m by
                    # (eval.py:403-408; record naming
                    # h36_to_tfrecords_video.py:393).
                    seq_dir = os.path.join(
                        out_dir,
                        f"S{subject}_{action}_{trial_id - 1}"
                        f"_cam{cam - 1:02d}",
                    )
                    got = extract_sequence(
                        video_path=files["videos"][cam - 1],
                        pose2d_path=files["pose2d"][cam - 1],
                        pose3d_path=files["pose3d"][cam - 1],
                        camera=camera_parameters(tokens, subject, cam),
                        out_dir=seq_dir,
                        frame_skip=frame_skip,
                    )
                    if got:
                        written.append(got)
    return written


def reprojection_error(seq_dir: str) -> float:
    """Mean px distance between gt2d and the projection of gt3d through
    the stored camera — a sanity check that the camera math and CDF
    layouts were ingested consistently."""
    gt2d = np.load(os.path.join(seq_dir, "gt2d.npy"))[..., :2]
    gt3d = np.load(os.path.join(seq_dir, "gt3d.npy")) * 1000.0
    cam = dict(np.load(os.path.join(seq_dir, "camera.npz")))
    # D3_Positions_mono is already camera-frame; project intrinsics-only.
    proj = project_points(
        gt3d,
        rotation=np.eye(3),
        translation=np.zeros(3),
        focal=cam["focal"],
        principal=cam["principal"],
        k_radial=cam["k_radial"],
        p_tangential=cam["p_tangential"],
    )
    return float(np.mean(np.linalg.norm(proj - gt2d, axis=-1)))


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--raw_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--frame_skip", type=int, default=2)
    parser.add_argument(
        "--subjects", type=int, nargs="+",
        default=[1, 5, 6, 7, 8, 9, 11],
    )
    args = parser.parse_args()
    dirs = convert_raw(
        args.raw_dir, args.out_dir, args.subjects, args.frame_skip
    )
    print(f"Wrote {len(dirs)} sequence dirs under {args.out_dir}")
    print("Next: python -m human_dynamics_tpu_torch.datasets.h36m "
          f"--data_dir {args.out_dir} --out_dir <tfrecords>")


if __name__ == "__main__":
    main()
