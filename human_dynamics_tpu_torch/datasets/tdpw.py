"""3DPW -> test tfrecords, including neutral-shape fitting.

Counterpart of ``human_dynamics_tpu/datasets/tdpw.py``. The reference's:
- src/datasets/3dpw_to_tfrecords_video.py: sequence pkls (poses2d
  (F, 3, 18) padded to 25, neutral betas, gendered gt joints rectified into
  the identity camera: R (J - mu) + mu, lines 95-105) -> per-person test
  tubes.
- src/datasets/threedpw/read_3dpw.py: 18-kp COCO order -> universal 25 map
  and hardcoded split lists (we read split files or directory layout
  instead of hardcoding 60 names).
- src/datasets/threedpw/compute_neutral_shape.py: gradient fit of the
  neutral-SMPL betas to a gendered gt mesh (lr=1, <=5000 iters, converge at
  1e-4) — here ``torch.optim.Adam`` (optax.adam's defaults: betas 0.9 and
  0.999, eps 1e-8, bias correction) over the composed ``core.smpl``
  forward, on the card unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import List, Tuple

import numpy as np
import torch

from human_dynamics_tpu_torch.core.smpl import smpl_forward
from human_dynamics_tpu_torch.datasets.common import COCO25_JOINT_NAMES
from human_dynamics_tpu_torch.infer.predictor import resolve_device
from human_dynamics_tpu_torch.utils.precision import full_fp32

# 3DPW poses2d are 18-kp COCO ordered (read_3dpw.py:5-66).
COCO18_JOINT_NAMES = [
    "Nose", "Neck", "R Shoulder", "R Elbow", "R Wrist", "L Shoulder",
    "L Elbow", "L Wrist", "R Hip", "R Knee", "R Ankle", "L Hip",
    "L Knee", "L Heel", "R Eye", "L Eye", "R Ear", "L Ear",
]
# Pad the 7 universal joints 3DPW lacks with zeros then reorder.
_PADDED = COCO18_JOINT_NAMES + [
    n for n in COCO25_JOINT_NAMES if n not in COCO18_JOINT_NAMES
]
# The loss goes to the host once every this many iterations, for the
# convergence check.
CHECK_EVERY = 50


def get_3dpw2coco() -> Tuple[List[int], List[str]]:
    return (
        [_PADDED.index(n) for n in COCO25_JOINT_NAMES],
        COCO25_JOINT_NAMES,
    )


def rectify_joints(joints: np.ndarray, cam_r: np.ndarray) -> np.ndarray:
    """Rotate gt joints into the identity camera about their centroid
    (3dpw_to_tfrecords_video.py:95-105)."""
    mu = joints.mean(axis=0)
    return cam_r.dot((joints - mu).T).T + mu


def get_seq_data(anno_pkl: str, img_dir: str):
    """Sequence pkl -> (im_paths, poses (P,F,72), kps (P,F,25,3),
    shapes (P,10), joints rectified (P,F,25,3))
    (3dpw_to_tfrecords_video.py:43-115)."""
    with open(anno_pkl, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    num_people = len(data["poses"])
    num_frames = len(data["img_frame_ids"])
    joint_order, _ = get_3dpw2coco()

    all_poses, all_kps, all_shapes = [], [], []
    for p_id in range(num_people):
        all_poses.append(np.array(data["poses"][p_id]))
        kps_3dpw = data["poses2d"][p_id]               # (F, 3, 18)
        pad = np.dstack(
            [kps_3dpw, np.zeros((num_frames, 3, 7))]
        )                                               # (F, 3, 25)
        kps = np.array([kp.T[joint_order] for kp in pad])
        all_kps.append(kps)
        if "betas_neutral" in data:
            all_shapes.append(np.array(data["betas_neutral"][p_id][:10]))
        else:
            all_shapes.append(np.array(data["betas"][p_id][:10]))

    f_adj = all_kps[0].shape[0]
    all_poses = [p[:f_adj] for p in all_poses]
    joints = np.array(data["jointPositions"]
                      if "joints_gendered" not in data
                      else data["joints_gendered"])
    joints = joints.reshape(num_people, f_adj, -1, 3)

    cam_poses = data["cam_poses"]
    all_rect = []
    for p_id in range(num_people):
        rect = [
            rectify_joints(j, cam_pose[:3, :3])
            for cam_pose, j in zip(cam_poses, joints[p_id])
        ]
        all_rect.append(rect)
    all_rect = np.array(all_rect)

    im_paths = [
        os.path.join(img_dir, "image_%05d.jpg" % i) for i in range(f_adj)
    ]
    return im_paths, all_poses, all_kps, all_shapes, all_rect


def fit_neutral_shape(
    smpl_neutral,
    verts_gendered: np.ndarray,
    init_beta=None,
    pose: np.ndarray = None,
    lr: float = 0.05,
    max_iters: int = 5000,
    tol: float = 1e-4,
    device=None,
):
    """Fit neutral-SMPL betas to a gendered gt mesh
    (compute_neutral_shape.py:66-135; Adam replaces chumpy GD).

    ``smpl_neutral`` is a port ``SmplModel``; ``device`` None is the card
    (and raises without one). Every CHECK_EVERY iterations the loss comes
    to the host and the fit stops once it moved by less than ``tol`` of
    its previous value. Returns (beta (10,) numpy, the mse before the last
    update).
    """
    dev = resolve_device(device)
    smpl = smpl_neutral.to(dev)
    target = torch.as_tensor(np.asarray(verts_gendered), dtype=torch.float32,
                             device=dev)
    pose_t = (
        torch.zeros((1, 72), device=dev) if pose is None
        else torch.as_tensor(np.asarray(pose), dtype=torch.float32,
                             device=dev).reshape(1, 72)
    )
    beta = (
        torch.zeros((1, 10), device=dev) if init_beta is None
        else torch.as_tensor(np.asarray(init_beta), dtype=torch.float32,
                             device=dev).reshape(1, 10).clone()
    ).requires_grad_(True)
    opt = torch.optim.Adam([beta], lr=lr)

    prev = np.inf
    loss = None
    with full_fp32():
        for i in range(max_iters):
            opt.zero_grad(set_to_none=True)
            verts = smpl_forward(smpl, beta, pose_t).verts[0]
            loss = torch.mean((verts - target) ** 2)
            loss.backward()
            opt.step()
            if i % CHECK_EVERY == 0:
                cur = float(loss.detach())
                if abs(prev - cur) < tol * max(prev, 1e-12):
                    break
                prev = cur
    return beta.detach()[0].cpu().numpy(), float(loss.detach())


def process_3dpw(data_dir: str, out_dir: str, split: str = "test"):
    """All sequences of a split -> test tfrecords
    (3dpw_to_tfrecords_video.py:118-150)."""
    from human_dynamics_tpu_torch.datasets.test_records import (
        save_seq_to_test_tfrecord,
    )

    os.makedirs(os.path.join(out_dir, split), exist_ok=True)
    seq_dir = os.path.join(data_dir, "sequenceFilesNeutral")
    if not os.path.isdir(seq_dir):
        seq_dir = os.path.join(data_dir, "sequenceFiles", split)
    pkls = sorted(glob.glob(os.path.join(seq_dir, "*.pkl")))

    for i, pkl in enumerate(pkls):
        seq = os.path.splitext(os.path.basename(pkl))[0]
        img_dir = os.path.join(data_dir, "imageFiles", seq)
        out_name = os.path.join(out_dir, split, f"{seq}.tfrecord")
        if os.path.exists(out_name):
            continue
        im_paths, poses, kps, shapes, joints = get_seq_data(pkl, img_dir)
        print(f"{i}/{len(pkls)}: {out_name}")
        save_seq_to_test_tfrecord(
            out_name=out_name,
            im_paths=im_paths,
            all_gt2ds=kps,
            all_gt3ds=joints,
            all_poses=poses,
            all_shapes=shapes,
            vis_thresh=0.1,
        )


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--split", default="test")
    args = parser.parse_args()
    process_3dpw(args.data_dir, args.out_dir, args.split)


if __name__ == "__main__":
    main()
