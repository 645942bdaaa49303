"""Training-stability run on learnable synthetic data (GAN dynamics).

Counterpart of the JAX repo's ``scripts/stability_run.py``: thousands of
full train steps (encoder and discriminator updated together, every head,
the hallucinator, delta supervision) on self-consistent synthetic data
where every loss is learnable:

- per-tube SMPL pose trajectories are bounded random walks; shape is
  per-tube; cams jitter around [0.9, 0, 0];
- gt 3D joints and 2D keypoints come from a synthetic SMPL model (the real
  kinematic tree) and the orthographic projection of those poses, computed
  on the run's device;
- phi is a fixed random 2-layer MLP of (pose, shape, cam) plus noise, so
  the encoder stack can in principle invert it;
- the mocap "real" pool for the discriminator is drawn from the same pose
  distribution.

The numpy draws are those of the JAX generator, in the same order, so the
two write the same poses, shapes, cams, phis and mocap pool; the fields
derived through SMPL agree to float32 rounding.

``generate_data`` writes tfrecord shards and a synthetic SMPL npz; ``main``
then drives ``train.main`` for ``--num_steps`` steps. Loss curves land in
``{model_dir}/metrics.csv``; summarize them with ``summarize_stability``.

    python -m human_dynamics_tpu_torch.scripts.stability_run \\
        --out runs/stability --num_steps 5000 --fused [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def bounded_walk(rng, n, dim, step, bound):
    """Reflecting random walk (the reference's bounded_random_walk
    analogue, data_utils.py:787-835) used for temporally-smooth pose."""
    steps = rng.randn(n, dim) * step
    walk = np.cumsum(steps, axis=0)
    # reflect into [-bound, bound]
    walk = np.abs((walk + bound) % (4 * bound) - 2 * bound) - bound
    return walk


def make_phi_fn(rng, feature_dim):
    w0 = rng.randn(85, 256).astype(np.float32) * 0.3
    w1 = rng.randn(256, feature_dim).astype(np.float32) * 0.3

    def phi_fn(omega):
        h = np.maximum(omega @ w0, 0.0)
        return np.tanh(h @ w1)

    return phi_fn


def _render_skeleton_frame(kp_px, size, radius):
    """A synthetic 'video' frame: the gt 25-kp skeleton drawn on black with
    the port's overlay (viz/skeleton.py). Per-joint and per-edge colours
    make the pose recoverable from pixels."""
    from human_dynamics_tpu_torch.viz.skeleton import draw_skeleton

    canvas = np.zeros((size, size, 3), np.uint8)
    return draw_skeleton(canvas, kp_px, draw_edges=True, radius=radius)


def _encode_jpegs(frames, quality=90):
    import cv2

    return [
        cv2.imencode(
            ".jpg", f, [int(cv2.IMWRITE_JPEG_QUALITY), quality]
        )[1].tobytes()
        for f in frames
    ]


def generate_data(out_dir, num_tubes=64, frames_per_tube=120,
                  feature_dim=2048, num_verts=512, seed=0,
                  num_test_tubes=0, test_dataset="3dpw",
                  with_images=False, crop_size=224, device=None):
    """Write the synthetic train shards, mocap pool and (with
    ``num_test_tubes``) test records under ``out_dir``; returns
    (data_dir, smpl_path). SMPL runs on ``device`` (None: the CUDA device,
    and an error without one). A ``GENERATED.json`` marker with the same
    parameters skips the work."""
    import torch

    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.core.projection import orth_proj_idrot
    from human_dynamics_tpu_torch.core.smpl import smpl_forward
    from human_dynamics_tpu_torch.data import (
        TFRecordWriter,
        convert_to_example_temporal,
        encode_example,
    )
    from human_dynamics_tpu_torch.infer.predictor import resolve_device
    from human_dynamics_tpu_torch.utils.precision import full_fp32

    # Generation is deterministic in these parameters; skip the (slow,
    # for image mode) re-render when an identical run already completed
    # in out_dir. The marker is written LAST, so a killed run re-renders.
    gen_config = dict(
        num_tubes=num_tubes, frames_per_tube=frames_per_tube,
        feature_dim=feature_dim, num_verts=num_verts, seed=seed,
        num_test_tubes=num_test_tubes, test_dataset=test_dataset,
        with_images=with_images, crop_size=crop_size,
    )
    marker = os.path.join(out_dir, "GENERATED.json")
    data_dir = os.path.join(out_dir, "data")
    smpl_path = os.path.join(out_dir, "smpl_synth.npz")
    if os.path.exists(marker):
        with open(marker) as f:
            if json.load(f) == gen_config:
                return data_dir, smpl_path

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    # 25 regressed kps = the cocoplustoesankles regressor of real
    # training (universal-25 layout; config.num_kps default).
    smpl = synthetic_smpl_model(num_verts=num_verts, num_kps=25, device=dev)

    # Persist the synthetic model npz so the Trainer decodes with the
    # same body model that generated the gt.
    os.makedirs(out_dir, exist_ok=True)
    np.savez(
        smpl_path,
        v_template=smpl.v_template.cpu().numpy(),
        shapedirs=smpl.shapedirs.cpu().numpy(),
        posedirs=smpl.posedirs.cpu().numpy(),
        j_regressor=smpl.j_regressor.cpu().numpy(),
        lbs_weights=smpl.lbs_weights.cpu().numpy(),
        cocoplus_regressor=smpl.joint_regressor.cpu().numpy(),
        parents=np.asarray(smpl.parents),
        faces=np.asarray(smpl.faces),
    )

    phi_fn = make_phi_fn(rng, feature_dim)

    # Two sources drive the split-balanced loader exactly like real
    # training: an 'h36m'-named 3D dataset (full SMPL + 3D joints gt)
    # and a 'synth' 2D dataset (keypoints only), each >= 2 shards.
    dirs = {
        True: os.path.join(data_dir, "h36m", "train"),
        False: os.path.join(data_dir, "synth", "train"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    mocap_dir = os.path.join(data_dir, "mocap_neutrMosh")
    os.makedirs(mocap_dir, exist_ok=True)

    @torch.inference_mode()
    def joints_and_kps(shapes, poses, cams):
        """SMPL joints (n, 25, 3) and their projection (n, 25, 2) on the
        device, fetched as float32 numpy."""
        with full_fp32():
            out = smpl_forward(
                smpl,
                torch.as_tensor(shapes, dtype=torch.float32, device=dev),
                torch.as_tensor(poses, dtype=torch.float32, device=dev),
            )
            kps = (None if cams is None else orth_proj_idrot(
                out.joints,
                torch.as_tensor(cams, dtype=torch.float32, device=dev)))
        return (out.joints.cpu().numpy(),
                None if kps is None else kps.cpu().numpy())

    def synth_tube(n):
        """One tube of known-Omega gt: pose/shape/cams random walks ->
        SMPL joints -> projected kps -> phi via the fixed MLP."""
        pose = bounded_walk(rng, n, 72, step=0.03, bound=0.6)
        pose[:, 0] += np.pi  # upright global rotation, like real data
        shape = (rng.randn(10) * 0.3).astype(np.float32)
        cams = np.stack([
            0.9 + 0.05 * bounded_walk(rng, n, 1, 0.01, 0.1)[:, 0],
            0.05 * bounded_walk(rng, n, 1, 0.01, 0.1)[:, 0],
            0.05 * bounded_walk(rng, n, 1, 0.01, 0.1)[:, 0],
        ], axis=1).astype(np.float32)
        joints25, kps25 = joints_and_kps(np.tile(shape, (n, 1)), pose, cams)
        gt3ds = joints25[:, :14]                       # LSP-14
        omega = np.concatenate([cams, pose, np.tile(shape, (n, 1))],
                               axis=1).astype(np.float32)
        phis = phi_fn(omega) + rng.randn(n, feature_dim).astype(
            np.float32) * 0.01
        return pose, shape, cams, gt3ds, kps25, phis

    # Image-mode tubes store frames LARGER than the train crop so the
    # tube augmentation's scale walk (2^±0.3) and ±trans_max jitter stay
    # inside real pixels: crop window half-extent at min scale is
    # crop/2 * 2^0.3 ≈ 0.62*crop, plus the 20 px translation walk.
    render_size = int(np.ceil(crop_size * 1.25)) + 48 if with_images else 0
    radius = max(3, int(round(crop_size * 0.02)) + 1)

    # The synthetic SMPL body spans only ~0.2 of the [-1, 1] projection
    # box; rendered raw it would be a ~6 px blob at crop 64. Fix a
    # GLOBAL zoom (same for every tube, train and test — i.e. a camera
    # crop scale, exactly what real-data person crops do) so the body
    # fills ~75% of the crop. kp labels and renders stay consistent by
    # construction; training recovers scale through the predicted
    # camera, as with real crops.
    zoom, center0 = 1.0, np.zeros(2, np.float32)
    if with_images:
        base, _ = joints_and_kps(
            np.zeros((1, 10)), np.concatenate([[np.pi], np.zeros(71)])[None],
            None)
        j2 = base[0, :, :2]
        center0 = 0.9 * j2.mean(axis=0)     # mean cam scale is 0.9
        extent = float(np.abs(j2 - j2.mean(axis=0)).max())
        zoom = 0.6 / max(0.9 * extent, 1e-3)

    def kp_to_px(kps, size):
        """[-1, 1] normalized kps -> px where the (zoomed, re-centered)
        projection box spans one crop_size window centered in a
        size x size frame (a centered unjittered crop reproduces the
        training labels exactly)."""
        return size / 2.0 + (kps - center0) * zoom * (crop_size / 2.0)

    tubes_per_shard = 8
    all_poses = []
    writers = {}
    for ti in range(num_tubes):
        with_3d = ti % 2 == 0
        si = (ti // 2) // tubes_per_shard
        if (with_3d, si) not in writers:
            writers[(with_3d, si)] = TFRecordWriter(os.path.join(
                dirs[with_3d], f"shard_{si:03d}.tfrecord"
            ))
        writer = writers[(with_3d, si)]
        n = frames_per_tube
        pose, shape, cams, gt3ds, kps25, phis = synth_tube(n)
        all_poses.append(pose)
        labels = np.zeros((n, 3, 25), np.float32)
        if with_images:
            # Image-mode train records: kp labels in source-frame px
            # (the on-device tube augmentation transforms them into
            # normalized crop coords, data/augment.py:augment_tube).
            kp_px = kp_to_px(kps25, render_size)
            labels[:, :2] = np.transpose(kp_px, (0, 2, 1))
            image_datas = _encode_jpegs([
                _render_skeleton_frame(kp_px[i], render_size, radius)
                for i in range(n)
            ])
            src, center, phis_out = render_size, render_size // 2, None
        else:
            labels[:, :2] = np.transpose(kps25, (0, 2, 1))
            image_datas, src, center, phis_out = None, 224, 112, phis
        labels[:, 2] = 1.0

        writer.write(convert_to_example_temporal(
            image_datas=image_datas,
            image_paths=[f"f{i}.png" for i in range(n)],
            image_shapes=np.full((n, 2), src),
            labels=labels,
            centers=np.full((n, 2), center, np.int64),
            gt3ds=gt3ds.astype(np.float32) if with_3d else None,
            scale_factors=np.ones((n, 2), np.float32),
            start_pts=np.zeros((n, 2), np.int64),
            cams=cams if with_3d else None,
            poses=pose.astype(np.float32) if with_3d else None,
            shape=shape if with_3d else None,
            phis=phis_out,
        ))
    for w in writers.values():
        w.close()

    # Mocap real pool from the same pose distribution.
    pool = np.concatenate(all_poses, axis=0)
    rng.shuffle(pool)
    with TFRecordWriter(
        os.path.join(mocap_dir, "neutrSMPL_CMU_0.tfrecord")
    ) as w:
        for pose in pool[:5000]:
            w.write(encode_example({
                "pose": pose.astype(np.float32),
                "shape": (rng.randn(10) * 0.3).astype(np.float32),
            }))

    # Held-out TEST records for the synthetic accuracy gauntlet
    # (synthetic_gauntlet.py): same generator, fresh trajectories, full
    # 3D gt. Labels are PIXEL coords at the 224 crop — the reference's
    # test records store crop-space px (make_test_tfrecords.py:84-161)
    # and the eval harness converts normalized predictions the same way
    # (eval.py:211).
    if num_test_tubes:
        test_dir = os.path.join(data_dir, test_dataset, "test")
        os.makedirs(test_dir, exist_ok=True)
        for ti in range(num_test_tubes):
            n = frames_per_tube
            pose, shape, cams, gt3ds, kps25, phis = synth_tube(n)
            if with_images:
                # Test records store the crop directly (the reference's
                # test records are 224 crops, make_test_tfrecords.py:
                # 84-161): render at crop_size, centered, no phi — the
                # eval harness then takes the image path.
                kp_px = kp_to_px(kps25, crop_size)
                image_datas = _encode_jpegs([
                    _render_skeleton_frame(kp_px[i], crop_size, radius)
                    for i in range(n)
                ])
                src, phis_out = crop_size, None
            else:
                kp_px = (kps25 + 1.0) * 0.5 * 224.0
                image_datas, src, phis_out = None, 224, phis
            labels = np.zeros((n, 3, 25), np.float32)
            labels[:, :2] = np.transpose(kp_px, (0, 2, 1))
            labels[:, 2] = 1.0
            serialized = convert_to_example_temporal(
                image_datas=image_datas,
                image_paths=[f"t{ti}_f{i}.png" for i in range(n)],
                image_shapes=np.full((n, 2), src),
                labels=labels,
                centers=np.full((n, 2), src // 2, np.int64),
                gt3ds=gt3ds.astype(np.float32),
                scale_factors=np.ones((n, 2), np.float32),
                start_pts=np.zeros((n, 2), np.int64),
                cams=cams,
                poses=pose.astype(np.float32),
                shape=shape,
                phis=phis_out,
                time_pts=np.asarray([0, n]),
            )
            with TFRecordWriter(os.path.join(
                test_dir, f"record_{ti:02d}.tfrecord"
            )) as w:
                w.write(serialized)

    with open(marker, "w") as f:
        json.dump(gen_config, f)
    return data_dir, smpl_path


def main(argv=None):
    """Generate the data and train on it; returns the Trainer after its
    final save (its ``config.model_dir`` holds metrics.csv)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "stability"))
    ap.add_argument("--num_steps", type=int, default=5000)
    ap.add_argument("--num_tubes", type=int, default=64)
    ap.add_argument("--frames_per_tube", type=int, default=120)
    ap.add_argument("--feature_dim", type=int, default=2048)
    ap.add_argument("--num_verts", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--log_step", type=int, default=50)
    ap.add_argument("--fused", action="store_true",
                    help="the fused SMPL kernel (K1 on the GPU)")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA device by default, 'cpu' "
                         "to run on the CPU")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    data_dir, smpl_path = generate_data(
        args.out, num_tubes=args.num_tubes,
        frames_per_tube=args.frames_per_tube, feature_dim=args.feature_dim,
        num_verts=args.num_verts, device=args.device,
    )
    print(f"[*] synthetic data in {data_dir}")

    from human_dynamics_tpu_torch.train.main import main as train_main

    flags = [
        "--data_dir", data_dir,
        "--datasets", "synth", "h36m",
        "--mocap_datasets", "CMU",
        "--smpl_model_path", smpl_path,
        "--log_dir", os.path.join(args.out, "logs"),
        "--feature_dim", str(args.feature_dim),
        "--batch_size", str(args.batch_size),
        "--do_hallucinate", "true",
        "--use_fused_smpl", "true" if args.fused else "false",
        "--log_step", str(args.log_step),
        "--save_step", "2000",
        "--log_img_step", "0",
        "--num_steps", str(args.num_steps),
    ]
    if args.device is not None:
        flags += ["--device", args.device]
    return train_main(flags)


if __name__ == "__main__":
    main()
