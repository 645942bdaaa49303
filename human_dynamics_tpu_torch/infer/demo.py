"""The demo: a video or frame directory plus a 2-D track JSON -> the
per-frame SMPL pkl (and a rendered video).

Counterpart of ``human_dynamics_tpu/infer/demo.py`` (the reference's
demo_video.py and src/evaluation/run_video.py), with the same flags and
``--device`` (the CUDA device by default, raising without one; ``cpu`` to
run on the CPU):

    python -m human_dynamics_tpu_torch.infer.demo --img_dir D \\
        --track_json J --load_path W.npz --smpl_model_path S.{npz,pkl} \\
        [--fast] [--no_render] [--device cpu]

Pipeline: track JSON -> smoothed bboxes (host) -> 224 crops on the
predictor's device (``infer.crop``: each raw uint8 frame goes up once) ->
windowed prediction (``HmmrPredictor``; ``--fast`` is the fused SMPL
kernel and the bf16 encoder) -> ``hmmr_output.pkl`` with the JAX demo's
schema and dtypes (cams/joints/kps/poses/shapes/verts/omegas, their
``_delta`` stacks and ``frame_range``), which the JAX package's tools read
-> optionally a 2x2 composite video (mesh on the crop, mesh in the
original frame, 2-D skeleton, rotated mesh) rendered on the host.

``--load_path`` is an npz of the JAX package's layout
(``utils.checkpoint``; a Trainer checkpoint's ``params_e`` is taken).
Reading frames, drawing skeletons and writing the video need cv2, which is
imported only there; an existing pkl or mp4 is reused, as the reference
does.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from human_dynamics_tpu_torch.infer.bbox import get_smooth_bbox_params
from human_dynamics_tpu_torch.infer.crop import process_image
from human_dynamics_tpu_torch.infer.tracks import get_labels_poseflow


def preprocess_track(
    frames: List[np.ndarray],
    kps: List[Optional[np.ndarray]],
    vis_thresh: float = 0.1,
    device=None,
):
    """Smoothed bbox and crop of every frame of one tracklet
    (demo_video.py:136-153). Returns the (N, 224, 224, 3) float32 crops on
    ``device``, the crops' metadata and (first, end) frames."""
    bbox_params_smooth, s, e = get_smooth_bbox_params(
        kps, vis_thresh=vis_thresh
    )
    min_f = max(s, 0)
    max_f = min(e, len(kps))
    images = []
    proc_infos = []
    for i in range(min_f, max_f):
        proc = process_image(frames[i], bbox_params_smooth[i],
                             device=device)
        images.append(proc.pop("image"))
        proc_infos.append(proc)
    return torch.stack(images), proc_infos, (min_f, max_f)


def predict_on_tracks(
    predictor,
    frames: List[np.ndarray],
    poseflow_path: str,
    output_path: str,
    track_id: int = 0,
    trim_length: int = 0,
):
    """Predict one PoseFlow tracklet and save hmmr_output.pkl
    (demo_video.py:124-191); an existing pkl is loaded instead. The crops
    are made on the predictor's device."""
    all_kps = get_labels_poseflow(poseflow_path, len(frames))
    track_id = min(track_id, len(all_kps) - 1)
    kps = all_kps[track_id]

    images, proc_infos, (min_f, max_f) = preprocess_track(
        frames, kps, device=predictor.device)

    if track_id > 0:
        output_path += f"_{track_id}"
    os.makedirs(output_path, exist_ok=True)
    pred_path = os.path.join(output_path, "hmmr_output.pkl")
    if os.path.exists(pred_path):
        with open(pred_path, "rb") as f:
            preds = pickle.load(f)
    else:
        preds = predictor.predict_all_images(images)
        # The frames the track covers, as the JAX demo records them.
        preds["frame_range"] = np.array([min_f, max_f])
        with open(pred_path, "wb") as f:
            pickle.dump(preds, f)

    return preds, images, proc_infos, output_path


def render_preds(
    output_path: str,
    preds,
    images,
    proc_infos,
    faces: np.ndarray,
    trim_length: int = 0,
    fps: int = 25,
    orig_frames=None,
):
    """2x2 composite video: mesh on the crop / mesh in the original frame /
    2-D skeleton / rotated mesh (run_video.py:110-202). Without
    ``orig_frames`` (raw RGB frames of the crop range) the top-right panel
    is the crop's. An existing mp4 is reused."""
    import cv2

    from human_dynamics_tpu_torch.viz.composite import (
        visualize_img,
        visualize_img_orig,
    )
    from human_dynamics_tpu_torch.viz.renderer import VisRenderer
    from human_dynamics_tpu_torch.viz.video import make_video

    out_mp4 = os.path.join(output_path, "hmmr_output.mp4")
    if os.path.exists(out_mp4):
        return out_mp4

    if torch.is_tensor(images):
        images = images.cpu().numpy()
    crop_size = images.shape[1]
    renderer = VisRenderer(img_size=crop_size, faces=faces)
    t = slice(trim_length, len(images) - trim_length or None)
    frames_out = []
    for i in range(*t.indices(len(images))):
        skel, rend, rot = visualize_img(
            img=images[i],
            cam=preds["cams"][i],
            kp_pred=preds["kps"][i],
            vert=preds["verts"][i],
            renderer=renderer,
            rotated_view=True,
            no_text=True,
        )
        if orig_frames is not None:
            info = proc_infos[i]
            orig = ((np.asarray(orig_frames[i]) / 255.0) - 0.5) * 2
            _, rend_orig = visualize_img_orig(
                cam=preds["cams"][i],
                kp_pred=preds["kps"][i],
                vert=preds["verts"][i],
                renderer=renderer,
                start_pt=info["start_pt"],
                scale=info["scale"],
                proc_img_shape=info["im_shape"],
                img=orig,
                no_text=True,
            )
            rend_orig = cv2.resize(
                (rend_orig * 255).astype(np.uint8),
                (crop_size, crop_size),
            ) / 255.0
            panel_tr = rend_orig
        else:
            panel_tr = rend
        crop = ((images[i] + 1) * 0.5)
        top = np.hstack([crop, panel_tr])
        bottom = np.hstack([skel, rot])
        frames_out.append(np.vstack([top, bottom]).astype(np.float32))

    make_video(out_mp4, frames=frames_out, fps=fps)
    return out_mp4


def _predict_and_render(
    predictor, smpl, args, frames, track_json, out_base, trim_length
):
    """The tail of every input mode: predict one tracklet, save the pkl,
    and render the composite video unless ``--no_render``."""
    preds, images, proc_infos, out = predict_on_tracks(
        predictor, frames, track_json, out_base,
        track_id=args.track_id, trim_length=trim_length,
    )
    print(f"Saved predictions for {len(images)} frames to {out}")

    if not args.no_render:
        fr = preds.get("frame_range")
        orig = frames[fr[0]:fr[1]] if fr is not None else None
        mp4 = render_preds(
            out, preds, images, proc_infos, smpl.faces,
            trim_length=trim_length, orig_frames=orig,
        )
        print(f"Rendered {mp4}")


def _read_frames(paths):
    """RGB uint8 frames of image files (cv2)."""
    import cv2

    return [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in paths]


def _frame_paths(img_dir):
    return sorted(
        os.path.join(img_dir, f)
        for f in os.listdir(img_dir)
        if f.endswith((".png", ".jpg"))
    )


def run_on_video(predictor, smpl, args, vid_path: str, trim_length: int):
    """One video end to end: tracks -> prediction -> render
    (demo_video.py:194-217). Without ``--track_json`` AlphaPose/PoseFlow run
    through ``compute_tracks`` (idempotent; one subdirectory per video
    under ``--track_dir``)."""
    from human_dynamics_tpu_torch.infer.extract_tracks import compute_tracks
    from human_dynamics_tpu_torch.viz.video import dump_frames

    vid_name = os.path.splitext(os.path.basename(vid_path))[0]
    if args.track_json:
        track_json = args.track_json
        img_dir = os.path.join(args.out_dir, vid_name + "_frames")
        paths = dump_frames(vid_path, img_dir)
        out_base = os.path.join(args.out_dir, "hmmr_output")
    else:
        print(f"Computing tracks on {vid_path}.")
        track_dir = os.path.join(args.track_dir or args.out_dir, vid_name)
        track_json, img_dir = compute_tracks(
            vid_path, track_dir,
            alphapose_dir=args.alphapose_dir,
            poseflow_dir=args.poseflow_dir,
        )
        paths = _frame_paths(img_dir)
        out_base = os.path.join(args.out_dir, vid_name, "hmmr_output")
    _predict_and_render(
        predictor, smpl, args, _read_frames(paths), track_json, out_base,
        trim_length,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--vid_path", help="input video")
    parser.add_argument("--img_dir", help="or: directory of frames")
    parser.add_argument("--vid_dir",
                        help="or: run on every *.mp4 in a directory "
                             "(demo_video.py:229-231)")
    parser.add_argument("--track_json",
                        help="PoseFlow tracked json; when absent the "
                             "AlphaPose/PoseFlow pipeline runs via "
                             "compute_tracks (requires --vid_path/--vid_dir)")
    parser.add_argument("--track_dir",
                        help="where track intermediates go "
                             "(default: --out_dir)")
    parser.add_argument("--alphapose_dir",
                        help="AlphaPose checkout (see extract_tracks)")
    parser.add_argument("--poseflow_dir",
                        help="PoseFlow checkout (see extract_tracks)")
    parser.add_argument("--load_path", required=True,
                        help="an npz checkpoint of the JAX package's layout")
    parser.add_argument("--smpl_model_path", required=True,
                        help="an SMPL npz (convert_smpl_pkl) or the SMPL pkl")
    parser.add_argument("--out_dir", default="demo_output")
    parser.add_argument("--track_id", type=int, default=0)
    parser.add_argument("--trim", action="store_true")
    parser.add_argument("--no_render", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--T", type=int, default=20)
    parser.add_argument("--fast", action="store_true",
                        help="fused SMPL kernel + bf16 encoder")
    parser.add_argument("--device", default=None,
                        help="torch device; the CUDA device by default, "
                             "'cpu' to run on the CPU")
    args = parser.parse_args(argv)
    n_inputs = sum(bool(x) for x in (args.vid_path, args.img_dir, args.vid_dir))
    if n_inputs != 1:
        parser.error(
            "exactly one of --vid_path / --img_dir / --vid_dir is required"
        )
    if args.img_dir and not args.track_json:
        parser.error("--img_dir requires --track_json (no video to track)")
    if args.vid_dir and args.track_json:
        parser.error("--vid_dir computes tracks per video; "
                     "--track_json only applies to a single input")

    from human_dynamics_tpu_torch.core.smpl import load_smpl_model
    from human_dynamics_tpu_torch.eval.harness import load_model_variables
    from human_dynamics_tpu_torch.infer.predictor import (
        HmmrPredictor,
        resolve_device,
    )
    from human_dynamics_tpu_torch.models.hmmr import HmmrModel
    from human_dynamics_tpu_torch.utils.weights import load_jax_variables

    device = resolve_device(args.device)
    smpl = load_smpl_model(args.smpl_model_path, joint_type="cocoplus")
    model = HmmrModel(include_resnet=True, device="meta").to_empty(
        device="cpu")
    load_jax_variables(model, load_model_variables(args.load_path))
    predictor = HmmrPredictor(
        model, None, smpl,
        batch_size=args.batch_size, seq_length=args.T,
        use_fused_smpl=args.fast, bf16_encoder=args.fast, device=device,
    )
    trim_length = predictor.model.fov // 2 if args.trim else 0

    if args.vid_dir:
        import glob as globmod

        vid_paths = sorted(globmod.glob(os.path.join(args.vid_dir, "*.mp4")))
        if not vid_paths:
            raise SystemExit(f"no *.mp4 in {args.vid_dir}")
        for vid_path in vid_paths:
            run_on_video(predictor, smpl, args, vid_path, trim_length)
    elif args.vid_path:
        run_on_video(predictor, smpl, args, args.vid_path, trim_length)
    else:
        # Frame directory + precomputed tracks (no video file).
        _predict_and_render(
            predictor, smpl, args, _read_frames(_frame_paths(args.img_dir)),
            args.track_json, os.path.join(args.out_dir, "hmmr_output"),
            trim_length,
        )


if __name__ == "__main__":
    main()
