"""Synthetic ground-truth accuracy gauntlet: the closed training->eval loop.

Counterpart of the JAX repo's ``scripts/synthetic_gauntlet.py``, on the
port's modules. The reference's de-facto golden test is the published eval
table computed from the released checkpoint
(its src/evaluation/eval.py:353-496 against
doc/eval.md:27-31). Its released assets are not available, so this script
instantiates the same workflow on synthetic data:

1. Generate tubes whose gt keypoints / 3D joints / poses come from KNOWN
   Omega trajectories pushed through the port's own SMPL + orthographic
   projection (plus phi noise) — ``stability_run.generate_data``, with
   held-out TEST records carrying full 3D gt.
2. Train from scratch on the real loader and trainer (``train.main``),
   checkpointing every ``--save_step`` steps.
3. Run the FULL eval harness (``eval.harness.Evaluator``: per-record and
   per-tube loop, caches, metric dict, results JSON) on the held-out
   records at every checkpoint, plus an untrained baseline.
4. Run the demo pkl path (``predict_all_images`` -> hmmr_output.pkl with
   the demo schema) on the trained checkpoint.
5. Emit a markdown report with the metric table vs train step and the
   hallucination-vs-constant table.

Quantitative recovery of the known Omega (errors far below the real-data
baselines of doc/eval.md:27-31, improving with training) is whole-pipeline
evidence that train+checkpoint+eval compose correctly — it would catch
global sign/convention errors that per-module parity tests cannot.

    python -m human_dynamics_tpu_torch.scripts.synthetic_gauntlet \\
        --out runs/gauntlet --num_steps 4000 --save_step 1000 --fused \\
        [--mode image] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import tempfile
import time

import numpy as np

METRIC_KEYS = (
    "accel_error", "kp", "kp_pa", "kp_pck", "joints", "joints_pa",
    "mesh_posed", "mesh_tpose",
)

# Real-data 3DPW-test numbers of the released reference checkpoint
# (doc/eval.md:28; BASELINE.md) — the scale the synthetic recovery is
# reported against.
REFERENCE_3DPW = {
    "accel_error": 0.01532, "kp": 5.90772, "kp_pa": 5.48809,
    "kp_pck": 0.92961, "joints": 0.11688, "joints_pa": 0.07266,
    "mesh_posed": 0.13934, "mesh_tpose": 0.02680,
}


def _step_of(path):
    return int(path.rsplit("-", 1)[1].split(".")[0])


def run_gauntlet(args):
    """The whole loop; returns the results dict (also written as
    ``{out}/gauntlet_results.json``). ``args.device`` None means the CUDA
    device."""
    import torch

    from human_dynamics_tpu_torch.scripts.stability_run import generate_data

    os.makedirs(args.out, exist_ok=True)
    device = getattr(args, "device", None)
    seconds = {}
    t0 = time.perf_counter()
    image_mode = args.mode == "image"
    data_dir, smpl_path = generate_data(
        args.out,
        num_tubes=args.num_tubes,
        frames_per_tube=args.frames_per_tube,
        feature_dim=args.feature_dim,
        num_verts=args.num_verts,
        seed=args.seed,
        num_test_tubes=args.num_test_tubes,
        test_dataset="3dpw",
        with_images=image_mode,
        crop_size=args.img_size,
        device=device,
    )
    seconds["generate"] = time.perf_counter() - t0
    print(f"[*] synthetic train+test data in {data_dir}")

    train_data_dir = data_dir
    if image_mode and getattr(args, "raw_records", False):
        # Zero-decode training records (datasets/reencode_records.py);
        # eval and demo keep the jpeg test records.
        from human_dynamics_tpu_torch.datasets.reencode_records import (
            reencode_dir,
        )

        raw_dir = data_dir.rstrip("/") + "_raw"
        for ds in ("synth", "h36m"):
            reencode_dir(os.path.join(data_dir, ds, "train"),
                         os.path.join(raw_dir, ds, "train"))
        mocap_link = os.path.join(raw_dir, "mocap_neutrMosh")
        if not os.path.exists(mocap_link):
            os.symlink(os.path.join(data_dir, "mocap_neutrMosh"),
                       mocap_link)
        train_data_dir = raw_dir
        print(f"[*] training on raw_u8 records in {raw_dir}")

    model_dir = os.path.join(args.out, "model")
    from human_dynamics_tpu_torch.train.main import main as train_main

    def final_ckpt_exists():
        return os.path.exists(
            os.path.join(model_dir, f"ckpt-{args.num_steps}.npz"))

    train_flags = [
        "--data_dir", train_data_dir,
        "--datasets", "synth", "h36m",
        "--mocap_datasets", "CMU",
        "--smpl_model_path", smpl_path,
        "--model_dir", model_dir,
        "--feature_dim", str(args.feature_dim),
        "--do_hallucinate", "true",
        "--use_fused_smpl", "true" if args.fused else "false",
        "--log_step", "100",
        "--save_step", str(args.save_step),
        "--log_img_step", "0",
        "--num_steps", str(args.num_steps),
        "--batch_size", str(args.batch_size),
        "--T", str(args.T),
    ]
    if device is not None:
        train_flags += ["--device", str(device)]
    if getattr(args, "save_params_only", False):
        # Eval-only checkpoints. A rerun after an interruption would
        # auto-resume from a mid-run params-only checkpoint with RESET
        # Adam moments and perturb the accuracy-gate trajectory — so when
        # the final checkpoint is absent, any partial model_dir is cleared
        # for a clean from-scratch run.
        train_flags += ["--save_params_only", "true"]
        if not final_ckpt_exists() and os.path.isdir(model_dir):
            import shutil

            print(f"[*] clearing partial {model_dir} "
                  "(params-only resume would reset Adam moments)")
            shutil.rmtree(model_dir)
    if image_mode:
        # The image leg trains the WHOLE pipeline — a random-init
        # resnet_v2_50 included — so the encoder must learn to invert
        # the skeleton rendering from pixels (no phi shortcut exists in
        # the records). From-scratch needs a real learning rate (the
        # reference's 1e-5 is a fine-tuning rate for a pretrained
        # trunk).
        train_flags += [
            "--precomputed_phi", "false",
            "--freeze_phi", "false",
            "--img_size", str(args.img_size),
            "--e_lr", str(args.e_lr),
            "--use_bfloat16", "true" if args.bf16 else "false",
        ]
    t0 = time.perf_counter()
    if not final_ckpt_exists():
        train_main(train_flags)
    seconds["train"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Eval every checkpoint + the untrained baseline.
    # ------------------------------------------------------------------
    from human_dynamics_tpu_torch.core.smpl import load_smpl_model
    from human_dynamics_tpu_torch.eval.harness import (
        Evaluator,
        restore_model_config,
    )
    from human_dynamics_tpu_torch.infer.predictor import (
        HmmrPredictor,
        resolve_device,
    )
    from human_dynamics_tpu_torch.models.hmmr import HmmrModel
    from human_dynamics_tpu_torch.utils.checkpoint import load_checkpoint
    from human_dynamics_tpu_torch.utils.weights import load_jax_variables

    dev = resolve_device(device)
    smpl = load_smpl_model(smpl_path, joint_type="cocoplus")
    model_kwargs = restore_model_config(model_dir)
    model_kwargs["include_resnet"] = image_mode
    model_kwargs.setdefault("feature_dim", args.feature_dim)

    ckpts = sorted(glob.glob(os.path.join(model_dir, "ckpt-*.npz")),
                   key=_step_of)
    assert ckpts, f"no checkpoints in {model_dir}"

    def eval_at(tag, model):
        predictor = HmmrPredictor(
            model, None, smpl,
            batch_size=args.batch_size, seq_length=args.T,
            use_fused_smpl=args.fused, device=dev,
        )
        ev = Evaluator(
            predictor, os.path.join(args.out, "eval"),
            model_tag=tag,
            device_metrics=getattr(args, "device_metrics", False),
        )
        t = time.perf_counter()
        results = ev.run(data_dir, ["3dpw"], split="test")
        seconds["eval"][tag] = time.perf_counter() - t
        return {
            k: float(v) for k, v in results["3dpw"].items()
            if k in METRIC_KEYS
        }, predictor, ev

    table = {}
    seconds["eval"] = {}
    # Untrained baseline: a fresh init from seed + 1.
    init_model = HmmrModel(
        **model_kwargs, device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    table[0], _, _ = eval_at("step0", init_model)
    del init_model
    print(f"[*] untrained baseline: {table[0]}")

    final_predictor = final_ev = None
    for ckpt in ckpts:
        step = _step_of(ckpt)
        model = HmmrModel(**model_kwargs, device="meta").to_empty(device=dev)
        load_jax_variables(model, load_checkpoint(ckpt)["params_e"])
        table[step], final_predictor, final_ev = eval_at(
            f"step{step}", model
        )
        print(f"[*] step {step}: {table[step]}")

    # ------------------------------------------------------------------
    # Hallucination-dynamics table on the final checkpoint.
    # ------------------------------------------------------------------
    const_table = final_ev.run_const(data_dir, ["3dpw"], split="test")
    const_3dpw = {
        k: float(v) for k, v in const_table["3dpw"].items()
    }

    # ------------------------------------------------------------------
    # Demo pkl path on the trained checkpoint (demo schema,
    # tester.py:217-255 keys; frame_range is this repo's provenance
    # addition).
    # ------------------------------------------------------------------
    from human_dynamics_tpu_torch.data.schema import read_test_example
    from human_dynamics_tpu_torch.data.tfrecord import read_tfrecord

    test_rec = sorted(glob.glob(
        os.path.join(data_dir, "3dpw", "test", "*.tfrecord")
    ))[0]
    data = read_test_example(next(iter(read_tfrecord(test_rec))))
    demo_dir = os.path.join(args.out, "demo_out")
    os.makedirs(demo_dir, exist_ok=True)
    if image_mode:
        # RAW uint8 frames — the predictor's serving contract
        # normalizes on device (predictor.py predict_all_images).
        preds = final_predictor.predict_all_images(
            np.stack(data["images"]).astype(np.uint8)
        )
    else:
        preds = final_predictor.predict_all_images(
            np.array(data["phis"], np.float32))
    preds["frame_range"] = np.array([0, data["N"]])
    pkl_path = os.path.join(demo_dir, "hmmr_output.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(preds, f)
    demo_keys = sorted(preds)
    expected = {"cams", "joints", "kps", "poses", "shapes", "verts",
                "omegas", "joints_delta", "kps_delta", "poses_delta",
                "omegas_delta"}
    missing_keys = sorted(expected - set(demo_keys))
    print(f"[*] demo pkl written: {pkl_path}; missing keys: "
          f"{missing_keys or 'none'}")

    # ------------------------------------------------------------------
    # Gates + report.
    # ------------------------------------------------------------------
    steps = sorted(table)
    first, last = table[steps[0]], table[steps[-1]]
    # Gate calibration: the synthetic phi carries 1% feature noise (a
    # deliberate choice so the mapping is nontrivial), which sets a
    # recovery floor — Procrustes-aligned joint error bottoms out at a
    # few mm on this scale rather than going to zero. The gates
    # therefore require (a) strong unaligned recovery (kp 5x), (b)
    # monotone movement of every 3D metric below the untrained floor,
    # (c) the delta heads beating the constant-pose baseline (the
    # reference's dynamics-recovery criterion, eval.py:246-327), and
    # (d) landing far below the real-data reference scale.
    # Image mode is the strictly harder closed loop (pixels -> pose with
    # a random-init resnet, jpeg + integer-px rendering noise on top of
    # the phi noise), so its improvement/PCK gates are looser; kp gates
    # compare at the reference's 224-px scale either way.
    kp_scale = 224.0 / args.img_size if image_mode else 1.0
    kp_factor, pck_floor = (0.33, 0.90) if image_mode else (0.2, 0.99)
    gates = {
        "kp_improves": last["kp"] < kp_factor * first["kp"],
        "joints_improve": last["joints"] < first["joints"],
        "joints_pa_improve": last["joints_pa"] < first["joints_pa"],
        "pck_above_floor": last["kp_pck"] > pck_floor,
        "beats_reference_scale_joints_pa":
            last["joints_pa"] < REFERENCE_3DPW["joints_pa"],
        "beats_reference_scale_kp":
            last["kp"] * kp_scale < REFERENCE_3DPW["kp"],
        "delta_heads_beat_const_baseline": all(
            const_3dpw[f"joints_dt{dt}"]
            < const_3dpw[f"joints_const_dt{dt}"]
            for dt in (-5, 5)
            if f"joints_dt{dt}" in const_3dpw
        ),
        "demo_pkl_schema_complete": not missing_keys,
    }
    result = {
        "table": table,
        "const_table": const_3dpw,
        "gates": gates,
        "num_steps": args.num_steps,
        "config": vars(args),
        "seconds": seconds,
    }
    with open(os.path.join(args.out, "gauntlet_results.json"), "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)

    if args.report:
        write_report(args.report, result)
    ok = all(gates.values())
    print(f"[*] seconds: {seconds}")
    print(f"[*] gates: {gates}")
    print(f"[*] GAUNTLET {'PASS' if ok else 'FAIL'}")
    return result


def write_report(path, result):
    table = {int(k): v for k, v in result["table"].items()}
    steps = sorted(table)
    mode = result.get("config", {}).get("mode", "phi")
    mode_line = (
        "scratch on the real loader (`train/main.py`), full eval harness"
        if mode == "phi" else
        "scratch — IMAGE mode: tubes are rendered skeleton frames "
        "(jpeg), a random-init resnet_v2_50 trains end-to-end from "
        "pixels — on the real loader (`train/main.py`), full eval "
        "harness"
    )
    lines = [
        f"# Synthetic ground-truth accuracy gauntlet ({mode} mode)",
        "",
        "Closed-loop proof that train -> checkpoint -> eval -> demo-pkl",
        "compose correctly: tubes generated from KNOWN Omega trajectories",
        f"through the repo's own SMPL + projection, {mode}-mode training "
        "from",
        mode_line,
        "This is the reference's golden-table workflow",
        "(`src/evaluation/eval.py:353-496`, `doc/eval.md:27-31`)",
        "instantiated on the only data this environment permits",
        "(released assets are absent; `docs/real_asset_validation.md`).",
        "",
        "Reproduce: `python -m human_dynamics_tpu_torch.scripts."
        "synthetic_gauntlet --out runs/gauntlet`",
        "",
        "## Metric table vs train step (held-out synthetic 3dpw-format "
        "records)",
        "",
        "| step | " + " | ".join(METRIC_KEYS) + " |",
        "|---|" + "---|" * len(METRIC_KEYS),
    ]
    for s in steps:
        row = table[s]
        lines.append(
            f"| {s} | " + " | ".join(
                f"{row[k]:.5f}" if k in row else "-" for k in METRIC_KEYS
            ) + " |"
        )
    lines += [
        "| *reference real-3DPW (released ckpt, doc/eval.md:28)* | "
        + " | ".join(
            f"*{REFERENCE_3DPW[k]:.5f}*" for k in METRIC_KEYS
        ) + " |",
        "",
        "Step 0 is an untrained fresh init (the floor the gauntlet must",
        "climb from). Units: kp/kp_pa in px at 224, joints/mesh in the",
        "synthetic model's metric scale (~meters), accel per frame^2,",
        "pck in [0, 1]. The reference row is real data + real model —",
        "not comparable in difficulty, shown only to anchor the scale of",
        "'recovered': the synthetic-gt errors must land far below it.",
        "",
        "The synthetic phi carries 1% feature noise by construction, so",
        "errors converge to a noise floor (PA-aligned joint error a few",
        "mm at this scale) rather than zero; the gates encode strong",
        "movement to that floor, not exact zero recovery.",
        "",
        "## Hallucination dynamics vs constant baseline (final ckpt)",
        "",
        "| metric | value |",
        "|---|---|",
    ]
    for k in sorted(result["const_table"]):
        lines.append(f"| {k} | {result['const_table'][k]:.5f} |")
    lines += [
        "",
        "`joints_dt*` = the delta heads' prediction for frame t+dt;",
        "`joints_const_dt*` = predicting the present pose for t+dt",
        "(test_sequence_const, eval.py:246-327).",
        "",
        "## Gates",
        "",
        "| gate | pass |",
        "|---|---|",
    ]
    for k in sorted(result["gates"]):
        lines.append(f"| {k} | {result['gates'][k]} |")
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"[*] report written: {path}")


def build_arg_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "gauntlet"))
    ap.add_argument("--mode", choices=("phi", "image"), default="phi",
                    help="phi: precomputed-feature closed loop. image: "
                         "the full pixels->pose loop — tubes are "
                         "rendered skeleton frames (jpeg), a random-"
                         "init resnet trains end-to-end, eval runs on "
                         "held-out image records")
    ap.add_argument("--img_size", type=int, default=224,
                    help="image-mode crop size (smaller = faster; the "
                         "resnet handles any multiple of 32)")
    ap.add_argument("--e_lr", type=float, default=1e-4,
                    help="image-mode from-scratch learning rate")
    ap.add_argument("--bf16", action="store_true",
                    help="image-mode mixed-precision training")
    ap.add_argument("--raw_records", action="store_true",
                    help="image mode: re-encode the synthetic train "
                         "records to raw_u8 (zero-decode loader path) "
                         "before training")
    ap.add_argument("--num_steps", type=int, default=4000)
    ap.add_argument("--save_step", type=int, default=1000)
    ap.add_argument("--save_params_only", action="store_true",
                    help="eval-only checkpoints (no Adam moments): "
                         "~1/3 of the checkpoint's bytes")
    ap.add_argument("--num_tubes", type=int, default=64)
    ap.add_argument("--num_test_tubes", type=int, default=8)
    ap.add_argument("--frames_per_tube", type=int, default=120)
    ap.add_argument("--feature_dim", type=int, default=2048)
    ap.add_argument("--num_verts", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", action="store_true",
                    help="the fused SMPL kernel (K1 on the GPU)")
    ap.add_argument("--device_metrics", action="store_true",
                    help="compute the eval metric dict on the device "
                         "(eval/metrics_device.py)")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA device by default, 'cpu' "
                         "to run on the CPU")
    ap.add_argument("--report", default=None,
                    help="write a markdown report here")
    return ap


def main(argv=None):
    return run_gauntlet(build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
