"""Evaluation harness: test tfrecords -> cached predictions -> metric table.

Counterpart of ``human_dynamics_tpu/eval/harness.py``. Per dataset -> per
tfrecord -> per person tube: read the test example, predict with the
windowed predictor (cached as pkl), compute the error dict of the
reference's eval.py:114-193 (kp px error / PA / PCK@0.05*img, pred accel,
gt-vs-pred accel error, MPJPE, PA-MPJPE, posed/t-pose mesh error via
SMPL), then aggregate mean-of-means and write a results JSON
(eval.py:330-350,479-493).

Every tube's predictions and errors are cached on disk, so re-running
skips completed work. With ``device_metrics`` the error dict is computed
on the predictor's device (``eval/metrics_device.py``) and only scalars
are fetched.

Test records that hold JPEG frames need cv2 to decode; records with
``image/phis`` do not.

    python -m human_dynamics_tpu_torch.eval.harness --tf_dir RECORDS \\
        --load_path CKPT.npz --smpl_model_path SMPL.npz [--device cpu]
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from human_dynamics_tpu_torch.core.smpl import smpl_forward
from human_dynamics_tpu_torch.data.schema import read_test_example
from human_dynamics_tpu_torch.data.tfrecord import read_tfrecord
from human_dynamics_tpu_torch.eval import metrics as M
from human_dynamics_tpu_torch.eval.metrics_device import (
    make_compute_errors_device,
)

# Metric units: the reference's doc/eval.md:44-52 (accel m/s^2 per
# frame^2, kp in px at 224, joints/mesh in meters).


def compute_errors_batched(
    kps_gt: np.ndarray,              # (N, K, 3) pixel coords + vis
    kps_pred: np.ndarray,            # (N, K, 2) normalized [-1, 1]
    joints_gt: Optional[np.ndarray] = None,    # (N, 14, 3)
    joints_pred: Optional[np.ndarray] = None,  # (N, 14, 3)
    poses_gt: Optional[np.ndarray] = None,     # (N, 72) axis-angle
    poses_pred: Optional[np.ndarray] = None,   # (N, 24, 3, 3) rotmats
    shape_gt: Optional[np.ndarray] = None,     # (10,)
    shapes_pred: Optional[np.ndarray] = None,  # (N, 10)
    img_size: int = 224,
    has_3d: bool = False,
    min_visible: int = 6,
    compute_mesh: bool = False,
    smpl=None,
) -> Dict[str, object]:
    """Per-tube error dict (eval.py:114-193), same keys, in numpy. The mesh
    errors need cv2 (``metrics.rot_mat_to_axis_angle``)."""
    errors_kp, errors_kp_pa, errors_kp_pck = M.compute_error_kp(
        kps_gt=kps_gt,
        kps_pred=(kps_pred + 1) * 0.5 * img_size,
        alpha=0.05 * img_size,
        min_visible=min_visible,
    )
    errors_dict: Dict[str, object] = {
        "accel": M.compute_accel(joints_pred),
        "kp": errors_kp,
        "kp_pa": errors_kp_pa,
        "kp_pck": errors_kp_pck,
    }

    if has_3d:
        vis = np.sum(kps_gt[:, :14, 2], axis=1) > min_visible
        errors_accel = M.compute_error_accel(
            joints_gt=joints_gt, joints_pred=joints_pred, vis=vis
        )
        if compute_mesh:
            if smpl is None:
                raise ValueError("the mesh error needs an SmplModel")
            shapes_gt_tiled = np.tile(shape_gt, (len(poses_gt), 1))
            poses_pred_aa = np.array([
                M.rot_mat_to_axis_angle(p) for p in poses_pred
            ])
            mesh_gt_tpose = _smpl_verts(
                smpl, np.zeros_like(poses_gt), shapes_gt_tiled
            )
            mesh_pred_tpose = _smpl_verts(
                smpl, np.zeros_like(poses_pred_aa), shapes_pred
            )
            errors_mesh_tpose = M.compute_error_verts(
                mesh_gt_tpose[vis], mesh_pred_tpose[vis]
            )
            mesh_gt = _smpl_verts(smpl, poses_gt, shapes_gt_tiled)
            mesh_pred = _smpl_verts(smpl, poses_pred_aa, shapes_pred)
            errors_mesh_posed = M.compute_error_verts(
                mesh_gt[vis], mesh_pred[vis]
            )
        else:
            errors_mesh_posed, errors_mesh_tpose = -1, -1

        errors_joints, errors_joints_pa = M.compute_error_3d(
            gt3ds=joints_gt, preds=joints_pred, vis=vis
        )
        errors_dict.update({
            "accel_error": errors_accel,
            "mesh_posed": errors_mesh_posed,
            "mesh_tpose": errors_mesh_tpose,
            "joints": errors_joints,
            "joints_pa": errors_joints_pa,
        })
    return errors_dict


@torch.inference_mode()
def _smpl_verts(smpl, poses_aa: np.ndarray, shapes: np.ndarray):
    """Batched SMPL vertex decode on the SmplModel's device, in f32
    (replaces the reference's per-call TF session, eval.py:68-90)."""
    dev = smpl.v_template.device
    # Copies: the record's arrays are read-only views of its bytes.
    beta = torch.tensor(np.asarray(shapes, np.float32), device=dev)
    theta = torch.tensor(
        np.asarray(poses_aa, np.float32).reshape(len(shapes), 72), device=dev)
    return smpl_forward(smpl, beta, theta).verts.cpu().numpy()


def _phis(data) -> np.ndarray:
    """The record's phis as a writable array (the decoded ones are views
    of the record's bytes, which torch will not wrap)."""
    return np.array(data["phis"], np.float32)


def _normalised_images(data) -> np.ndarray:
    """The record's decoded uint8 frames -> [-1, 1] f32, as the reference."""
    return np.stack([
        ((im / 255.0) - 0.5) * 2 for im in data["images"]
    ]).astype(np.float32)


class Evaluator:
    """Runs the metric table over test tfrecords."""

    def __init__(
        self,
        predictor,
        output_dir: str,
        pred_mode: str = "pred",
        smpl=None,
        model_tag: str = "model",
        device_metrics: bool = False,
    ):
        self.predictor = predictor
        self.output_dir = output_dir
        self.pred_mode = pred_mode
        self.smpl = smpl if smpl is not None else predictor.smpl
        # The cache key holds the model identity and the window length, as
        # the reference's path schema (prediction.py:22-102), so re-running
        # into the same out_dir with another checkpoint or T cannot return
        # stale predictions.
        self.model_tag = f"{model_tag}_T{predictor.seq_length}"
        # device_metrics: compute the per-tube error dict on the device and
        # fetch only scalars. The per-tube prediction pkl cache is skipped
        # in this mode (it would force the fetch); the errors cache still
        # makes re-runs resume.
        self.device_metrics = device_metrics
        if device_metrics:
            self._device_errors = make_compute_errors_device(self.smpl)
        os.makedirs(output_dir, exist_ok=True)

    def _cache_path(self, kind, dataset, record_name, person_id):
        d = os.path.join(self.output_dir, kind, self.model_tag, dataset)
        os.makedirs(d, exist_ok=True)
        return os.path.join(
            d, f"{record_name}_person{person_id}_{self.pred_mode}.pkl"
        )

    def predict_tube(self, dataset, record_name, person_id, data):
        """Load-or-compute predictions for one person tube
        (prediction.py:119-165), as host numpy arrays."""
        cache = self._cache_path("preds", dataset, record_name, person_id)
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        if data.get("phis") is not None:
            preds = self.predictor.predict_all_images(_phis(data))
        else:
            preds = self.predictor.predict_all_images(_normalised_images(data))
        with open(cache, "wb") as f:
            pickle.dump(preds, f)
        return preds

    def eval_tube(
        self, dataset, record_name, person_id, data,
        has_3d: bool, compute_mesh: bool,
    ):
        """test_sequence (eval.py:196-243) with the eval pkl cache."""
        eval_path = self._cache_path(
            "errors", dataset, record_name, person_id
        )
        if os.path.exists(eval_path):
            with open(eval_path, "rb") as f:
                return pickle.load(f)

        if self.device_metrics:
            errors = self._eval_tube_device(
                data, has_3d=has_3d, compute_mesh=compute_mesh
            )
            with open(eval_path, "wb") as f:
                pickle.dump(errors, f)
            return errors

        preds = self.predict_tube(dataset, record_name, person_id, data)
        n = data["N"]
        # kp errors are in pixels at the crop resolution; test records
        # store 224 crops (eval.py:211 normalizes the same way).
        img_size = (
            data["images"][0].shape[0] if data.get("images") else 224
        )
        errors = compute_errors_batched(
            kps_gt=np.asarray(data["kps"], np.float64)[:n],
            kps_pred=preds["kps"][:n],
            joints_gt=np.asarray(data["gt3ds"], np.float64)[:n],
            joints_pred=preds["joints"][:n, :14],
            poses_gt=np.asarray(data["poses"]).reshape(n, 72),
            poses_pred=preds["poses"][:n],
            shape_gt=np.asarray(data["shape"]),
            shapes_pred=preds["shapes"][:n],
            img_size=img_size,
            has_3d=has_3d,
            compute_mesh=compute_mesh,
            smpl=self.smpl,
        )
        with open(eval_path, "wb") as f:
            pickle.dump(errors, f)
        return errors

    def _eval_tube_device(self, data, has_3d: bool, compute_mesh: bool):
        """eval_tube's compute on the device: the predictions stay there,
        the error dict is computed there, and only its scalars are fetched
        (one copy). The tube is passed at its real length."""
        if data.get("phis") is not None:
            preds = self.predictor.predict_all_images(
                _phis(data), as_numpy=False
            )
        else:
            preds = self.predictor.predict_all_images(
                _normalised_images(data), as_numpy=False
            )
        n = data["N"]
        img_size = (
            data["images"][0].shape[0] if data.get("images") else 224
        )
        dev = preds["kps"].device

        def labels(a):
            # A copy: the record's arrays are read-only views of its bytes.
            return torch.tensor(np.asarray(a, np.float32)[:n], device=dev)

        kw = {}
        if has_3d:
            kw = dict(
                joints_gt=labels(data["gt3ds"]),
                poses_gt=labels(np.asarray(data["poses"]).reshape(n, 72)),
                shape_gt=torch.tensor(
                    np.asarray(data["shape"], np.float32), device=dev),
                shapes_pred=preds["shapes"][:n],
                poses_pred=preds["poses"][:n],
            )
        errors = self._device_errors(
            kps_gt=labels(data["kps"]),
            kps_pred=preds["kps"][:n],
            joints_pred=preds["joints"][:n, :14],
            num_frames=n,
            img_size=img_size,
            has_3d=has_3d,
            min_visible=6,
            compute_mesh=compute_mesh,
            **kw,
        )
        values = torch.stack(list(errors.values())).cpu().tolist()
        return dict(zip(errors, values))

    def eval_dataset(
        self,
        dataset: str,
        tf_dir: str,
        split: str = "test",
        max_records: Optional[int] = None,
    ) -> Dict[str, List]:
        """All test records of one dataset (eval.py:391-431)."""
        pattern = os.path.join(tf_dir, dataset, split, "*.tfrecord")
        files = sorted(glob.glob(pattern))
        if dataset == "h36m":
            # h36m evaluates only the cam03 records (eval.py:403-408).
            cam03 = [f for f in files if "camera03" in f or "cam03" in f]
            files = cam03 if cam03 else files
        if max_records:
            files = files[:max_records]

        # 3D supervision exists for h36m and 3dpw; mesh error only for
        # 3dpw test (eval.py:464-470).
        has_3d = dataset in ("h36m", "3dpw")
        compute_mesh = dataset == "3dpw" and split == "test"

        all_errors: Dict[str, List] = {}
        for path in files:
            record_name = os.path.splitext(os.path.basename(path))[0]
            for person_id, serialized in enumerate(read_tfrecord(path)):
                data = read_test_example(serialized)
                errors = self.eval_tube(
                    dataset, record_name, person_id, data,
                    has_3d=has_3d, compute_mesh=compute_mesh,
                )
                for k, v in errors.items():
                    if isinstance(v, (int, float)) and v == -1:
                        continue
                    all_errors.setdefault(k, []).append(v)
        return all_errors

    def run(
        self,
        tf_dir: str,
        datasets: List[str],
        split: str = "test",
        max_records: Optional[int] = None,
    ) -> Dict[str, Dict[str, float]]:
        """Full evaluation -> {dataset: {metric: value}} + results JSON."""
        results = {}
        for dataset in datasets:
            errors = self.eval_dataset(
                dataset, tf_dir, split, max_records
            )
            M.mean_of_dict_values(errors)
            results[dataset] = errors
            print_summary(dataset, errors)

        out_path = os.path.join(
            self.output_dir,
            f"results_{split}_{self.pred_mode}_{'-'.join(datasets)}.json",
        )
        with open(out_path, "w") as f:
            json.dump(results, f, indent=4, sort_keys=True)
        return results

    def run_const(
        self,
        tf_dir: str,
        datasets: List[str],
        split: str = "test",
        delta_ts=(-5, 5),
        max_records: Optional[int] = None,
    ) -> Dict[str, Dict[str, float]]:
        """Hallucination-dynamics table: +-dt predictions vs the
        constant-pose baseline, per dataset (test_sequence_const,
        eval.py:246-327), exposed from the CLI via --test_const."""
        results: Dict[str, Dict[str, float]] = {}
        for dataset in datasets:
            pattern = os.path.join(tf_dir, dataset, split, "*.tfrecord")
            files = sorted(glob.glob(pattern))
            if max_records:
                files = files[:max_records]
            agg: Dict[str, List] = {}
            for path in files:
                record_name = os.path.splitext(os.path.basename(path))[0]
                for person_id, serialized in enumerate(
                    read_tfrecord(path)
                ):
                    data = read_test_example(serialized)
                    preds = self.predict_tube(
                        dataset, record_name, person_id, data
                    )
                    errors = test_sequence_const(
                        data, preds, delta_ts=delta_ts
                    )
                    for k, v in errors.items():
                        agg.setdefault(k, []).append(v)
            M.mean_of_dict_values(agg)
            results[dataset] = agg
            print(f"[{dataset}] const-baseline comparison:")
            for k in sorted(agg):
                print(f"  {k}: {agg[k]:.5f}")

        out_path = os.path.join(
            self.output_dir,
            f"results_const_{split}_{self.pred_mode}_"
            f"{'-'.join(datasets)}.json",
        )
        with open(out_path, "w") as f:
            json.dump(results, f, indent=4, sort_keys=True)
        return results


def test_sequence_const(
    data,
    preds: Dict[str, np.ndarray],
    delta_ts=(-5, 5),
    min_visible: int = 6,
) -> Dict[str, list]:
    """Hallucination dynamics test: compare +-dt predictions against the
    constant-pose baseline (predicting the present for every dt).

    Behavioral target: test_sequence_const (eval.py:246-327; the reference
    reads config.delta_t, an undefined flag; the delta values are taken
    explicitly here). Expects preds with '_delta' stacks (sorted dt order).

    Returns per-frame MPJPE lists for {dt: pred} and {dt: const}.
    """
    gt3ds = np.asarray(data["gt3ds"], np.float64)
    n = data["N"]
    joints_present = preds["joints"][:n, :14]
    joints_delta = preds["joints_delta"][:n, :, :14]  # (N, D, 14, 3)

    errors: Dict[str, list] = {}
    for di, dt in enumerate(sorted(d for d in delta_ts if d != 0)):
        # Prediction made at frame t for frame t+dt.
        if dt > 0:
            pred = joints_delta[:-dt, di]
            const = joints_present[:-dt]
            gt = gt3ds[dt:]
        else:
            pred = joints_delta[-dt:, di]
            const = joints_present[-dt:]
            gt = gt3ds[:dt]
        e_pred, e_pred_pa = M.compute_error_3d(gt, pred)
        e_const, e_const_pa = M.compute_error_3d(gt, const)
        errors[f"joints_dt{dt}"] = e_pred
        errors[f"joints_pa_dt{dt}"] = e_pred_pa
        errors[f"joints_const_dt{dt}"] = e_const
        errors[f"joints_pa_const_dt{dt}"] = e_const_pa
    return errors


_MODEL_CONFIG_KEYS = (
    "num_conv_layers", "delta_t_values", "predict_delta",
    "do_hallucinate", "do_hallucinate_preds", "use_hmr_only",
    "num_stage", "use_delta_from_pred", "feature_dim",
)


def restore_model_config(load_path: str) -> Dict[str, object]:
    """Re-apply the training run's architecture hyperparams at eval time.

    Looks for a params.json next to the checkpoint (the trainer writes one
    into model_dir) and returns the HmmrModel kwargs recorded there, so
    evaluating a non-default-architecture checkpoint builds the right
    model. Mirrors restore_config (eval.py:93-111), which applies all saved
    flags except batch/T/paths; only the architecture keys feed HmmrModel,
    so only those are returned.
    """
    search_dirs = []
    d = load_path if os.path.isdir(load_path) else os.path.dirname(load_path)
    while d and d not in search_dirs:
        search_dirs.append(d)
        if len(search_dirs) >= 2:
            break
        d = os.path.dirname(d)

    candidates: List[str] = []
    for d in search_dirs:
        exact = os.path.join(d, "params.json")
        if os.path.exists(exact):
            candidates.append(exact)
        candidates.extend(sorted(glob.glob(os.path.join(d, "*.json"))))

    for path in candidates:
        try:
            with open(path) as f:
                saved = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(saved, dict):
            continue
        kwargs = {k: saved[k] for k in _MODEL_CONFIG_KEYS if k in saved}
        if kwargs:
            if "delta_t_values" in kwargs:
                kwargs["delta_t_values"] = tuple(kwargs["delta_t_values"])
            print(f"Restored model config from {path}: {kwargs}")
            return kwargs
    return {}


def print_summary(dataset: str, errors: Dict[str, float]) -> None:
    """Metric table row (eval.py:330-350; column order of
    doc/eval.md:27-31)."""
    keys = ["accel_error", "kp", "kp_pa", "kp_pck", "joints",
            "joints_pa", "mesh_posed", "mesh_tpose"]
    header = " | ".join(f"{k:>11}" for k in keys)
    row = " | ".join(
        f"{errors[k]:>11.5f}" if k in errors else f"{-1:>11}"
        for k in keys
    )
    print(f"[{dataset}]")
    print(header)
    print(row)


def load_model_variables(load_path: str):
    """The flax variables tree of an npz checkpoint written by the JAX
    package's ``save_checkpoint``; a Trainer checkpoint's model variables
    (``params_e``) are taken from it. Other formats need JAX to read."""
    from human_dynamics_tpu_torch.utils.weights import load_jax_npz

    if not load_path.endswith(".npz"):
        raise ValueError(
            f"--load_path {load_path!r}: the port reads .npz checkpoints "
            "only; an orbax directory, a pkl or a TF checkpoint needs JAX to "
            "read. Convert it once with the JAX package: "
            "save_checkpoint('ckpt.npz', load_variables(path)) from "
            "human_dynamics_tpu.utils.checkpoint"
        )
    tree = load_jax_npz(load_path)
    return tree["params_e"] if "params_e" in tree else tree


def main(argv=None):
    import argparse

    from human_dynamics_tpu_torch.core.smpl import load_smpl_model
    from human_dynamics_tpu_torch.infer.predictor import HmmrPredictor
    from human_dynamics_tpu_torch.models.hmmr import HmmrModel
    from human_dynamics_tpu_torch.utils.weights import load_jax_variables

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tf_dir", required=True)
    parser.add_argument("--load_path", required=True,
                        help="an npz checkpoint of the JAX package")
    parser.add_argument("--smpl_model_path", required=True,
                        help="an SMPL npz (convert_smpl_pkl)")
    parser.add_argument("--datasets", nargs="+",
                        default=["3dpw", "h36m", "penn_action"])
    parser.add_argument("--split", default="test")
    parser.add_argument("--out_dir", default="eval_output")
    parser.add_argument("--pred_mode", default="pred")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--T", type=int, default=20)
    parser.add_argument("--precomputed_phi", action="store_true")
    parser.add_argument("--fast", action="store_true",
                        help="fused SMPL kernel + bf16 encoder")
    parser.add_argument(
        "--test_const", action="store_true",
        help="run the hallucination-vs-constant-baseline table "
             "(test_sequence_const) instead of the metric table")
    parser.add_argument(
        "--no_restore_config", action="store_true",
        help="do not re-apply the checkpoint's params.json architecture")
    parser.add_argument(
        "--device_metrics", action="store_true",
        help="compute per-tube error dicts on the device and fetch only "
             "scalars (eval/metrics_device.py)")
    parser.add_argument(
        "--device", default=None,
        help="torch device; the CUDA device by default, 'cpu' to run on "
             "the CPU")
    args = parser.parse_args(argv)

    variables = load_model_variables(args.load_path)
    model_kwargs = (
        {} if args.no_restore_config
        else restore_model_config(args.load_path)
    )
    model = HmmrModel(
        include_resnet=not args.precomputed_phi, device="meta",
        **model_kwargs
    ).to_empty(device="cpu")
    load_jax_variables(model, variables)
    smpl = load_smpl_model(args.smpl_model_path)
    predictor = HmmrPredictor(
        model, None, smpl,
        batch_size=args.batch_size, seq_length=args.T,
        pred_mode=args.pred_mode,
        use_fused_smpl=args.fast, bf16_encoder=args.fast,
        device=args.device,
    )
    tag = os.path.basename(os.path.normpath(args.load_path))
    evaluator = Evaluator(
        predictor, args.out_dir, args.pred_mode, model_tag=tag,
        device_metrics=args.device_metrics,
    )
    if args.test_const:
        return evaluator.run_const(args.tf_dir, args.datasets, args.split)
    return evaluator.run(args.tf_dir, args.datasets, args.split)


if __name__ == "__main__":
    main()
