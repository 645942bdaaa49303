"""Experiment configuration.

A copy of ``human_dynamics_tpu/utils/config.py`` (the port imports nothing
of the JAX package). The fields are the JAX ``Config``'s, name for name and
default for default, so a params.json written by either package reads in
the other. The device a run uses is not a field: ``train/main.py`` takes it
as ``--device``.

- ``model_dir`` auto-naming encodes the non-default hyperparameters, so
  runs remain self-describing.
- ``save`` dumps params.json; ``check_resume_config`` diffs a resumed
  config against the saved one and ``prepare_dirs`` raises on a mismatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime
from typing import List, Optional, Tuple

# Keys ignored when diffing a resumed config (config.py:168).
_RESUME_IGNORE = {
    "load_path", "log_img_step", "pretrained_model_path", "model_dir",
    "data_dir", "log_dir", "log_step", "save_step",
}


@dataclasses.dataclass
class Config:
    # Paths.
    smpl_model_path: str = "models/smpl_model.npz"
    smpl_mean_path: str = "models/smpl_mean_params.npz"
    load_path: Optional[str] = None
    data_dir: Optional[str] = None
    log_dir: str = "logs"
    model_dir: Optional[str] = None
    pretrained_model_path: Optional[str] = None

    # Data/model dims (config.py:43-47).
    batch_size: int = 8
    T: int = 20
    num_kps: int = 25
    num_conv_layers: int = 3
    delta_t_values: Tuple[int, ...] = (-5, 5)
    img_size: int = 224
    num_stage: int = 3
    max_iteration: int = 5_000_000
    feature_dim: int = 2048

    # Datasets (config.py:54-57).
    datasets: Tuple[str, ...] = ("h36m", "penn_action", "insta_variety")
    mocap_datasets: Tuple[str, ...] = ("CMU", "H3.6", "jointLim")

    # Loss weights (config.py:79-86).
    e_lw_smpl: float = 60.0
    e_lw_joints: float = 60.0
    e_lw_const: float = 1.0
    e_lw_kp: float = 60.0
    e_lw_pose: float = 1.0
    e_lw_shape: float = 1.0
    d_lw_pose: float = 1.0
    e_lw_hallucinate: float = 1.0

    # Optimization (config.py:88-91).
    e_lr: float = 1e-5
    d_lr: float = 1e-4
    e_wd: float = 1e-4
    d_wd: float = 1e-4

    # Training setup flags (config.py:94-119).
    use_3d_label: bool = True
    freeze_phi: bool = True
    use_hmr_ief_init: bool = True
    predict_delta: bool = True
    precomputed_phi: bool = True
    use_delta_from_pred: bool = True
    use_hmr_only: bool = False
    split_balanced: bool = True
    do_hallucinate: bool = True
    do_hallucinate_preds: bool = False
    mosh_ignore: bool = False

    # Augmentation jitter (config.py:122-128).
    trans_max: int = 20
    delta_trans_max: int = 20
    scale_max: float = 0.3
    delta_scale_max: float = 0.3
    rotate_max: float = 0.0
    delta_rotate_max: float = 5.0

    # Additions with no reference equivalent.
    seed: int = 1
    data_mesh_size: int = 1        # data-parallel shards (1 = one device)
    # Mixed-precision training: the HMMR forward/backward (resnet,
    # temporal convs, IEF, hallucinator) runs in bf16; SMPL decode,
    # losses, the discriminator, params, and optimizer state stay fp32.
    use_bfloat16: bool = False
    use_fused_smpl: bool = False   # the fused blend+skin kernel for SMPL
    # Image-mode training options (not in the port's phi-mode slice):
    # recompute resnet bottleneck units on the backward pass; freeze
    # BatchNorm statistics while fine-tuning; freeze the first N resnet
    # stages (1 = root conv, 2 = +block1, ... 5 = everything but
    # postnorm; 0 = off; ignored when freeze_phi freezes the trunk).
    remat_resnet: bool = False
    freeze_bn_stats: bool = False
    freeze_resnet_stages: int = 0
    log_img_step: int = 5000       # rendered-prediction summary period
    log_img_count: int = 10        # frames per rendered summary strip
    log_step: int = 100
    save_step: int = 5000
    # Checkpoints carry only params_e/params_d/step (no Adam moments):
    # ~1/3 of the state bytes; restoring from one resets the moments.
    save_params_only: bool = False

    # ------------------------------------------------------------------

    @property
    def fov(self) -> int:
        return 4 * self.num_conv_layers + 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k not in field_names:
                continue
            if isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    def save(self, path: Optional[str] = None) -> str:
        """Dump params.json into model_dir (config.py:337-348)."""
        if path is None:
            assert self.model_dir, "model_dir not set"
            path = os.path.join(self.model_dir, "params.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def check_resume_config(self, saved: "Config") -> List[str]:
        """Diff against a previously saved config; returns changed keys
        (config.py:161-193)."""
        diffs = []
        for f in dataclasses.fields(self):
            if f.name in _RESUME_IGNORE:
                continue
            if getattr(self, f.name) != getattr(saved, f.name):
                diffs.append(f.name)
        return diffs

    def run_name(self) -> str:
        """Hyperparameter-encoding run directory name (config.py:198-329
        in spirit: default-diffs only)."""
        default = Config()
        prefix = []
        if not self.use_hmr_only:
            prefix.append(f"AZ_FC2GN_{self.num_conv_layers}")
        else:
            prefix.append("HMR")
        if self.predict_delta:
            p = "pred-delta"
            if self.use_delta_from_pred:
                p += "-from-pred"
            p += "_".join(str(d) for d in self.delta_t_values)
            prefix.append(p)
        if self.do_hallucinate:
            prefix.append("hal-preds" if self.do_hallucinate_preds else "hal")
        if self.num_stage != default.num_stage:
            prefix.append(f"ief-stages{self.num_stage}")
        prefix.append(f"B{self.batch_size}")
        prefix.append(f"T{self.T}")
        if self.precomputed_phi:
            prefix.append("precomputed-phi")
        elif self.freeze_phi:
            prefix.append("freeze-phi")

        postfix = []
        if sorted(self.datasets) != sorted(default.datasets):
            postfix.append("-".join(sorted(self.datasets)))
        for name in ("e_lr", "d_lr", "e_lw_smpl", "e_lw_joints", "e_lw_kp",
                     "e_lw_shape", "e_lw_pose", "e_lw_hallucinate"):
            if getattr(self, name) != getattr(default, name):
                postfix.append(f"{name}{getattr(self, name):g}")
        postfix.append(f"const{self.e_lw_const:g}")
        if self.data_mesh_size != 1:
            postfix.append(f"dp{self.data_mesh_size}")
        if self.mosh_ignore:
            postfix.append("mosh_ignore")

        time_str = datetime.now().strftime("%b%d_%H%M")
        return "{}_{}_{}".format(
            "_".join(prefix), "_".join(postfix), time_str
        )

    def prepare_dirs(self) -> None:
        """Resolve model_dir (resume or fresh) and create directories
        (config.py:152-334)."""
        if self.load_path:
            if not os.path.exists(self.load_path):
                raise FileNotFoundError(self.load_path)
            param_path = os.path.join(self.load_path, "params.json")
            if os.path.exists(param_path):
                with open(param_path) as f:
                    saved = Config.from_json(f.read())
                diffs = self.check_resume_config(saved)
                if diffs:
                    raise ValueError(
                        f"Resumed config differs on {diffs}; refusing to "
                        "continue (config.py:190-193)."
                    )
            self.model_dir = self.load_path
        elif not self.model_dir:
            self.model_dir = os.path.join(self.log_dir, self.run_name())
        os.makedirs(self.model_dir, exist_ok=True)
