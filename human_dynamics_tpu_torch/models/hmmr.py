"""The full HMMR model: phi or images -> omegas per head.

Counterpart of ``human_dynamics_tpu/models/hmmr.py``. The present IEF
regressor (``single_view_ief``) and each delta regressor are shared by the
temporal-encoder branch and the hallucinator branch. The delta heads
start from the present omega, regress the 72 pose values, and then get
the camera [1, 0, 0] and the starting beta re-attached.

``forward(inputs, train=True, generator=g)`` is training: every IEF call
of every head and branch applies dropout with masks from ``g``, and on
images the ResNet's BatchNorm normalises with the batch's statistics
(unless ``freeze_bn_stats``); its moving averages advance only inside
``models.resnet.updating_batch_stats``. ``mesh`` makes that step this
rank's part of a sharded one: the BatchNorm statistics are those of every
rank's frames and the dropout masks those of the global batch
(``models.ief.RowBlock``). On a (data, time) mesh the rank holds a block of
each tube's frames, and the temporal encoder is the halo one
(``parallel.halo.temporal_encoder_sharded``: each conv takes its
neighbours' edge frames, each GroupNorm the whole clip's statistics); the
IEF heads and the hallucinator are per frame and stay local. On a (data,
model) mesh every model rank holds the same rows, and the wide layers are
``parallel.tp``'s.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from human_dynamics_tpu_torch.models.hallucinator import Hallucinator
from human_dynamics_tpu_torch.models.ief import (
    IefRegressor,
    RowBlock,
    ief_refine,
)
from human_dynamics_tpu_torch.models.omega import OMEGA_DIM
from human_dynamics_tpu_torch.models.resnet import ResNetV2_50
from human_dynamics_tpu_torch.models.temporal import TemporalEncoderFC2GN
from human_dynamics_tpu_torch.parallel.halo import temporal_encoder_sharded
from human_dynamics_tpu_torch.parallel.mesh import DATA_AXIS, TIME_AXIS


def default_mean_omega() -> np.ndarray:
    """Mean Omega without the neutral-SMPL mean file: cam [0.9, 0, 0],
    global rotation pi about x, zeros elsewhere."""
    mean = np.zeros((1, OMEGA_DIM), np.float32)
    mean[0, 0] = 0.9
    mean[0, 3] = np.pi
    return mean


def _h5_dataset(group, name):
    """A dataset of an h5 file, at the root or under a '/data' group (the
    deepdish layout)."""
    if name in group:
        return np.asarray(group[name])
    if "data" in group and name in group["data"]:
        return np.asarray(group["data"][name])
    raise KeyError(
        f"mean-omega file is missing dataset '{name}' "
        f"(available: {list(group.keys())})"
    )


def load_mean_omega(path: str) -> np.ndarray:
    """Mean Omega (1, 85) from ``neutral_smpl_meanwjoints.h5`` (h5py, read
    lazily) or an npz with the same 'pose' and 'shape' arrays, with the
    reference's overrides: cam [0.9, 0, 0], global rotation zeroed and then
    pose[0] = pi."""
    if path.endswith((".h5", ".hdf5")):
        try:
            import h5py
        except ImportError as exc:
            raise ImportError(
                f"{path!r}: reading an h5 mean-omega file needs h5py, which "
                "is not installed; install it, or convert the file to an "
                "npz with 'pose' and 'shape' arrays"
            ) from exc
        with h5py.File(path, "r") as f:
            pose = _h5_dataset(f, "pose").reshape(72).astype(np.float64)
            shape = _h5_dataset(f, "shape").reshape(10).astype(np.float64)
    else:
        with np.load(path) as data:
            pose = np.asarray(data["pose"]).reshape(72).astype(np.float64)
            shape = np.asarray(data["shape"]).reshape(10).astype(np.float64)
    cams = np.array([0.9, 0.0, 0.0])
    pose[:3] = 0.0
    pose[0] = np.pi
    return np.hstack((cams, pose, shape))[None].astype(np.float32)


def resolve_mean_omega(path: Optional[str]) -> np.ndarray:
    """load_mean_omega when `path` exists, else default_mean_omega."""
    if path and os.path.exists(path):
        return load_mean_omega(path)
    return default_mean_omega()


def _delta_key(dt: int) -> str:
    return f"past{abs(dt)}" if dt < 0 else f"future{dt}"


class HmmrOutputs(NamedTuple):
    """All heads for one (B, T) batch of windows.

    omega_pred (B, T, 85); omegas_delta {dt: (B, T, 85)} with camera
    [1, 0, 0]; omega_hal (B, T, 85) or None; omegas_hal_delta {dt: ...};
    movie_strip, hal_strip (or None) and phi, all (B, T, feature_dim).
    """

    omega_pred: torch.Tensor
    omegas_delta: Dict[int, torch.Tensor]
    omega_hal: Optional[torch.Tensor]
    omegas_hal_delta: Dict[int, torch.Tensor]
    movie_strip: torch.Tensor
    hal_strip: Optional[torch.Tensor]
    phi: torch.Tensor


class HmmrModel(nn.Module):
    """phi (B, T, C) or images (B, T, H, W, 3) -> HmmrOutputs."""

    def __init__(
        self,
        num_conv_layers: int = 3,
        delta_t_values: Sequence[int] = (-5, 5),
        predict_delta: bool = True,
        do_hallucinate: bool = True,
        do_hallucinate_preds: bool = False,
        use_hmr_only: bool = False,
        num_stage: int = 3,
        use_delta_from_pred: bool = True,
        include_resnet: bool = False,
        remat_resnet: bool = False,
        freeze_bn_stats: bool = False,
        feature_dim: int = 2048,
        mean_omega_init: Optional[np.ndarray] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_conv_layers = num_conv_layers
        self.delta_t_values = tuple(delta_t_values)
        self.predict_delta = predict_delta
        self.do_hallucinate = do_hallucinate
        self.do_hallucinate_preds = do_hallucinate_preds
        self.use_hmr_only = use_hmr_only
        self.num_stage = num_stage
        self.use_delta_from_pred = use_delta_from_pred
        self.include_resnet = include_resnet
        # Inference-mode BatchNorm in training too (fine-tuning from a
        # pretrained trunk with its statistics fixed).
        self.freeze_bn_stats = freeze_bn_stats
        self.feature_dim = feature_dim

        if include_resnet:
            self.resnet_v2_50 = ResNetV2_50(device=device, generator=generator,
                                            remat=remat_resnet)
        if not use_hmr_only:
            self.temporal_encoder = TemporalEncoderFC2GN(
                num_layers=num_conv_layers, num_filter=feature_dim,
                device=device, generator=generator,
            )
        if do_hallucinate:
            self.hallucinator = Hallucinator(
                feature_dim, device=device, generator=generator
            )
        self.single_view_ief = IefRegressor(
            feature_dim + OMEGA_DIM, OMEGA_DIM, device=device,
            generator=generator,
        )
        self.ief_delta = nn.ModuleDict()
        if predict_delta:
            for dt in self.delta_t_values:
                if dt != 0:
                    self.ief_delta[_delta_key(dt)] = IefRegressor(
                        feature_dim + 72, 72, device=device,
                        generator=generator,
                    )
        mean = (
            default_mean_omega() if mean_omega_init is None
            else np.asarray(mean_omega_init, np.float32).reshape(1, OMEGA_DIM)
        )
        self.mean_param = nn.Parameter(torch.as_tensor(mean, device=device))

    @property
    def fov(self) -> int:
        """Temporal receptive field."""
        return 4 * self.num_conv_layers + 1

    def encode_images(self, images: torch.Tensor, train: bool = False,
                      mesh=None) -> torch.Tensor:
        """images (B, T, H, W, 3) in [-1, 1] -> phi (B, T, 2048)."""
        b, t = images.shape[:2]
        phi = self.resnet_v2_50(images.reshape((b * t,) + images.shape[2:]),
                                train=train and not self.freeze_bn_stats,
                                mesh=mesh)
        return phi.reshape(b, t, -1)

    def _pred_heads(
        self, features: torch.Tensor, with_deltas: bool, train: bool,
        generator: Optional[torch.Generator],
    ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        b, t, d = features.shape
        phi = features.reshape(b * t, d)
        omega_mean = self.mean_param.expand(b * t, OMEGA_DIM)
        present = ief_refine(
            self.single_view_ief, phi, omega_mean, self.num_stage, train,
            generator,
        )
        deltas: Dict[int, torch.Tensor] = {}
        if with_deltas:
            start = present if self.use_delta_from_pred else omega_mean
            beta = start[:, -10:]
            n = b * t
            cam_fixed = torch.zeros(n, 3, dtype=features.dtype,
                                    device=features.device)
            cam_fixed[:, 0] = 1.0
            for dt in self.delta_t_values:
                if dt == 0:
                    continue
                pose72 = ief_refine(
                    self.ief_delta[_delta_key(dt)], phi, start[:, 3:75],
                    self.num_stage, train, generator,
                )
                deltas[dt] = torch.cat(
                    [cam_fixed, pose72, beta], dim=1
                ).reshape(b, t, OMEGA_DIM)
        return present.reshape(b, t, OMEGA_DIM), deltas

    def forward(self, inputs: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mesh=None) -> HmmrOutputs:
        """``train`` turns the IEF dropout on, with masks drawn from
        ``generator``, and the ResNet's batch-statistics BatchNorm; with a
        ``mesh`` both span the global batch, and a ``time`` axis shards
        the temporal encoder."""
        time_sharded = mesh is not None and TIME_AXIS in mesh.shape
        if mesh is not None and generator is not None:
            generator = RowBlock(
                generator, mesh.index(DATA_AXIS), mesh.shape[DATA_AXIS],
                inputs.shape[1], mesh.coords.get(TIME_AXIS, 0),
                mesh.shape.get(TIME_AXIS, 1))
        if inputs.dim() == 5:
            if not self.include_resnet:
                raise ValueError("Model built without resnet but got image input")
            phi = self.encode_images(inputs, train, mesh)
        else:
            phi = inputs

        if self.use_hmr_only:
            movie_strip = phi
        elif time_sharded:
            movie_strip = temporal_encoder_sharded(self.temporal_encoder, phi,
                                                   mesh, TIME_AXIS)
        else:
            movie_strip = self.temporal_encoder(phi)
        omega_pred, omegas_delta = self._pred_heads(
            movie_strip, self.predict_delta, train, generator
        )
        omega_hal, omegas_hal_delta, hal_strip = None, {}, None
        if self.do_hallucinate:
            hal_strip = self.hallucinator(phi)
            omega_hal, omegas_hal_delta = self._pred_heads(
                hal_strip, self.predict_delta and self.do_hallucinate_preds,
                train, generator,
            )
        return HmmrOutputs(
            omega_pred=omega_pred,
            omegas_delta=omegas_delta,
            omega_hal=omega_hal,
            omegas_hal_delta=omegas_hal_delta,
            movie_strip=movie_strip,
            hal_strip=hal_strip,
            phi=phi,
        )
