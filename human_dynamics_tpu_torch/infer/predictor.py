"""Windowed HMMR inference: a clip of frames (or features) -> per-frame SMPL.

Counterpart of ``human_dynamics_tpu/infer/predictor.py``, inference only:

- Image mode runs ResNet-50 once per frame, in chunks of ``encode_chunk``
  frames; raw uint8 frames are normalised on the device as x*(2/255)-1.
- The per-frame features are zero-padded by the window schedule and cut
  into windows of T frames, B windows per group, ``groups_per_step``
  groups per model call.
- Only each window's good centre frames are kept, before the SMPL decode.
- The present head and the delta heads are decoded in one stacked SMPL
  call; the delta heads are projected with the present camera.
- The windows are stitched back to (N, ...) per-frame outputs with keys
  cams/joints/kps/poses/shapes/verts/omegas, plus '*_delta' stacked
  (N, D, ...) over the sorted delta_t values.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from human_dynamics_tpu_torch.core.smpl import SmplModel
from human_dynamics_tpu_torch.infer.window import WindowSchedule
from human_dynamics_tpu_torch.models.hmmr import HmmrModel
from human_dynamics_tpu_torch.models.omega import compute_smpl, split_omega
from human_dynamics_tpu_torch.ops.smpl_cuda import prepare_fused_constants

_KEYS = ("cams", "joints", "kps", "poses", "shapes", "verts", "omegas")


class HmmrPredictor:
    """Holds (model, smpl) on one device and runs windowed prediction.

    Args:
        model: HmmrModel (``include_resnet`` selects image input).
        state: a ``state_dict`` to load into ``model``, or None to keep
            the model's own weights.
        smpl: SmplModel used to decode omegas.
        batch_size: windows per group (B).
        seq_length: window length (T); at least the model's fov.
        pred_mode: 'pred' (temporal encoder) or 'hal' (hallucinator).
        use_fused_smpl: decode with the fused blend+skin op (the CUDA
            kernel on a GPU).
        groups_per_step: window groups per model call (bounds memory).
        encode_chunk: frames per ResNet call in image mode.
        device: where to run; None keeps the model's device. The model
            and the SMPL constants are moved there.
    """

    def __init__(
        self,
        model: HmmrModel,
        state: Optional[Mapping[str, torch.Tensor]],
        smpl: SmplModel,
        batch_size: int = 8,
        seq_length: int = 20,
        pred_mode: str = "pred",
        use_fused_smpl: bool = False,
        groups_per_step: int = 8,
        encode_chunk: int = 120,
        device=None,
    ):
        if pred_mode not in ("pred", "hal"):
            raise ValueError(f"Pred mode {pred_mode!r} not recognized")
        if seq_length < model.fov:
            raise ValueError(
                f"seq_length={seq_length} is below the temporal "
                f"fov={model.fov}; windows would contribute no frames"
            )
        if groups_per_step < 1 or encode_chunk < 1:
            raise ValueError("groups_per_step and encode_chunk must be >= 1")
        if state is not None:
            model.load_state_dict(state)
        if device is None:
            device = model.mean_param.device
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.smpl = smpl.to(self.device)
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.pred_mode = pred_mode
        self.use_fused_smpl = use_fused_smpl
        self.groups_per_step = groups_per_step
        self.encode_chunk = encode_chunk
        self.delta_ts = tuple(sorted(model.delta_t_values))
        self.fused_constants = (
            prepare_fused_constants(self.smpl) if use_fused_smpl else None
        )

    # ------------------------------------------------------------------
    # Feature extraction (image mode)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_frames(self, images) -> torch.Tensor:
        """(N, H, W, 3) frames -> (N, 2048) phi on the device.

        uint8 frames are raw video bytes, normalised on the device as
        x*(2/255)-1; anything else is taken as [-1, 1] floats.
        """
        images = torch.as_tensor(images, device=self.device)
        phis = []
        for i in range(0, len(images), self.encode_chunk):
            chunk = images[i:i + self.encode_chunk]
            if chunk.dtype == torch.uint8:
                chunk = chunk.to(torch.float32) * (2.0 / 255.0) - 1.0
            else:
                chunk = chunk.to(torch.float32)
            phis.append(self.model.encode_images(chunk[None])[0])
        return torch.cat(phis)

    # ------------------------------------------------------------------
    # Windowed prediction
    # ------------------------------------------------------------------

    def _run_groups(self, phi_padded: torch.Tensor, ids: torch.Tensor,
                    margin: int, g: int) -> Dict[str, torch.Tensor]:
        """Window groups ``ids`` (S,) -> dict of (S*B, g, ...) outputs."""
        b, t = self.batch_size, self.seq_length
        dev = phi_padded.device
        # Window w starts at frame w*g of the padded buffer.
        win = (ids[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
        idx = win[:, None] * g + torch.arange(t, device=dev)
        out = self.model(phi_padded[idx])               # (S*B, T, C) windows

        if self.pred_mode == "hal":
            present, deltas = out.omega_hal, out.omegas_hal_delta
        else:
            present, deltas = out.omega_pred, out.omegas_delta

        # Keep only the full-fov centre frames BEFORE the SMPL decode.
        present = present[:, margin:margin + g]
        heads = [present] + [
            deltas[dt][:, margin:margin + g]
            for dt in self.delta_ts if dt in deltas
        ]
        stacked = torch.stack(heads)                    # (H, S*B, g, 85)
        cams_present = split_omega(present)[0]
        # Every head is projected with the PRESENT camera.
        cams_all = cams_present[None].expand(stacked.shape[:-1] + (3,))
        sm = compute_smpl(
            self.smpl, stacked, use_optcam=False, cams_override=cams_all,
            fused=self.use_fused_smpl, fused_constants=self.fused_constants,
        )
        per_key = {
            "cams": cams_all,
            "joints": sm.joints,
            "kps": sm.kps,
            "poses": sm.poses_rot,
            "shapes": split_omega(stacked)[2],
            "verts": sm.verts,
            "omegas": stacked,
        }
        result = {k: v[0] for k, v in per_key.items()}
        if len(heads) > 1:
            # (D, S*B, g, ...) -> (S*B, g, D, ...).
            for k, v in per_key.items():
                result[k + "_delta"] = torch.movedim(v[1:], 0, 2)
        return result

    @torch.inference_mode()
    def predict_all_images(
        self, frames, phi=None, as_numpy: bool = True
    ) -> Dict[str, np.ndarray]:
        """Predict a whole clip with sliding windows.

        Args:
            frames: (N, H, W, 3) frames (image mode; uint8 or [-1, 1]
                floats) or (N, 2048) phi when the model has no resnet;
                numpy arrays or tensors.
            phi: optionally precomputed (N, 2048) features.
            as_numpy: fetch the results to host numpy arrays; otherwise
                return tensors on the device.

        Returns:
            dict of (N, ...) arrays; see the module docstring.
        """
        if phi is None:
            if getattr(frames, "ndim", None) == 2:
                phi = frames
            else:
                phi = self.encode_frames(frames)
        phi = torch.as_tensor(phi, dtype=torch.float32, device=self.device)
        n = len(phi)

        sched = WindowSchedule(
            num_frames=n,
            batch_size=self.batch_size,
            seq_length=self.seq_length,
            fov=self.model.fov,
        )
        phi_padded = F.pad(phi, (0, 0, sched.margin, sched.num_fill))
        ids = torch.arange(sched.count, device=self.device)
        steps = [
            self._run_groups(phi_padded, ids[i:i + self.groups_per_step],
                             sched.margin, sched.good_frames)
            for i in range(0, sched.count, self.groups_per_step)
        ]
        out = {
            k: torch.cat([s[k] for s in steps]).flatten(0, 1)[:n]
            for k in steps[0]
        }
        if as_numpy:
            out = {k: v.cpu().numpy() for k, v in out.items()}
        return out
