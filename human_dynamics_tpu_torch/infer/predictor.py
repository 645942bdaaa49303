"""Windowed HMMR inference: a clip of frames (or features) -> per-frame SMPL.

Counterpart of ``human_dynamics_tpu/infer/predictor.py``, inference only:

- Image mode runs ResNet-50 once per frame, in chunks of ``encode_chunk``
  frames; raw uint8 frames are normalised on the device as x*(2/255)-1,
  except with ``int8_root="u8"``, whose stem reads the bytes.
  The encoder is fp32, bf16 (``bf16_encoder``) or int8
  (``int8_encoder``, models/resnet_int8: static scales when
  ``int8_calibration`` frames are given, else dynamic ones; with static
  scales, ``int8_root`` and ``int8_stream`` pick the int8 stem and the
  blocks whose residual stream is int8).
- The per-frame features are zero-padded by the window schedule and cut
  into windows of T frames, B windows per group, ``groups_per_step``
  groups per model call; ``bf16_temporal`` runs that model (temporal
  encoder, IEF heads, hallucinator) in bf16 and casts the omegas back to
  f32.
- Only each window's good centre frames are kept, before the SMPL decode.
- The present head and the delta heads are decoded in one stacked SMPL
  call; the delta heads are projected with the present camera.
- The fp32 encoder and the fp32 window tail run without TF32, whatever
  the process's TF32 settings: they are the JAX package's parity path.
- The windows are stitched back to (N, ...) per-frame outputs with keys
  cams/joints/kps/poses/shapes/verts/omegas, plus '*_delta' stacked
  (N, D, ...) over the sorted delta_t values.
- ``predict_all_images_sharded`` splits the window groups over the ranks
  of a ``parallel.Mesh`` and gathers the results to every rank.
- Under ``torch.profiler``, ``encode_frames`` is the range "hmmr.encode"
  (``utils.logging.span``; every chunk) and the rest of
  ``predict_all_images`` is "hmmr.window", with "hmmr.smpl" inside it.
"""

from __future__ import annotations

import copy
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from human_dynamics_tpu_torch.core.smpl import SmplModel
from human_dynamics_tpu_torch.infer.window import WindowSchedule
from human_dynamics_tpu_torch.models.hmmr import HmmrModel
from human_dynamics_tpu_torch.models.omega import compute_smpl, split_omega
from human_dynamics_tpu_torch.models.resnet_int8 import (
    apply_int8,
    calibrate_int8_scales,
    kmajor_weights,
    prepare_int8_params,
    prepare_int8_static,
    run_int8_static,
)
from human_dynamics_tpu_torch.ops.smpl_cuda import prepare_fused_constants
from human_dynamics_tpu_torch.parallel.mesh import assemble, broadcast
from human_dynamics_tpu_torch.utils.logging import span
from human_dynamics_tpu_torch.utils.precision import full_fp32, to_bf16

_TWO_OVER_255 = float(np.float32(2.0 / 255.0))
_KEYS = ("cams", "joints", "kps", "poses", "shapes", "verts", "omegas")


def resolve_device(device) -> torch.device:
    """``device``, or the first CUDA device when it is None. Without a CUDA
    device, None raises: the CPU runs only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def _without_resnet(model: HmmrModel) -> HmmrModel:
    """A deep copy of ``model`` without its ResNet (the window tail)."""
    resnet = model._modules.pop("resnet_v2_50", None)
    try:
        return copy.deepcopy(model)
    finally:
        if resnet is not None:
            model._modules["resnet_v2_50"] = resnet


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
        bf16_encoder: run the ResNet in bf16 (a bf16 copy of it); phi is
            cast to f32.
        int8_encoder: run the int8 ResNet (models/resnet_int8); takes
            precedence over ``bf16_encoder``. The weights are quantised
            once here, and the model's fp32 ResNet is not moved to the
            device.
        int8_calibration: frames (uint8, or [-1, 1] floats) to calibrate
            static activation scales on; without them the int8 encoder
            uses dynamic scales and warns.
        int8_root: the static int8 encoder's stem: False (bf16 root conv),
            True (int8 space-to-depth stem), "wfold" (int8 width-folded
            stem) or "u8" (the width-folded stem on the frames' bytes:
            uint8 frames skip the normalisation). Needs calibration.
        int8_stream: False, True or a tuple of blocks (1-4) whose residual
            stream the static int8 encoder carries as int8. Needs
            calibration.
        bf16_temporal: run the window model (temporal encoder, IEF heads,
            hallucinator) in bf16, from a bf16 copy made once; omegas are
            cast to f32 before the SMPL decode.
        groups_per_step: window groups per model call (bounds memory).
        encode_chunk: frames per ResNet call in image mode.
        device: where to run; None means the CUDA device, and raises
            where there is none. The model and the SMPL constants are
            moved there.
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
        bf16_encoder: bool = False,
        int8_encoder: bool = False,
        int8_calibration=None,
        int8_root=False,
        int8_stream=False,
        bf16_temporal: bool = False,
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
        if (int8_root or int8_stream) and int8_calibration is None:
            raise ValueError(
                "int8_root/int8_stream need int8_calibration (static "
                "scales calibrate the stream/root requantization)"
            )
        if state is not None:
            model.load_state_dict(state)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.pred_mode = pred_mode
        self.use_fused_smpl = use_fused_smpl
        self.int8_encoder = int8_encoder
        self.int8_root = int8_root
        self.int8_stream = int8_stream
        self.bf16_encoder = bf16_encoder and not int8_encoder
        self.bf16_temporal = bf16_temporal
        self.groups_per_step = groups_per_step
        self.encode_chunk = encode_chunk
        self.delta_ts = tuple(sorted(model.delta_t_values))

        resnet = getattr(model, "resnet_v2_50", None)
        # The fp32 ResNet goes to the device only when it is the encoder.
        for child in model.children():
            if child is not resnet or not (int8_encoder or bf16_encoder):
                child.to(self.device)
        for p in model._parameters.values():
            p.data = p.data.to(self.device)
        self.model = model.eval()
        self.smpl = smpl.to(self.device)
        self.fused_constants = (
            prepare_fused_constants(self.smpl) if use_fused_smpl else None
        )

        # Encoder.
        if int8_encoder and int8_calibration is None:
            warnings.warn(
                "int8_encoder WITHOUT int8_calibration uses dynamic "
                "activation scales: every requantisation needs a max|x| "
                "reduction over the whole tensor and a separate "
                "quantisation pass, where static scales fuse into the conv "
                "epilogue. Pass a calibration batch for the static-scale "
                "path.",
                RuntimeWarning, stacklevel=2,
            )
        self._encoder = None if int8_encoder else resnet
        self._int8_plan = self._int8_qp = self._int8_wt = None
        self.int8_scales = None
        if resnet is not None and int8_encoder:
            self._init_int8(resnet, int8_calibration)
        elif resnet is not None and self.bf16_encoder:
            self._encoder = to_bf16(copy.deepcopy(resnet).to(self.device))

        # Window tail, as a bf16 copy made once for bf16_temporal.
        self._tail = (
            to_bf16(_without_resnet(self.model)) if bf16_temporal
            else self.model
        )

    @torch.no_grad()
    def _init_int8(self, resnet, calibration):
        """Quantise once; with calibration frames, observe static scales."""
        qp = {k: v.to(self.device)
              for k, v in prepare_int8_params(resnet).items()}
        scales = None
        if calibration is not None:
            calib = torch.as_tensor(calibration, device=self.device)
            if calib.dtype == torch.uint8:
                # A separate multiply and add, as the JAX predictor's eager
                # normalisation of its calibration frames.
                calib = calib.to(torch.float32) * (2.0 / 255.0) - 1.0
            scales = calibrate_int8_scales(qp, calib.to(torch.float32))
        self.set_int8_params(qp, scales)

    @torch.no_grad()
    def set_int8_params(self, qp, scales=None):
        """Run the int8 encoder on these quantised weights (the port's
        ``prepare_int8_params`` keys, e.g. from ``utils.weights.load_jax_int8``)
        with static ``scales`` (and the predictor's ``int8_root`` and
        ``int8_stream``), or dynamic scales when None."""
        if not self.int8_encoder:
            raise ValueError("set_int8_params needs int8_encoder=True")
        if scales is None and (self.int8_root or self.int8_stream):
            raise ValueError("int8_root/int8_stream need static scales")
        qp = {k: v.to(self.device) for k, v in qp.items()}
        if scales is None:
            self.int8_scales = self._int8_plan = None
            self._int8_qp, self._int8_wt = qp, kmajor_weights(qp)
        else:
            scales = {k: v.to(self.device) for k, v in scales.items()}
            self.int8_scales = scales
            self._int8_qp = self._int8_wt = None
            self._int8_plan = prepare_int8_static(
                qp, scales, int8_stream=self.int8_stream,
                int8_root=self.int8_root)

    # ------------------------------------------------------------------
    # Feature extraction (image mode)
    # ------------------------------------------------------------------

    @staticmethod
    def _normalise(frames: torch.Tensor) -> torch.Tensor:
        """uint8 -> x*(2/255) - 1 rounded once to f32: XLA contracts it into
        one fused multiply-add in the JAX predictor's program (float64 is
        exact for the product and the sum here), and the rounding matters
        once the encoder casts to bf16."""
        if frames.dtype == torch.uint8:
            return (frames.to(torch.float64) * _TWO_OVER_255 - 1.0).to(
                torch.float32)
        return frames.to(torch.float32)

    def _encode_chunk(self, chunk: torch.Tensor,
                      pad_to: Optional[int] = None) -> torch.Tensor:
        """(M, H, W, 3) frames -> (M, 2048) f32 phi, in one encoder call.

        Every encoder but the dynamic int8 one is per frame. Dynamic int8
        scales are per call: with ``pad_to`` they also see zero frames
        (in the frames' own dtype, before the normalisation) up to
        ``pad_to``, as the JAX predictor pads its calls.
        """
        if self._int8_plan is not None:
            if self.int8_root == "u8":
                # The byte-direct stem reads uint8 frames as they are, and
                # snaps float frames back to the 255-grid itself.
                return run_int8_static(self._int8_plan, chunk)
            return run_int8_static(self._int8_plan, self._normalise(chunk))
        if self._int8_qp is not None:
            m = chunk.shape[0]
            if pad_to is not None:
                if pad_to < m:
                    raise ValueError(f"cannot pad {m} frames to {pad_to}")
                chunk = F.pad(chunk, (0, 0, 0, 0, 0, 0, 0, pad_to - m))
            return apply_int8(self._int8_qp, self._normalise(chunk),
                              _wt=self._int8_wt)[:m]
        if self._encoder is None:
            raise ValueError("Model built without resnet but got image input")
        x = self._normalise(chunk)
        if self.bf16_encoder:
            return self._encoder(x.to(torch.bfloat16)).float()
        with full_fp32():
            return self._encoder(x)

    @torch.inference_mode()
    def encode_frames(self, images) -> torch.Tensor:
        """(N, H, W, 3) frames -> (N, 2048) phi on the device.

        uint8 frames are raw video bytes, normalised on the device as
        x*(2/255)-1; anything else is taken as [-1, 1] floats.
        """
        with span("hmmr.encode"):
            images = torch.as_tensor(images, device=self.device)
            # Dynamic int8: the tail chunk is padded to the full chunk, as
            # the JAX predictor pads it.
            return torch.cat([
                self._encode_chunk(images[i:i + self.encode_chunk],
                                   pad_to=self.encode_chunk)
                for i in range(0, len(images), self.encode_chunk)
            ])

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
        windows = phi_padded[idx]                       # (S*B, T, C)
        if self.bf16_temporal:
            out = self._tail(windows.to(torch.bfloat16))
        else:
            with full_fp32():
                out = self._tail(windows)

        if self.pred_mode == "hal":
            present, deltas = out.omega_hal, out.omegas_hal_delta
        else:
            present, deltas = out.omega_pred, out.omegas_delta
        # bf16_temporal: omegas back to f32 before the SMPL decode.
        present = present.float()
        deltas = {dt: v.float() for dt, v in deltas.items()}

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
        with span("hmmr.window"):
            phi = torch.as_tensor(phi, dtype=torch.float32,
                                  device=self.device)
            out, _ = self._predict_block(phi, 1, 0)
            out = {k: v[:len(phi)] for k, v in out.items()}
            if as_numpy:
                out = {k: v.cpu().numpy() for k, v in out.items()}
            return out

    def _predict_block(self, phi: torch.Tensor, parts: int, idx: int):
        """Block ``idx`` of ``parts`` contiguous blocks of phi's window
        groups (the group count rounded up to a multiple of ``parts``, the
        extra groups on zero features), in steps of ``groups_per_step``.
        Returns the block's outputs with its windows' good frames
        flattened, (rows, ...) each, and the rows of all blocks."""
        sched = WindowSchedule(
            num_frames=len(phi),
            batch_size=self.batch_size,
            seq_length=self.seq_length,
            fov=self.model.fov,
        )
        count = -(-sched.count // parts) * parts
        frames_per_group = self.batch_size * sched.good_frames
        extra = (count - sched.count) * frames_per_group
        phi_padded = F.pad(phi, (0, 0, sched.margin, sched.num_fill + extra))
        per_block = count // parts
        ids = torch.arange(idx * per_block, (idx + 1) * per_block,
                           device=self.device)
        steps = [
            self._run_groups(phi_padded, ids[i:i + self.groups_per_step],
                             sched.margin, sched.good_frames)
            for i in range(0, per_block, self.groups_per_step)
        ]
        out = {k: torch.cat([s[k] for s in steps]).flatten(0, 1)
               for k in steps[0]}
        return out, count * frames_per_group

    # ------------------------------------------------------------------
    # Multi-GPU data-parallel windowed inference
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def predict_all_images_sharded(
        self, frames, mesh, phi=None, as_numpy: bool = True
    ) -> Dict[str, np.ndarray]:
        """predict_all_images with the window groups split over a mesh.

        Every rank calls it with the same arguments. The group count is
        rounded up to the axis size; rank r runs the r-th contiguous block
        of groups on the whole (replicated) feature buffer, and the blocks
        are gathered to every rank and stitched as on one device, so the
        results are predict_all_images's.

        Args:
            frames/phi: as in predict_all_images. Image input is encoded by
                the axis's first rank (``encode_frames``, the configured
                encoder) and broadcast as phi, so every rank sees the same
                features, dynamic int8 scales included.
            mesh: a ``parallel.Mesh``; the groups split over its first axis.
        """
        axis = mesh.axis_names[0]
        parts, idx = mesh.shape[axis], mesh.index(axis)
        if phi is None:
            if getattr(frames, "ndim", None) == 2:
                phi = frames
            else:
                phi = (self.encode_frames(frames) if idx == 0 else
                       torch.empty((len(frames), self.model.feature_dim),
                                   device=self.device))
                broadcast(phi, mesh, axis)
        phi = torch.as_tensor(phi, dtype=torch.float32, device=self.device)
        local, total = self._predict_block(phi, parts, idx)
        rows = total // parts
        out = assemble(local, (total,), (slice(idx * rows, (idx + 1) * rows),),
                       mesh, axis)
        out = {k: v[:len(phi)] for k, v in out.items()}
        if as_numpy:
            out = {k: v.cpu().numpy() for k, v in out.items()}
        return out
