"""Omega (cam | pose | shape) helpers and the stacked SMPL decode.

Counterpart of ``human_dynamics_tpu/models/omega.py``. Omega raw is 85 =
[cam 3 | pose 24*3 | shape 10]. ``compute_smpl`` decodes omegas of any
leading shape in one batched SMPL call. With ``fused=True`` the (N, V)
work runs in the fused blend+skin op (``ops.smpl_cuda``); its constants
are prepared once by the caller (the predictor and the trainer hold them)
and passed in. ``OmegaGt`` bundles a training batch's ground truth.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from human_dynamics_tpu_torch.core.projection import orth_proj_idrot
from human_dynamics_tpu_torch.core.rotations import rodrigues
from human_dynamics_tpu_torch.core.smpl import SmplModel, smpl_forward
from human_dynamics_tpu_torch.ops.smpl_cuda import (
    FusedSmplConstants,
    smpl_forward_fused,
)
from human_dynamics_tpu_torch.utils.logging import span

CAM_DIM = 3
POSE_DIM = 72
SHAPE_DIM = 10
OMEGA_DIM = CAM_DIM + POSE_DIM + SHAPE_DIM  # 85


def split_omega(raw: torch.Tensor):
    """raw (..., 85) -> (cams (..., 3), poses_aa (..., 72), shapes (..., 10))."""
    return (
        raw[..., :CAM_DIM],
        raw[..., CAM_DIM:CAM_DIM + POSE_DIM],
        raw[..., CAM_DIM + POSE_DIM:],
    )


def pack_omega(cams: torch.Tensor, poses_aa: torch.Tensor,
               shapes: torch.Tensor) -> torch.Tensor:
    """Inverse of split_omega (poses as (..., 72) or (..., 24, 3))."""
    poses_flat = poses_aa.reshape(poses_aa.shape[: cams.dim() - 1] + (POSE_DIM,))
    return torch.cat([cams, poses_flat, shapes], dim=-1)


class OmegaSmpl(NamedTuple):
    """SMPL-evaluated quantities; leading dims are those of raw (..., 85).

    joints (..., K, 3); kps (..., K, 2); poses_rot (..., 24, 3, 3);
    verts (..., V, 3) or None.
    """

    joints: torch.Tensor
    kps: torch.Tensor
    poses_rot: torch.Tensor
    verts: Optional[torch.Tensor]


def compute_smpl(
    model: SmplModel,
    raw: torch.Tensor,
    use_optcam: bool = False,
    cams_override: Optional[torch.Tensor] = None,
    want_verts: bool = True,
    fused: bool = False,
    fused_constants: Optional[FusedSmplConstants] = None,
) -> OmegaSmpl:
    """SMPL + projection for omegas with any leading batch shape.

    With ``use_optcam`` (and no override) the 2-D keypoints are
    joints[..., :2]; otherwise the packed camera, or ``cams_override``, is
    applied by weak-perspective projection. ``fused_constants`` is used
    only with ``fused=True``; None prepares them on the spot. Under
    ``torch.profiler`` the decode is the range "hmmr.smpl".
    """
    with span("hmmr.smpl"):
        lead = raw.shape[:-1]
        n = math.prod(lead)
        cams, poses, shapes = split_omega(raw.reshape(n, OMEGA_DIM))

        if fused:
            out = smpl_forward_fused(
                model, shapes, poses, constants=fused_constants,
                want_verts=want_verts,
            )
        else:
            if fused_constants is not None:
                raise ValueError("fused_constants given with fused=False")
            out = smpl_forward(model, shapes, poses)
        k = out.joints.shape[1]

        if use_optcam and cams_override is None:
            kps = out.joints[:, :, :2]
        else:
            cam_use = (
                cams_override.reshape(n, CAM_DIM)
                if cams_override is not None else cams
            )
            kps = orth_proj_idrot(out.joints, cam_use)

        verts = (
            out.verts.reshape(lead + out.verts.shape[1:]) if want_verts
            else None
        )
        return OmegaSmpl(
            joints=out.joints.reshape(lead + (k, 3)),
            kps=kps.reshape(lead + (k, 2)),
            poses_rot=out.rots.reshape(lead + (24, 3, 3)),
            verts=verts,
        )


class OmegaGt(NamedTuple):
    """Ground-truth bundle of a training batch.

    poses_aa (B, T, 24, 3); poses_rot (B, T, 24, 3, 3); shapes (B, 10),
    one per sequence; joints (B, T, 14, 3) 3-D joints; kps (B, T, K, 3)
    with visibility.
    """

    poses_aa: torch.Tensor
    poses_rot: torch.Tensor
    shapes: torch.Tensor
    joints: torch.Tensor
    kps: torch.Tensor

    @classmethod
    def create(cls, poses_aa, shapes, joints, kps) -> "OmegaGt":
        b, t = poses_aa.shape[:2]
        poses_aa = poses_aa.reshape(b, t, 24, 3)
        return cls(poses_aa=poses_aa, poses_rot=rodrigues(poses_aa),
                   shapes=shapes, joints=joints, kps=kps)

    def at_frames(self, index) -> "OmegaGt":
        """The bundle at frames ``index`` (a slice or an index tensor) of
        every sequence; the per-sequence shapes as they are."""
        return OmegaGt(self.poses_aa[:, index], self.poses_rot[:, index],
                       self.shapes, self.joints[:, index],
                       self.kps[:, index])

    def shapes_tiled(self, t: int) -> torch.Tensor:
        """(B, 10) -> (B, T, 10)."""
        return self.shapes[:, None, :].expand(self.shapes.shape[0], t,
                                              SHAPE_DIM)
