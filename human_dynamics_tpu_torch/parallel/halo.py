"""Temporal sequence parallelism: a clip's frames sharded over ranks.

Counterpart of ``human_dynamics_tpu/parallel/halo.py``. The windowed
predictor bounds long clips with overlapping windows because the temporal
encoder has a finite receptive field (13 frames). Here a clip's frames are
split over the ranks of a mesh axis instead: each width-3 temporal conv
takes a 1-frame halo from each neighbour, and each GroupNorm takes its
statistics over the whole clip, so the sharded encoder computes the
unsharded full-clip forward, not the windowed approximation.

Collectives, all over the axis row of the rank (``parallel.mesh``), each a
``psum``, so that autograd differentiates them and one implementation
serves inference and training:
- a halo is one ``all_reduce`` of a zeroed (ranks, 2, ..., C) buffer into
  which each rank writes its first and last frame; the first rank takes
  zeros from the left, the last from the right (the unsharded conv's zero
  padding). Its backward sends each halo frame's gradient back to the rank
  that owns the frame;
- a GroupNorm's sums, sums of squares and frame counts are one
  ``all_reduce``; the backward sums their gradients over the row;
- the outputs come back whole by ``parallel.mesh.assemble``.

Every rank builds the same autograd graph (a missing neighbour's halo is
the neighbour slot times 0, not a different op), so the backward's
collectives come in one order on every rank.

The arithmetic is the JAX package's, not ``F.group_norm``'s or
``nn.Conv1d``'s: the variance in one pass, sumsq/count - mean^2 (flax's
``use_fast_variance``), and the conv as three matmuls and a bias. The
inference paths run it with TF32 off. The encoder reads the port's
``TemporalEncoderFC2GN`` parameters: a Conv1d weight is (cout, cin, 3), so
tap j is ``weight[:, :, j].T``. As the module's GroupNorm, the statistics
and the normalisation are fp32 and the result takes the input's dtype.

Padding frames (a clip that does not divide the axis) are left out of the
statistics and zeroed on output, so they act as the clip edge's zero
padding.

``temporal_encoder_sharded`` is also 2-D training's encoder: (Bl, Tl, C)
blocks of a (data, time) mesh, with autograd (``models.hmmr``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from human_dynamics_tpu_torch.parallel.mesh import Mesh, assemble, psum
from human_dynamics_tpu_torch.utils.precision import full_fp32


def halo_pad(x_local: torch.Tensor, mesh: Mesh, axis_name: str
             ) -> torch.Tensor:
    """Append 1-frame halos from both neighbours: (..., Tl, C) ->
    (..., Tl+2, C). Boundary ranks receive zeros. Differentiable."""
    idx, n = mesh.index(axis_name), mesh.shape[axis_name]
    buf = x_local.new_zeros((n, 2) + x_local.shape[:-2] + x_local.shape[-1:])
    buf[idx, 0] = x_local[..., 0, :]
    buf[idx, 1] = x_local[..., -1, :]
    buf = psum(buf, mesh, axis_name)
    from_left = buf[(idx - 1) % n, 1] * float(idx > 0)
    from_right = buf[(idx + 1) % n, 0] * float(idx < n - 1)
    return torch.cat(
        [from_left.unsqueeze(-2), x_local, from_right.unsqueeze(-2)], dim=-2
    )


def _conv3_halo(x_local: torch.Tensor, conv: nn.Conv1d, mesh: Mesh,
                axis_name: str) -> torch.Tensor:
    """Width-3 'SAME' temporal conv across the shard boundary, on
    (..., Tl, C), as three matmuls plus the bias."""
    xp = halo_pad(x_local, mesh, axis_name)
    w = conv.weight
    return (
        xp[..., :-2, :] @ w[:, :, 0].T + xp[..., 1:-1, :] @ w[:, :, 1].T
        + xp[..., 2:, :] @ w[:, :, 2].T + conv.bias
    )


def _group_norm_global(
    x_local: torch.Tensor,
    mask_local: torch.Tensor,
    gn: nn.GroupNorm,
    mesh: Mesh,
    axis_name: str,
) -> torch.Tensor:
    """GroupNorm of (..., Tl, C) with statistics over the whole (valid)
    clip: per group, over (T, channels of the group), as ``gn`` on the
    unsharded clip. ``mask_local`` (..., Tl, 1) marks real frames.
    Differentiable; fp32 inside, the result in x's dtype."""
    x, mask = x_local.float(), mask_local.float()
    tl, c = x.shape[-2:]
    g = gn.num_groups
    cg = c // g
    lead = x.shape[:-2]
    xg = (x * mask).reshape(lead + (tl, g, cg))
    stats = torch.cat([
        xg.sum(dim=(-3, -1)),                           # (..., G)
        (xg * xg).sum(dim=(-3, -1)),
        mask.sum(dim=(-2, -1))[..., None] * cg,         # (..., 1)
    ], dim=-1)
    total_sum, total_sumsq, count = psum(stats, mesh, axis_name).split(
        [g, g, 1], dim=-1)
    mean = total_sum / count
    var = total_sumsq / count - mean * mean
    inv = torch.rsqrt(var + gn.eps)
    normed = (
        x.reshape(lead + (tl, g, cg)) - mean[..., None, :, None]
    ) * inv[..., None, :, None]
    out = normed.reshape(lead + (tl, c)) * gn.weight.float() + gn.bias.float()
    return (out * mask).to(x_local.dtype)


def temporal_encoder_sharded(
    encoder: nn.Module,
    phi_local: torch.Tensor,
    mesh: Mesh,
    axis_name: str,
    mask_local: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``TemporalEncoderFC2GN`` forward on a time shard (..., Tl, C): the
    unsharded encoder's on the whole clip, this rank's frames of it.
    Differentiable (2-D training); every rank of the ``axis_name`` row
    must call it, and its backward, at the same point."""
    if mask_local is None:
        mask_local = phi_local.new_ones(phi_local.shape[:-1] + (1,))
    net = phi_local * mask_local
    for block in encoder.children():
        h = F.relu(_group_norm_global(net, mask_local, block.gn1, mesh,
                                      axis_name))
        h = _conv3_halo(h, block.conv1, mesh, axis_name) * mask_local
        h = F.relu(_group_norm_global(h, mask_local, block.gn2, mesh,
                                      axis_name))
        h = _conv3_halo(h, block.conv2, mesh, axis_name) * mask_local
        net = net + h
    return net


def _pad_frames(x: torch.Tensor, dim: int, parts: int):
    """Zero-pad ``x`` along ``dim`` to a multiple of ``parts``; returns the
    padded tensor and an (n_pad,) vector, 1 on the real entries."""
    n = x.shape[dim]
    n_pad = math.ceil(n / parts) * parts
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, n_pad - n]
    valid = (torch.arange(n_pad, device=x.device) < n).to(x.dtype)
    return F.pad(x, pad), valid


def _heads_and_decode(model, smpl, strip: torch.Tensor, want_verts: bool
                      ) -> Dict[str, torch.Tensor]:
    """IEF heads on (Bl, Tl, C) strips, then one stacked composed SMPL
    decode; every head takes the present camera."""
    # Imported here: models.hmmr imports this module.
    from human_dynamics_tpu_torch.models.omega import (
        compute_smpl,
        split_omega,
    )

    present, deltas = model._pred_heads(strip, model.predict_delta, False,
                                        None)
    dts = sorted(deltas)
    stacked = torch.stack([present] + [deltas[dt] for dt in dts])
    cams = split_omega(present)[0]
    cams_all = cams[None].expand(stacked.shape[:-1] + (3,))
    sm = compute_smpl(smpl, stacked, use_optcam=False,
                      cams_override=cams_all, want_verts=want_verts)
    out = {
        "omegas": present,
        "joints": sm.joints[0],
        "kps": sm.kps[0],
        "poses": sm.poses_rot[0],
    }
    if want_verts:
        out["verts"] = sm.verts[0]
    for i, dt in enumerate(dts):
        out[f"omegas_delta_{dt}"] = stacked[i + 1]
        out[f"joints_delta_{dt}"] = sm.joints[i + 1]
    return out


@torch.inference_mode()
def predict_clip_sharded(
    model,
    smpl,
    phi,
    mesh: Mesh,
    axis_name: str = "time",
    want_verts: bool = True,
) -> Dict[str, torch.Tensor]:
    """Whole-clip HMMR inference, the clip's frames sharded over
    ``axis_name``.

    The halo temporal encoder, the present and ±dt IEF heads and the
    composed SMPL decode, on this rank's frames; the full-clip forward,
    not the windowed predictor's overlap stitching.

    Args:
        model: the port's HmmrModel (phi mode), on the mesh's device.
        smpl: SmplModel for the decode, on the same device.
        phi: (N, C) per-frame features of the whole clip, the same on
            every rank.
        mesh: a mesh with ``axis_name``; ranks along other axes compute
            the same clip.

    Returns:
        dict of whole arrays on every rank: omegas (N, 85), joints
        (N, K, 3), kps (N, K, 2), poses (N, 24, 3, 3), verts (N, V, 3) [if
        want_verts], and omegas_delta_{dt} (N, 85), joints_delta_{dt}.
    """
    phi = torch.as_tensor(phi, dtype=torch.float32, device=mesh.device)
    n = phi.shape[0]
    parts, idx = mesh.shape[axis_name], mesh.index(axis_name)
    phi_p, valid = _pad_frames(phi, 0, parts)
    tl = phi_p.shape[0] // parts
    rows = slice(idx * tl, (idx + 1) * tl)
    with full_fp32():
        strip = temporal_encoder_sharded(
            model.temporal_encoder, phi_p[rows][None], mesh, axis_name,
            mask_local=valid[rows][None, :, None],
        )
        local = _heads_and_decode(model, smpl, strip, want_verts)
    local = {k: v[0] for k, v in local.items()}
    out = assemble(local, (phi_p.shape[0],), (rows,), mesh, axis_name)
    return {k: v[:n] for k, v in out.items()}


@torch.inference_mode()
def predict_clips_sharded_2d(
    model,
    smpl,
    phis,
    mesh: Mesh,
    data_axis: str = "data",
    time_axis: str = "time",
    want_verts: bool = True,
) -> Dict[str, torch.Tensor]:
    """Whole-clip inference for a batch of clips on a (data, time) mesh:
    clips over ``data_axis``, each clip's frames over ``time_axis`` (halo
    encoder and clip-global GroupNorm within the rank's time row).

    Args:
        phis: (B, N, C) features of B clips of N frames, the same on every
            rank.

    Returns:
        dict of whole (B, N, ...) arrays on every rank, with the keys of
        ``predict_clip_sharded``.
    """
    if set(mesh.axis_names) != {data_axis, time_axis}:
        raise ValueError(
            f"predict_clips_sharded_2d needs a ({data_axis}, {time_axis}) "
            f"mesh, got axes {mesh.axis_names}"
        )
    phis = torch.as_tensor(phis, dtype=torch.float32, device=mesh.device)
    b, n, _ = phis.shape
    d_dev, t_dev = mesh.shape[data_axis], mesh.shape[time_axis]
    phi_p, valid = _pad_frames(phis, 1, t_dev)
    phi_p, _ = _pad_frames(phi_p, 0, d_dev)
    bl, tl = phi_p.shape[0] // d_dev, phi_p.shape[1] // t_dev
    di, ti = mesh.index(data_axis), mesh.index(time_axis)
    clips = slice(di * bl, (di + 1) * bl)
    rows = slice(ti * tl, (ti + 1) * tl)
    with full_fp32():
        strip = temporal_encoder_sharded(
            model.temporal_encoder, phi_p[clips, rows], mesh, time_axis,
            mask_local=valid[rows][None, :, None].expand(bl, tl, 1),
        )
        local = _heads_and_decode(model, smpl, strip, want_verts)
    out = assemble(local, tuple(phi_p.shape[:2]), (clips, rows), mesh)
    return {k: v[:b, :n] for k, v in out.items()}


@torch.inference_mode()
def movie_strip_sharded(
    module: nn.Module,
    phi,
    mesh: Mesh,
    axis_name: str = "time",
) -> torch.Tensor:
    """The temporal encoder over a whole clip, time-sharded.

    ``module``: an HmmrModel or a bare TemporalEncoderFC2GN. ``phi``: (N, C)
    features of the whole clip (padded to a multiple of the axis size; the
    padding is trimmed). Returns the (N, C) movie strip on every rank, the
    unsharded encoder's up to rounding.
    """
    encoder = getattr(module, "temporal_encoder", module)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=mesh.device)
    n = phi.shape[0]
    parts, idx = mesh.shape[axis_name], mesh.index(axis_name)
    phi_p, valid = _pad_frames(phi, 0, parts)
    tl = phi_p.shape[0] // parts
    rows = slice(idx * tl, (idx + 1) * tl)
    with full_fp32():
        strip = temporal_encoder_sharded(
            encoder, phi_p[rows], mesh, axis_name,
            mask_local=valid[rows][:, None],
        )
    out = assemble({"strip": strip}, (phi_p.shape[0],), (rows,), mesh,
                   axis_name)
    return out["strip"][:n]
