"""HMMR's training step, plain PyTorch, fp32: every head's forward, one SMPL
decode per head, every loss, one backward of e_loss + d_loss and two Adams.

The objective is HMMR's (src/trainer.py of the reference):

- per head (present, the +-dt heads, the hallucinated present): the 2-D
  keypoint L1 (the present heads with their own camera, the delta heads
  with each frame's optimal camera against the ground truth dt frames
  away, frames outside the clip left out), the 3-D pose-rotation, shape
  and pelvis-aligned joint MSEs where the labels exist;
- the betas' smoothness over time, the hallucinator's MSE to the movie
  strip, the shape prior, and the LSGAN pose prior: the encoder meets a
  frozen critic, the discriminator meets detached fakes of every head and
  the mocap pool;
- weights 60 on the keypoint, joint and SMPL terms, 1 on the others;
- Adam (beta 0.9, 0.999, eps 1e-8) at e_lr on the HMMR parameters that
  are not frozen and d_lr on the discriminator's.

Dropout masks come from a generator seeded per step as the caller says,
drawn in the order of ``model.hmmr``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from hmmr_bench.reference import model as M
from hmmr_bench.reference.smpl import orth_proj, procrustes2d_vis, rodrigues, smpl

W_BIG = 60.0


def _sum_by_nonzero(losses, weights):
    nonzero = torch.broadcast_to(weights != 0.0, losses.shape).sum()
    return (losses * weights).sum() / torch.clamp(nonzero, min=1).to(losses.dtype)


def _kp_l1(kp_gt, kp_pred):
    gt, pred = kp_gt.reshape(-1, 3), kp_pred.reshape(-1, 2)
    return _sum_by_nonzero((gt[:, :2] - pred).abs(), gt[:, 2:3])


def _masked_mse(gt, pred, has):
    return 0.5 * _sum_by_nonzero((gt - pred) ** 2, has.reshape(-1, 1))


def _pelvis(j):
    return j - ((j[..., 3, :] + j[..., 2, :]) / 2.0)[..., None, :]


def losses(P_e, P_d, smpl_model, batch: Dict, gen: Optional[torch.Generator],
           train_bn: bool = True):
    """(e_loss, d_loss, dict of every loss) of one batch; ``batch`` holds
    phis (B, T, C) or images (B, T, S, S, 3), kps (B, T, K, 3), poses_gt
    (B, T, 24, 3), shapes_gt (B, 10), joints_gt (B, T, 14, 3),
    has_3d_joints, has_3d_smpl (B,), poses_real (P, 24, 3)."""
    x = batch["phis"]
    b, t = x.shape[:2]
    if x.dim() == 5:
        with torch.no_grad():     # the frozen trunk takes no gradient
            x = M.resnet(P_e, x.reshape((b * t,) + x.shape[2:]),
                         train_bn).reshape(b, t, -1)
    out = M.hmmr(P_e, x, gen)
    heads = [("pred", 0, out["pred"])]
    heads += [("dt", dt, out["deltas"][dt]) for dt in sorted(out["deltas"])]
    heads.append(("hal", 0, out["hal"]))
    stacked = torch.stack([h[2] for h in heads])           # (H, B, T, 85)
    flat = stacked.reshape(-1, M.OMEGA_DIM)
    _, joints, rots = smpl(smpl_model, flat[:, 75:], flat[:, 3:75])
    nh = len(heads)
    joints = joints.reshape(nh, b, t, -1, 3)
    rots = rots.reshape(nh, b, t, 24, 3, 3)

    poses_rot_gt = rodrigues(batch["poses_gt"].reshape(b, t, 24, 3))
    shapes_tiled = batch["shapes_gt"][:, None, :].expand(b, t, 10)
    has_smpl = torch.repeat_interleave(batch["has_3d_smpl"], t)
    has_joints = torch.repeat_interleave(batch["has_3d_joints"], t)
    L: Dict[str, torch.Tensor] = {}
    fake_poses, fake_shapes = [], []
    for i, (kind, dt, raw) in enumerate(heads):
        cams, shapes = raw[..., :3], raw[..., 75:]
        fake_poses.append(rots[i].reshape(-1, 24, 9))
        fake_shapes.append(shapes.reshape(-1, 10))
        if dt == 0:
            frames = torch.arange(t, device=raw.device)
            rows = torch.ones(b * t, device=raw.device)
            kp = _kp_l1(batch["kps"], orth_proj(joints[i], cams))
            suffix = "" if kind == "pred" else "_hal"
        else:
            f = torch.arange(t, device=raw.device) + dt
            valid = ((f >= 0) & (f < t)).float()
            frames, rows = f.clamp(0, t - 1), valid.repeat(b)
            gt = batch["kps"][:, frames].reshape(b * t, -1, 3)
            pred = joints[i][..., :2].reshape(b * t, -1, 2)
            cam = procrustes2d_vis(pred, gt)
            vis = gt[..., 2:] * rows[:, None, None]
            kp = _kp_l1(torch.cat([gt[..., :2], vis], -1), orth_proj(pred, cam))
            suffix = "_dt_future" if dt > 0 else "_dt_past"
        jg = _pelvis(batch["joints_gt"][:, frames].reshape(b * t, 14, 3))
        jp = _pelvis(joints[i][..., :14, :].reshape(b * t, 14, 3))
        lp = _masked_mse(poses_rot_gt[:, frames].reshape(b * t, -1),
                         rots[i].reshape(b * t, -1), has_smpl * rows)
        ls = _masked_mse(shapes_tiled.reshape(b * t, -1), shapes.reshape(b * t, -1),
                         has_smpl * rows)
        lj = _masked_mse(jg.reshape(b * t, -1), jp.reshape(b * t, -1),
                         has_joints * rows)
        L["e_kp" + suffix] = kp
        L["e_joints" + suffix] = lj
        L["e_smpl" + suffix] = lp + ls
    betas = out["pred"][..., 75:]
    L["e_const"] = 0.5 * torch.mean((betas[:, :-1] - betas[:, 1:]) ** 2)
    L["e_hallucinate"] = torch.mean((out["movie"] - out["hal_strip"]) ** 2)
    fake = torch.cat(fake_poses)[:, 1:]
    real = rodrigues(batch["poses_real"]).reshape(-1, 24, 9)[:, 1:]
    critic = {k: v.detach() for k, v in P_d.items()}
    out_fake_e = M.discriminator(critic, fake)
    d_out = M.discriminator(P_d, torch.cat([real, fake.detach()]))
    out_real, out_fake_d = d_out.split([len(real), len(fake)])
    L["e_pose"] = torch.mean(((out_fake_e - 1.0) ** 2).sum(1))
    L["d_pose"] = (torch.mean((out_fake_d ** 2).sum(1))
                   + torch.mean(((out_real - 1.0) ** 2).sum(1)))
    L["e_shape"] = torch.mean(torch.cat(fake_shapes) ** 2)
    e_loss = sum((W_BIG if k.startswith(("e_kp", "e_joints", "e_smpl")) else 1.0) * v
                 for k, v in L.items() if k.startswith("e"))
    return e_loss, L["d_pose"], L


class Adam:
    """Adam as torch.optim.Adam computes it: bias-corrected moments, the
    step lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps). It starts
    from zero moments at t = 0, or from ``moments`` = (m, v, t)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1=0.9, b2=0.999, eps=1e-8, moments=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        m, v, self.t = moments or ({}, {}, 0)
        self.m = {k: m[k].clone() if k in m else torch.zeros_like(p)
                  for k, p in params.items()}
        self.v = {k: v[k].clone() if k in v else torch.zeros_like(p)
                  for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def run_steps(P_e: Dict, P_d: Dict, frozen: Dict, smpl_model, batches: List[Dict],
              gens: List[Optional[torch.Generator]], e_lr: float = 1e-5,
              d_lr: float = 1e-4, train_bn: bool = True, moments=None) -> Dict:
    """Steps from the trainable HMMR parameters ``P_e``, the discriminator's
    ``P_d`` and the frozen tensors (the trunk's, with its BatchNorm
    statistics), one per batch; both Adams start from ``moments`` = (m, v,
    t) by parameter name, or from zero. Returns each step's e_loss and
    d_loss, the first step's gradients and the parameters after the last
    step."""
    P_e = {k: v.detach().clone().requires_grad_(True) for k, v in P_e.items()}
    P_d = {k: v.detach().clone().requires_grad_(True) for k, v in P_d.items()}
    opt_e, opt_d = Adam(P_e, e_lr, moments=moments), Adam(P_d, d_lr, moments=moments)
    out = {"e_loss": [], "d_loss": [], "grads": None}
    for i, (batch, gen) in enumerate(zip(batches, gens)):
        e_loss, d_loss, _ = losses({**frozen, **P_e}, P_d, smpl_model, batch,
                                   gen, train_bn)
        names = list(P_e) + list(P_d)
        tensors = [P_e[k] for k in P_e] + [P_d[k] for k in P_d]
        grads = torch.autograd.grad(e_loss + d_loss, tensors, allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for k, p, g in zip(names, tensors, grads)}
        out["e_loss"].append(float(e_loss.detach()))
        out["d_loss"].append(float(d_loss.detach()))
        if i == 0:
            out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        opt_e.step(P_e, grads)
        opt_d.step(P_d, grads)
    out["params"] = {k: v.detach() for k, v in {**P_e, **P_d}.items()}
    return out
