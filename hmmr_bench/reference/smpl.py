"""SMPL, Rodrigues and the weak-perspective projection, plain PyTorch.

The model constants are a dict of tensors made by the benchmark
(``harness.inputs.smpl_arrays``): v_template (V, 3), shapedirs (10, 3V),
posedirs (207, 3V), j_regressor (V, 24), lbs_weights (V, 24),
joint_regressor (V, K). The forward kinematics walk the 24 joints one by
one; skinning is the linear blend of the 24 world transforms.
"""

from __future__ import annotations

import torch

PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
           18, 19, 20, 21)


def rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotations (..., 3, 3); HMR adds 1e-8 to each
    component before the norm."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=-1, keepdim=True)
    r = theta / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    skew = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1)
    skew = skew.reshape(r.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return cos * eye + (1 - cos) * (r[..., :, None] * r[..., None, :]) + sin * skew


def smpl(model, beta: torch.Tensor, theta: torch.Tensor):
    """(N, 10) betas, (N, 72) poses -> verts (N, V, 3), joints (N, K, 3),
    rotations (N, 24, 3, 3)."""
    n = beta.shape[0]
    v = model["v_template"].shape[0]
    v_shaped = (beta @ model["shapedirs"]).reshape(n, v, 3) + model["v_template"]
    j_rest = torch.einsum("nvc,vj->njc", v_shaped, model["j_regressor"])
    rots = rodrigues(theta.reshape(n, 24, 3))
    eye = torch.eye(3, dtype=beta.dtype, device=beta.device)
    pose_feat = (rots[:, 1:] - eye).reshape(n, 207)
    v_posed = (pose_feat @ model["posedirs"]).reshape(n, v, 3) + v_shaped
    world_r, world_t = [], []
    for j, p in enumerate(PARENTS):
        if p < 0:
            world_r.append(rots[:, 0])
            world_t.append(j_rest[:, 0])
            continue
        bone = (j_rest[:, j] - j_rest[:, p])[..., None]
        world_t.append((world_r[p] @ bone)[..., 0] + world_t[p])
        world_r.append(world_r[p] @ rots[:, j])
    world_r = torch.stack(world_r, 1)                       # (N, 24, 3, 3)
    world_t = torch.stack(world_t, 1)                       # (N, 24, 3)
    rel_t = world_t - (world_r @ j_rest[..., None])[..., 0]
    blend_r = torch.einsum("vj,njab->nvab", model["lbs_weights"], world_r)
    blend_t = torch.einsum("vj,nja->nva", model["lbs_weights"], rel_t)
    verts = (blend_r @ v_posed[..., None])[..., 0] + blend_t
    joints = torch.einsum("nvc,vk->nkc", verts, model["joint_regressor"])
    return verts, joints, rots


def orth_proj(x: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """s * (x_xy + t); x (..., K, 3), cam (..., 3) = [s, tx, ty]."""
    cam = cam[..., None, :]
    return cam[..., :1] * (x[..., :2] + cam[..., 1:])


def procrustes2d_vis(x: torch.Tensor, x_target: torch.Tensor) -> torch.Tensor:
    """HMMR's optimal scale and translation onto the visible targets, the
    scale clamped to [0.7, 10], detached: (..., 3)."""
    vis = (x_target[..., 2] > 0).to(x.dtype)
    vv = vis[..., None]
    xt, xp = x_target[..., :2], x[..., :2]
    num = vis.sum(-1, keepdim=True)[..., None]
    mu1 = (vv * xp).sum(-2, keepdim=True) / num
    mu2 = (vv * xt).sum(-2, keepdim=True) / num
    xm, y = vv * (xp - mu1), vv * (xt - mu2)
    a11 = (xm[..., 0] ** 2).sum(-1) + 1e-6
    a12 = (xm[..., 0] * xm[..., 1]).sum(-1)
    a22 = (xm[..., 1] ** 2).sum(-1) + 1e-6
    b11 = (xm[..., 0] * y[..., 0]).sum(-1)
    b12 = (xm[..., 0] * y[..., 1]).sum(-1)
    b21 = (xm[..., 1] * y[..., 0]).sum(-1)
    b22 = (xm[..., 1] * y[..., 1]).sum(-1)
    det = a11 * a22 - a12 * a12
    tr = (a22 * b11 - a12 * b21 - a12 * b12 + a11 * b22) / det
    scale = torch.clamp(tr / 2.0, 0.7, 10.0)
    trans = mu2.squeeze(-2) / scale[..., None] - mu1.squeeze(-2)
    return torch.cat([scale[..., None], trans], -1).detach()
