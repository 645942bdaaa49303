"""Everything a run feeds both sides, made on the device from ``--seed``:
the weights, the SMPL model, the clips and the training batches.

Each kind of input draws from its own generator, seeded from (seed,
stream), in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from hmmr_bench.reference import model as M

_STREAMS = {"weights": 1, "smpl": 2, "clips": 3, "batches": 4}


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + _STREAMS[stream]) % (2 ** 63))
    return g


def make_params(specs, seed: int, device, offset: int = 0) -> Dict[str, torch.Tensor]:
    """fp32 tensors for ``specs`` ((name, shape, init) from
    ``reference.model``): one standard-normal draw for every "normal"
    tensor, scaled by gain / sqrt(fan_in); ``offset`` skips that many draws
    (the discriminator's come after the HMMR model's)."""
    flat = torch.randn(offset + count_normal(specs),
                       generator=generator(seed, "weights", device), device=device)[offset:]
    out, pos = {}, 0
    for name, shape, init in specs:
        if isinstance(init, tuple):
            n = math.prod(shape)
            out[name] = flat[pos:pos + n].view(shape) * (init[1] / math.sqrt(M.fan_in(shape)))
            pos += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "mean":
            out[name] = M.mean_omega().to(device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out


def count_normal(specs) -> int:
    return sum(math.prod(s) for _, s, init in specs if isinstance(init, tuple))


def smpl_arrays(seed: int, num_verts: int, num_kps: int, device) -> Dict[str, torch.Tensor]:
    """A synthetic SMPL model at the published sizes, the recipe of the
    port's ``synthetic_smpl_model`` drawn on the device: template in
    [-1, 1], blend shapes of scale 0.03 and 0.01, sparse-ish regressors and
    skinning weights normalised as SMPL's."""
    g = generator(seed, "smpl", device)
    v = num_verts
    u = lambda *s: torch.rand(s, generator=g, device=device)
    n = lambda *s: torch.randn(s, generator=g, device=device)
    j_reg = u(v, 24) ** 8
    w = u(v, 24) ** 4
    kp = u(v, num_kps)
    return {
        "v_template": u(v, 3) * 2 - 1,
        "shapedirs": n(10, 3 * v) * 0.03,
        "posedirs": n(207, 3 * v) * 0.01,
        "j_regressor": j_reg / j_reg.sum(0, keepdim=True),
        "lbs_weights": w / w.sum(1, keepdim=True),
        "joint_regressor": kp / kp.sum(0, keepdim=True),
    }


def uniform_clips(seed: int, count: int, frames: int, size: int, device) -> torch.Tensor:
    """(count, frames, size, size, 3) f32 frames uniform in [-1, 1]."""
    g = generator(seed, "clips", device)
    x = torch.rand((count, frames, size, size, 3), generator=g, device=device)
    return x.mul_(2.0).sub_(1.0)


def train_batches(seed: int, count: int, b: int, t: int, feature_dim: int,
                  image_size: int, num_kps: int, pool: int, device) -> List[Dict]:
    """``count`` distinct batches: phis (B, T, C) >= 0 or images (B, T, S,
    S, 3) in [-1, 1] (``image_size`` > 0), keypoints in [-1, 1] with 10%
    hidden, axis-angle poses of scale 0.3 (the mocap pool's too), shapes of
    scale 0.5, 3-D joints of scale 0.3, and the 3-D labels on about half
    the tubes."""
    g = generator(seed, "batches", device)
    u = lambda *s: torch.rand(s, generator=g, device=device)
    n = lambda *s: torch.randn(s, generator=g, device=device)
    out = []
    for _ in range(count):
        if image_size:
            x = u(b, t, image_size, image_size, 3).mul_(2.0).sub_(1.0)
        else:
            x = n(b, t, feature_dim).abs_()
        kps = torch.cat([u(b, t, num_kps, 2) * 2 - 1,
                         (u(b, t, num_kps, 1) > 0.1).float()], -1)
        out.append({
            "phis": x, "kps": kps, "poses_gt": n(b, t, 24, 3) * 0.3,
            "shapes_gt": n(b, 10) * 0.5, "joints_gt": n(b, t, 14, 3) * 0.3,
            "has_3d_joints": (u(b) > 0.5).float(),
            "has_3d_smpl": (u(b) > 0.5).float(),
            "poses_real": n(pool, 24, 3) * 0.3,
        })
    return out
