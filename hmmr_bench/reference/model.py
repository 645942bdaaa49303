"""HMMR's networks as functions of a dict of tensors, plain PyTorch.

Names and shapes are the port's ``state_dict`` keys (``param_specs``), so
that the weights the benchmark makes load into both sides. The ResNet is
slim's resnet_v2_50 (pre-activation bottlenecks, "SAME" 3x3/2 max pool
after the 7x7/2 root); the temporal encoder is AZ_FC2GN (three residual
blocks of GroupNorm(32) -> ReLU -> conv1d[3]); IEF is three additive stages
of fc1024 -> dropout -> fc1024 -> dropout -> fc; the hallucinator is three
fc layers added to phi; the pose discriminator is HMR's (shared per-joint
fc32 layers, 23 per-joint heads and an all-joints fc1024-fc1024-fc1 head).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

RESNET_BLOCKS = ((3, 256, 64), (4, 512, 128), (6, 1024, 256), (3, 2048, 512))
OMEGA_DIM = 85
DELTA_TS = (-5, 5)
NUM_STAGE = 3
BN_EPS = 1e-5
GN_EPS = 1e-6
R = "resnet_v2_50."


def resnet_units():
    """(prefix, stride, depth_in, depth, depth_bottleneck) of every unit."""
    depth_in = 64
    for bi, (n, depth, db) in enumerate(RESNET_BLOCKS, 1):
        for ui in range(1, n + 1):
            stride = 2 if ui == n and bi < len(RESNET_BLOCKS) else 1
            yield f"block{bi}.unit_{ui}.", stride, depth_in, depth, db
            depth_in = depth


def delta_key(dt: int) -> str:
    return f"past{abs(dt)}" if dt < 0 else f"future{dt}"


def _bn(prefix: str, c: int, specs: List) -> None:
    specs += [(prefix + "gamma", (c,), "ones"), (prefix + "beta", (c,), "zeros"),
              (prefix + "moving_mean", (c,), "zeros"),
              (prefix + "moving_variance", (c,), "ones")]


def _fc(prefix: str, n_in: int, n_out: int, specs: List, gain=1.0) -> None:
    specs += [(prefix + "weight", (n_out, n_in), ("normal", gain)),
              (prefix + "bias", (n_out,), "zeros")]


def resnet_specs() -> List[Tuple[str, tuple, object]]:
    specs = [(R + "conv1.weight", (64, 3, 7, 7), ("normal", 1.0)),
             (R + "conv1.bias", (64,), "zeros")]
    for pre, _s, din, depth, db in resnet_units():
        pre = R + pre
        _bn(pre + "preact.", din, specs)
        if depth != din:
            specs += [(pre + "shortcut.weight", (depth, din, 1, 1), ("normal", 1.0)),
                      (pre + "shortcut.bias", (depth,), "zeros")]
        specs.append((pre + "conv1.weight", (db, din, 1, 1), ("normal", 1.0)))
        _bn(pre + "conv1_bn.", db, specs)
        specs.append((pre + "conv2.weight", (db, db, 3, 3), ("normal", 1.0)))
        _bn(pre + "conv2_bn.", db, specs)
        specs += [(pre + "conv3.weight", (depth, db, 1, 1), ("normal", 1.0)),
                  (pre + "conv3.bias", (depth,), "zeros")]
    _bn(R + "postnorm.", 2048, specs)
    return specs


def hmmr_specs(feature_dim: int = 2048, include_resnet: bool = True,
               num_conv_layers: int = 3) -> List[Tuple[str, tuple, object]]:
    """(name, shape, init) of every parameter and buffer of the HMMR model
    (the port's state_dict keys). init: "zeros", "ones", "mean" or
    ("normal", gain): gain / sqrt(fan_in) times a standard normal."""
    specs = resnet_specs() if include_resnet else []
    specs.append(("mean_param", (1, OMEGA_DIM), "mean"))
    c = feature_dim
    for i in range(num_conv_layers):
        pre = f"temporal_encoder.block_{i}."
        specs += [(pre + "gn1.weight", (c,), "ones"), (pre + "gn1.bias", (c,), "zeros"),
                  (pre + "conv1.weight", (c, c, 3), ("normal", 1.0)),
                  (pre + "conv1.bias", (c,), "zeros"),
                  (pre + "gn2.weight", (c,), "ones"), (pre + "gn2.bias", (c,), "zeros"),
                  (pre + "conv2.weight", (c, c, 3), ("normal", 0.03)),
                  (pre + "conv2.bias", (c,), "zeros")]
    for i, gain in ((1, 1.0), (2, 1.0), (3, 0.03)):
        _fc(f"hallucinator.fc{i}.", c, c, specs, gain)
    for pre, n_in, n_out in [("single_view_ief.", c + OMEGA_DIM, OMEGA_DIM)] + [
            (f"ief_delta.{delta_key(dt)}.", c + 72, 72) for dt in DELTA_TS]:
        _fc(pre + "fc1.", n_in, 1024, specs)
        _fc(pre + "fc2.", 1024, 1024, specs)
        _fc(pre + "fc3.", 1024, n_out, specs, 0.1)
    return specs


def disc_specs() -> List[Tuple[str, tuple, object]]:
    specs = [("per_joint_w", (23, 32), ("normal", 1.0)),
             ("per_joint_b", (23,), "zeros")]
    _fc("D_conv1.", 9, 32, specs)
    _fc("D_conv2.", 32, 32, specs)
    _fc("D_alljoints_fc1.", 23 * 32, 1024, specs)
    _fc("D_alljoints_fc2.", 1024, 1024, specs)
    _fc("D_alljoints_out.", 1024, 1, specs)
    return specs


def fan_in(shape: tuple) -> int:
    """Inputs per output of a weight (out, in, *kernel); per_joint_w's
    (23, 32) reads its 32 channels."""
    return math.prod(shape[1:])


def mean_omega() -> torch.Tensor:
    """HMMR's mean omega without the neutral-SMPL mean file: camera
    [0.9, 0, 0], global rotation pi about x, zeros elsewhere."""
    m = torch.zeros(1, OMEGA_DIM)
    m[0, 0], m[0, 3] = 0.9, math.pi
    return m


# ---------------------------------------------------------------------------
# ResNet-50 v2 in fp32
# ---------------------------------------------------------------------------


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with "SAME" padding (the odd pad at the end), NCHW."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


def batch_norm(P, pre: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """slim BatchNorm: the batch's mean and biased variance with ``train``,
    else the moving statistics."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = P[pre + "moving_mean"], P[pre + "moving_variance"]
    inv = torch.rsqrt(var + BN_EPS) * P[pre + "gamma"]
    return x * inv[:, None, None] + (P[pre + "beta"] - mean * inv)[:, None, None]


def resnet(P, images: torch.Tensor, train_bn: bool) -> torch.Tensor:
    """(N, H, W, 3) images in [-1, 1] -> (N, 2048)."""
    x = F.conv2d(images.permute(0, 3, 1, 2), P[R + "conv1.weight"],
                 P[R + "conv1.bias"], stride=2, padding=3)
    x = max_pool_same(x)
    for pre, stride, din, depth, _db in resnet_units():
        pre = R + pre
        p = F.relu(batch_norm(P, pre + "preact.", x, train_bn))
        if depth != din:
            sc = F.conv2d(p, P[pre + "shortcut.weight"], P[pre + "shortcut.bias"],
                          stride=stride)
        else:
            sc = x[:, :, ::stride, ::stride]
        h = F.relu(batch_norm(P, pre + "conv1_bn.",
                              F.conv2d(p, P[pre + "conv1.weight"]), train_bn))
        h = F.relu(batch_norm(P, pre + "conv2_bn.",
                              F.conv2d(h, P[pre + "conv2.weight"], stride=stride,
                                       padding=1), train_bn))
        x = sc + F.conv2d(h, P[pre + "conv3.weight"], P[pre + "conv3.bias"])
    x = F.relu(batch_norm(P, R + "postnorm.", x, train_bn))
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# The temporal model and the heads
# ---------------------------------------------------------------------------


def group_norm(P, pre: str, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(32, eps 1e-6) with its statistics and normalisation in
    fp32, returned in x's dtype (flax's GroupNorm on a bf16 input)."""
    return F.group_norm(x.float(), 32, P[pre + "weight"].float(),
                        P[pre + "bias"].float(), GN_EPS).to(x.dtype)


def temporal_encoder(P, phi: torch.Tensor, num_layers: int = 3) -> torch.Tensor:
    """(B, T, C) -> movie strip (B, T, C)."""
    x = phi.transpose(1, 2)
    for i in range(num_layers):
        pre = f"temporal_encoder.block_{i}."
        h = F.relu(group_norm(P, pre + "gn1.", x))
        h = F.conv1d(h, P[pre + "conv1.weight"], P[pre + "conv1.bias"], padding=1)
        h = F.relu(group_norm(P, pre + "gn2.", h))
        x = x + F.conv1d(h, P[pre + "conv2.weight"], P[pre + "conv2.bias"],
                         padding=1)
    return x.transpose(1, 2)


def hallucinator(P, phi: torch.Tensor) -> torch.Tensor:
    h = F.relu(F.linear(phi, P["hallucinator.fc1.weight"], P["hallucinator.fc1.bias"]))
    h = F.relu(F.linear(h, P["hallucinator.fc2.weight"], P["hallucinator.fc2.bias"]))
    return F.linear(h, P["hallucinator.fc3.weight"], P["hallucinator.fc3.bias"]) + phi


def dropout(x: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Rate 0.5: keep where a uniform draw is below 0.5, scaled by 2."""
    if gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
    return torch.where(keep, x / 0.5, torch.zeros_like(x))


def ief(P, pre: str, phi: torch.Tensor, start: torch.Tensor,
        gen: Optional[torch.Generator]) -> torch.Tensor:
    """Three additive refinements of ``start`` by the shared MLP ``pre``;
    a fresh dropout mask per layer and stage when ``gen`` is given."""
    theta = start
    for _ in range(NUM_STAGE):
        h = F.relu(F.linear(torch.cat([phi, theta], 1), P[pre + "fc1.weight"],
                            P[pre + "fc1.bias"]))
        h = dropout(h, gen)
        h = F.relu(F.linear(h, P[pre + "fc2.weight"], P[pre + "fc2.bias"]))
        h = dropout(h, gen)
        theta = theta + F.linear(h, P[pre + "fc3.weight"], P[pre + "fc3.bias"])
    return theta


def heads(P, strip: torch.Tensor, with_deltas: bool,
          gen: Optional[torch.Generator]):
    """(B, T, C) strip -> present omega (B, T, 85) and {dt: (B, T, 85)}: each
    delta head regresses the 72 pose values from the present omega's pose
    and takes the camera [1, 0, 0] and the present betas."""
    b, t, c = strip.shape
    rows = strip.reshape(b * t, c)
    mean = P["mean_param"].expand(b * t, OMEGA_DIM)
    present = ief(P, "single_view_ief.", rows, mean, gen)
    deltas = {}
    if with_deltas:
        cam = torch.zeros(b * t, 3, dtype=strip.dtype, device=strip.device)
        cam[:, 0] = 1.0
        for dt in DELTA_TS:
            pose = ief(P, f"ief_delta.{delta_key(dt)}.", rows, present[:, 3:75], gen)
            deltas[dt] = torch.cat([cam, pose, present[:, -10:]], 1).reshape(
                b, t, OMEGA_DIM)
    return present.reshape(b, t, OMEGA_DIM), deltas


def hmmr(P, phi: torch.Tensor, gen: Optional[torch.Generator] = None) -> Dict:
    """phi (B, T, C) -> every head: pred, deltas from the movie strip, hal
    from the hallucinated strip (no delta heads), and both strips. Dropout
    draws in the order present, past, future, hallucinated present."""
    movie = temporal_encoder(P, phi)
    pred, deltas = heads(P, movie, True, gen)
    hal_strip = hallucinator(P, phi)
    hal, _ = heads(P, hal_strip, False, gen)
    return {"pred": pred, "deltas": deltas, "hal": hal, "movie": movie,
            "hal_strip": hal_strip}


def discriminator(P, poses_rot: torch.Tensor) -> torch.Tensor:
    """(N, 23, 9) rotations of the non-root joints -> (N, 24) logits."""
    n = poses_rot.shape[0]
    x = F.relu(F.linear(poses_rot.reshape(n, 23, 9), P["D_conv1.weight"],
                        P["D_conv1.bias"]))
    x = F.relu(F.linear(x, P["D_conv2.weight"], P["D_conv2.bias"]))
    per_joint = torch.einsum("njh,jh->nj", x, P["per_joint_w"]) + P["per_joint_b"]
    h = F.relu(F.linear(x.reshape(n, -1), P["D_alljoints_fc1.weight"],
                        P["D_alljoints_fc1.bias"]))
    h = F.relu(F.linear(h, P["D_alljoints_fc2.weight"], P["D_alljoints_fc2.bias"]))
    out = F.linear(h, P["D_alljoints_out.weight"], P["D_alljoints_out.bias"])
    return torch.cat([per_joint, out], 1)
