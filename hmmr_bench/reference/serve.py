"""The served clip, plain PyTorch: the int8 ResNet-50 v2 with static scales,
then HMMR's windowed prediction.

The int8 encoder's scheme (post-training quantisation as the JAX bench
serves it):

- weights symmetric per output channel, s_w = max|w| / Q + 1e-12, with the
  following BatchNorm's multiplier folded into conv1's and conv2's dequant;
- activations symmetric per tensor, with static scales: the max of |x| / Q
  + 1e-12 seen on calibration frames by the same trunk with dynamic scales
  (the root's output, and per unit the pre-activation, conv1's and conv2's
  outputs and the unit's output);
- the root 7x7/2 conv and its bias in bf16 with fp32 accumulation, then the
  "SAME" 3x3/2 max pool; the residual stream, shortcuts and the
  pre-activation's multiply and add in bf16; int32 accumulation; the head's
  mean in fp32, rounded to bf16.

Q is 127 (int8); ``bits=4`` gives Q = 7, the control's precision. Integer
convolutions run in float64, where every sum of int8 products is exact.

The window model runs in the configuration's precision (bf16 for
``bf16_temporal``) and follows HMMR's tester: zero padding of margin = (fov-1)/2
frames in front and the fill at the back, windows of T frames in groups of
B, each window's centre g = T - 2 margin frames kept; the delta heads are
projected with the present camera.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from hmmr_bench.reference import model as M
from hmmr_bench.reference.smpl import orth_proj, smpl

bf16 = torch.bfloat16


def _q(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _fold_bn(P, pre: str):
    a = P[pre + "gamma"] * torch.rsqrt(P[pre + "moving_variance"] + M.BN_EPS)
    return a, P[pre + "beta"] - P[pre + "moving_mean"] * a


def quantise_weights(P, bits: int = 8) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per unit: the integer weights (OIHW, float64) of each conv, their
    dequant multipliers and biases, and the folded pre-activation."""
    qmax = _q(bits)
    out = {}

    def quant(w):
        s = w.abs().amax(dim=(1, 2, 3)) / qmax + 1e-12
        return torch.round(w / s[:, None, None, None]).clamp(-qmax, qmax).double(), s

    for pre, stride, din, depth, _db in M.resnet_units():
        p = M.R + pre
        u = {"stride": stride}
        u["pa"], u["pb"] = _fold_bn(P, p + "preact.")
        for conv in ("conv1", "conv2"):
            q, s = quant(P[p + conv + ".weight"])
            a, b = _fold_bn(P, p + conv + "_bn.")
            u[conv] = (q, s * a, b)
        q, s = quant(P[p + "conv3.weight"])
        u["conv3"] = (q, s, P[p + "conv3.bias"])
        if depth != din:
            q, s = quant(P[p + "shortcut.weight"])
            u["shortcut"] = (q, s, P[p + "shortcut.bias"])
        out[pre] = u
    out["postnorm"] = _fold_bn(P, M.R + "postnorm.")
    return out


def _conv_int(q: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Exact integer convolution of NCHW integer values (float64 sums)."""
    return F.conv2d(q.double(), w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _ch(v: torch.Tensor) -> torch.Tensor:
    return v.double()[:, None, None]


def _fma(acc, mul, add) -> torch.Tensor:
    """fp32(acc) * mul + add per output channel, rounded once to fp32."""
    return (acc.float().double() * _ch(mul) + _ch(add)).float()


def _mul_add(acc, mul, add) -> torch.Tensor:
    """fp32(acc) * mul, rounded to fp32, then + add, rounded again."""
    return (acc.float() * mul.float()[:, None, None]) + add.float()[:, None, None]


def _scale(x: torch.Tensor, qmax: float) -> torch.Tensor:
    return x.abs().amax().float() / qmax + 1e-12


def _root(P, images: torch.Tensor) -> torch.Tensor:
    """The bf16 root: the 7x7/2 conv on bf16 operands accumulated in fp32 and
    rounded to bf16 (cuDNN's bf16 convolution on a GPU, with the weights
    laid out HWIO as the trunk stores them), its bf16 bias, the max pool."""
    x = images.to(bf16).permute(0, 3, 1, 2)
    w = P[M.R + "conv1.weight"].permute(2, 3, 1, 0).to(bf16).permute(3, 2, 0, 1)
    if x.is_cuda:
        y = F.conv2d(x, w, stride=2, padding=3)
    else:
        y = F.conv2d(x.float(), w.float(), stride=2, padding=3).to(bf16)
    return M.max_pool_same(y + P[M.R + "conv1.bias"].to(bf16)[:, None, None])


def _preact(x, u):
    """relu(x * A + B) in bf16 arithmetic, A and B rounded to bf16."""
    return torch.relu(x * u["pa"].to(bf16)[:, None, None]
                      + u["pb"].to(bf16)[:, None, None])


def calibrate(P, Wq, images: torch.Tensor, bits: int = 8) -> Dict[str, torch.Tensor]:
    """The static scales: the trunk with dynamic per-tensor scales on the
    calibration frames, each conv's dequantised output stored in bf16 and
    quantised from it (x / bf16(s) in bf16), max|x| / Q + 1e-12 observed
    at the root's output and per unit at the pre-activation, conv1's and
    conv2's outputs and the unit's output."""
    qmax = _q(bits)

    def quant(x, s):
        return torch.round((x.to(bf16) / s.to(bf16)).float()).clamp(-qmax, qmax)

    seen = {}
    x = _root(P, images)
    seen["root/out"] = _scale(x, qmax)
    for pre, stride, _din, _depth, _db in M.resnet_units():
        u = Wq[pre]
        p = _preact(x, u)
        s_p = _scale(p, qmax)
        qp = quant(p, s_p)
        if "shortcut" in u:
            w, m, a = u["shortcut"]
            sc = _mul_add(_conv_int(qp, w, stride), s_p * m, a).to(bf16)
        else:
            sc = x[:, :, ::stride, ::stride]
        w, m, a = u["conv1"]
        h = torch.relu(_mul_add(_conv_int(qp, w, 1), s_p * m, a).to(bf16))
        s_h1 = _scale(h, qmax)
        w, m, a = u["conv2"]
        h = torch.relu(_mul_add(_conv_int(quant(h, s_h1), w, stride), s_h1 * m, a)
                       .to(bf16))
        s_h2 = _scale(h, qmax)
        w, m, a = u["conv3"]
        x = sc + _mul_add(_conv_int(quant(h, s_h2), w, 1), s_h2 * m, a).to(bf16)
        seen.update({pre + "preact": s_p, pre + "conv1": s_h1, pre + "conv2": s_h2,
                     pre + "out": _scale(x, qmax)})
    return seen


def trunk(P, Wq, images: torch.Tensor, scales: Dict, bits: int = 8) -> torch.Tensor:
    """(N, H, W, 3) [-1, 1] frames -> (N, 2048) phi with static scales: each
    requantisation one multiply-add, acc * (s_in * s_w / s_out) + b / s_out
    rounded once, then rounded to the integer grid; each dequantisation
    acc * (s_in * s_w) + b rounded once to fp32, then to bf16."""
    qmax = _q(bits)
    x = _root(P, images)
    for pre, stride, _din, _depth, _db in M.resnet_units():
        u = Wq[pre]
        s_p = scales[pre + "preact"]
        s_h1, s_h2 = scales[pre + "conv1"], scales[pre + "conv2"]
        qp = torch.round(_preact(x, u).float() / s_p).clamp(0.0, qmax)
        if "shortcut" in u:
            w, m, a = u["shortcut"]
            sc = _fma(_conv_int(qp, w, stride), s_p * m, a).to(bf16)
        else:
            sc = x[:, :, ::stride, ::stride]
        w, m, a = u["conv1"]
        h = torch.round(_fma(_conv_int(qp, w, 1), s_p * m / s_h1, a / s_h1)).clamp(0.0, qmax)
        w, m, a = u["conv2"]
        h = torch.round(_fma(_conv_int(h, w, stride), s_h1 * m / s_h2, a / s_h2)
                        ).clamp(0.0, qmax)
        w, m, a = u["conv3"]
        x = sc + _fma(_conv_int(h, w, 1), s_h2 * m, a).to(bf16)
    a, b = Wq["postnorm"]
    x = torch.relu(x * a.to(bf16)[:, None, None] + b.to(bf16)[:, None, None])
    x = x.permute(0, 2, 3, 1).contiguous()        # the mean over NHWC's (H, W)
    return x.float().mean(dim=(1, 2)).to(bf16).float()


def encode(P, clip: torch.Tensor, calibration: torch.Tensor, bits: int = 8,
           chunk: int = 60) -> torch.Tensor:
    """Static scales from ``calibration``, then the clip's phi in chunks."""
    Wq = quantise_weights(P, bits)
    scales = calibrate(P, Wq, calibration, bits)
    return torch.cat([trunk(P, Wq, clip[i:i + chunk], scales, bits)
                      for i in range(0, len(clip), chunk)])


def predict(P, smpl_model, phi: torch.Tensor, batch_size: int = 8,
            seq_length: int = 20, num_conv_layers: int = 3,
            dtype=torch.float32, rows_per_call: int = 64) -> Dict[str, torch.Tensor]:
    """phi (N, C) -> per-frame outputs (N, ...): omegas, verts, kps and the
    delta heads' (N, 2, ...). The window model runs in ``dtype`` (its
    weights and activations rounded to it, GroupNorm in fp32); the omegas
    go to fp32 before SMPL."""
    n = len(phi)
    fov = 4 * num_conv_layers + 1
    margin = (fov - 1) // 2
    g = seq_length - 2 * margin
    count = -(-n // (g * batch_size))
    windows = count * batch_size
    fill = windows * g + seq_length - n
    padded = F.pad(phi, (0, 0, margin, fill)).to(dtype)
    tail = {k: v.to(dtype) for k, v in P.items() if not k.startswith(M.R)}
    idx = (torch.arange(windows, device=phi.device)[:, None] * g
           + torch.arange(seq_length, device=phi.device))
    outs = {k: [] for k in ("omegas", "verts", "kps")}
    for w0 in range(0, windows, rows_per_call):
        win = padded[idx[w0:w0 + rows_per_call]]          # (W, T, C)
        movie = M.temporal_encoder(tail, win, num_conv_layers)
        present, deltas = M.heads(tail, movie, True, None)
        stacked = torch.stack([present] + [deltas[dt] for dt in M.DELTA_TS]).float()
        stacked = stacked[:, :, margin:margin + g]        # (3, W, g, 85)
        h, w = stacked.shape[:2]
        flat = stacked.reshape(-1, M.OMEGA_DIM)
        verts, joints, _ = smpl(smpl_model, flat[:, 75:], flat[:, 3:75])
        cam = stacked[0, ..., :3].expand(h, w, g, 3).reshape(-1, 3)
        kps = orth_proj(joints, cam)
        for k, v in (("omegas", flat), ("verts", verts), ("kps", kps)):
            outs[k].append(v.reshape((h, w * g) + v.shape[1:]))
    out = {}
    for k, parts in outs.items():
        v = torch.cat(parts, 1)[:, :n]                    # (3, N, ...)
        out[k] = v[0]
        out[k + "_delta"] = torch.movedim(v[1:], 0, 1)    # (N, 2, ...)
    return out
