"""Int8 ResNet-50 v2 inference (post-training quantisation), inference only.

Counterpart of ``human_dynamics_tpu/models/resnet_int8.py``, with the same
scheme and the same expression order, so that the two agree bit for bit on
the XLA path:

- Weights: per-output-channel symmetric int8, s_w = max|w| / 127 + 1e-12.
- BatchNorm folded: BN(y) = y*A + B; conv1/conv2's A is folded into the
  dequant multiplier.
- Activations: symmetric int8 per tensor, either dynamic (max|x| / 127 +
  1e-12 on every call, ``apply_int8``) or static, calibrated once
  (``calibrate_int8_scales`` -> ``apply_int8_static``), where every
  dequant + requant pair is one per-channel epilogue of the int8 conv.
- The root 7x7/2 conv stays bf16 (cuDNN on a GPU: XLA does it in the JAX
  package), then the XLA "SAME" 3x3/2 max pool. The elementwise work runs
  in bf16, conv accumulators are int32, the final mean is f32.
- ``use_pallas=True`` runs every stride-1 unit of blocks 2-4 through K2
  (``ops.resnet_int8_cuda.fused_block``), whose preact is f32 and whose
  multiply-adds are fused, exactly as the JAX Pallas kernel's.
- On the static path every unit's int8 pre-activation, except the first
  unit's (its input is the root pool's), is quantised by the previous
  unit's last conv from the bf16 value it stores: bit-identical to a
  separate pass over that value, without re-reading it.

Tensors are NHWC and weights HWIO, with the JAX key names
('block1/unit_1/bottleneck_v2/conv1/wq', ...). The convs run through
``ops.resnet_int8_cuda``: the CUDA kernels for CUDA tensors, the plain
versions on the CPU.

Not ported: ``int8_root`` (the s2d / wfold / u8 stems, and their
``root/wq_s2d``, ``root/wq_wfold``, ``root/scale_*`` weights) and
``int8_stream`` (ROADMAP "Remaining work").
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from human_dynamics_tpu_torch.models.resnet import (
    RESNET50_BLOCKS,
    ResNetV2_50,
    SlimBatchNorm,
    max_pool_same,
)
from human_dynamics_tpu_torch.ops.resnet_int8_cuda import (
    Preact,
    conv_s8,
    fused_block_pq,
    hwio_to_kmajor,
    preact_quant,
    prepare_pallas_unit,
    unit_preact,
)

BLOCKS = RESNET50_BLOCKS
BN_EPS = 1e-5
# prepare_int8_params keys of the JAX package that belong to int8_root.
INT8_ROOT_KEYS = ("root/wq_s2d", "root/scale_s2d", "root/wq_wfold",
                  "root/scale_wfold")
_NOT_PORTED = (
    "{} is not ported (ROADMAP 'Remaining work': int8_root and "
    "int8_stream wait for an H100 measurement that asks for them)"
)

bf16 = torch.bfloat16


def _unit_prefixes():
    """(block index, unit index, stride, prefix) of every unit, in order."""
    for bi, (num_units, _depth, _db) in enumerate(BLOCKS, start=1):
        for ui in range(1, num_units + 1):
            stride = 2 if (ui == num_units and bi < len(BLOCKS)) else 1
            yield bi, ui, stride, f"block{bi}/unit_{ui}/bottleneck_v2/"


def _fold_bn(bn: SlimBatchNorm):
    """(gamma, beta, moving stats) -> (A, B) with y_bn = y*A + B."""
    a = bn.gamma * torch.rsqrt(bn.moving_variance + BN_EPS)
    b = bn.beta - bn.moving_mean * a
    return a.float(), b.float()


def _quant_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 of an HWIO kernel."""
    s = w.abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return q, s.float()


def _hwio(conv) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


@torch.no_grad()
def prepare_int8_params(resnet: ResNetV2_50) -> Dict[str, torch.Tensor]:
    """Fold BatchNorm and quantise the weights of a ResNetV2_50, on its
    device. Keys as the JAX package's, without the int8_root ones."""
    out: Dict[str, torch.Tensor] = {
        "root/w": _hwio(resnet.conv1).to(bf16),
        "root/b": resnet.conv1.bias.to(bf16),
        "root/b32": resnet.conv1.bias.float(),
    }
    for bi, ui, _stride, pre in _unit_prefixes():
        unit = getattr(resnet, f"block{bi}")[f"unit_{ui}"]
        out[pre + "preact/A"], out[pre + "preact/B"] = _fold_bn(unit.preact)
        for conv, bn in (("conv1", unit.conv1_bn), ("conv2", unit.conv2_bn)):
            q, sw = _quant_weight(_hwio(getattr(unit, conv)))
            a, b = _fold_bn(bn)
            out[pre + conv + "/wq"] = q
            out[pre + conv + "/scale"] = sw * a
            out[pre + conv + "/bias"] = b
        q, sw = _quant_weight(_hwio(unit.conv3))
        out[pre + "conv3/wq"] = q
        out[pre + "conv3/scale"] = sw
        out[pre + "conv3/bias"] = unit.conv3.bias.float()
        if unit.shortcut is not None:
            q, sw = _quant_weight(_hwio(unit.shortcut))
            out[pre + "shortcut/wq"] = q
            out[pre + "shortcut/scale"] = sw
            out[pre + "shortcut/bias"] = unit.shortcut.bias.float()
    out["postnorm/A"], out["postnorm/B"] = _fold_bn(resnet.postnorm)
    # Fresh tensors: a float() of an fp32 parameter is the parameter itself.
    return {k: v.detach().clone() for k, v in out.items()}


def kmajor_weights(qp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every conv's int8 weight in the kernels' (Cout, K) layout, keyed
    like qp with '/wt' for '/wq'."""
    return {k[:-3] + "/wt": hwio_to_kmajor(v)
            for k, v in qp.items() if k.endswith("/wq")}


def _quant_act(x: torch.Tensor):
    """Dynamic per-tensor symmetric int8; the division is in x's dtype."""
    s = x.abs().amax().float() / 127.0 + 1e-12
    q = torch.round(x / s.to(x.dtype)).clamp(-127, 127).to(torch.int8)
    return q, s


def _root(qp, images: torch.Tensor) -> torch.Tensor:
    """bf16 conv2d_same 7x7/2 + bias, then the 3x3/2 SAME max pool; NHWC."""
    x = images.to(bf16).permute(0, 3, 1, 2)
    w = qp["root/w"].permute(3, 2, 0, 1)
    if x.is_cuda:
        # cuDNN: bf16 operands, f32 accumulation, rounded once to bf16.
        y = F.conv2d(x, w, stride=2, padding=3)
    else:
        y = F.conv2d(x.float(), w.float(), stride=2, padding=3).to(bf16)
    y = y + qp["root/b"][:, None, None]
    return max_pool_same(y).permute(0, 2, 3, 1).contiguous()


def _head(qp, x: torch.Tensor) -> torch.Tensor:
    """bf16 postnorm + ReLU, then the f32 spatial mean -> bf16 -> f32."""
    x = torch.relu(x * qp["postnorm/A"].to(bf16) + qp["postnorm/B"].to(bf16))
    return x.float().mean(dim=(1, 2)).to(bf16).float()


def _subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    return x if stride == 1 else x[:, ::stride, ::stride, :].contiguous()


def _scale(s: torch.Tensor) -> torch.Tensor:
    return s.reshape(()).float()


# ---------------------------------------------------------------------------
# Dynamic scales (and calibration)
# ---------------------------------------------------------------------------


def _apply_dynamic(qp, wt, images, observe: Optional[Dict] = None):
    x = _root(qp, images)
    if observe is not None:
        observe["root/out"] = x.abs().amax().float() / 127.0 + 1e-12
    depth_in = x.shape[-1]
    for bi, _ui, stride, pre in _unit_prefixes():
        depth = BLOCKS[bi - 1][1]
        preact = torch.relu(x * qp[pre + "preact/A"].to(bf16)
                            + qp[pre + "preact/B"].to(bf16))
        pq, s_p = _quant_act(preact)
        if depth == depth_in:
            shortcut = _subsample(x, stride)
        else:
            shortcut = conv_s8(pq, wt[pre + "shortcut/wt"], stride,
                               epilogue="dequant",
                               mul=s_p * qp[pre + "shortcut/scale"],
                               add=qp[pre + "shortcut/bias"])
        h = conv_s8(pq, wt[pre + "conv1/wt"], 1, epilogue="dequant",
                    mul=s_p * qp[pre + "conv1/scale"],
                    add=qp[pre + "conv1/bias"], relu=True)
        hq, s_h = _quant_act(h)
        h = conv_s8(hq, wt[pre + "conv2/wt"], stride, epilogue="dequant",
                    mul=s_h * qp[pre + "conv2/scale"],
                    add=qp[pre + "conv2/bias"], relu=True)
        hq, s_h2 = _quant_act(h)
        x = conv_s8(hq, wt[pre + "conv3/wt"], 1, epilogue="dequant",
                    mul=s_h2 * qp[pre + "conv3/scale"],
                    add=qp[pre + "conv3/bias"], residual=shortcut)
        if observe is not None:
            observe[pre + "preact"] = s_p
            observe[pre + "conv1"] = s_h
            observe[pre + "conv2"] = s_h2
            observe[pre + "out"] = x.abs().amax().float() / 127.0 + 1e-12
        depth_in = depth
    return _head(qp, x)


@torch.no_grad()
def apply_int8(qp: Dict[str, torch.Tensor], images: torch.Tensor,
               _observe: Optional[Dict[str, torch.Tensor]] = None,
               _wt: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(N, H, W, 3) [-1, 1] images -> (N, 2048) f32 phi, dynamic scales.

    ``_observe`` collects the per-tensor scales (calibration); ``_wt`` are
    precomputed ``kmajor_weights(qp)``.
    """
    wt = kmajor_weights(qp) if _wt is None else _wt
    return _apply_dynamic(qp, wt, images, _observe)


def calibrate_int8_scales(qp: Dict[str, torch.Tensor], images: torch.Tensor,
                          margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """Per-tensor activation scales observed by the dynamic trunk on a
    calibration batch: root/out, and preact/conv1/conv2/out per unit.
    ``margin`` multiplies every scale; ``merge_calibrations`` combines
    batches."""
    scales: Dict[str, torch.Tensor] = {}
    apply_int8(qp, images, _observe=scales)
    if margin != 1.0:
        scales = {k: v * margin for k, v in scales.items()}
    return scales


def merge_calibrations(*scale_dicts) -> Dict[str, torch.Tensor]:
    """Elementwise max across per-batch calibration dicts."""
    out = dict(scale_dicts[0])
    for d in scale_dicts[1:]:
        for k, v in d.items():
            out[k] = torch.maximum(out[k], v)
    return out


# ---------------------------------------------------------------------------
# Static scales
# ---------------------------------------------------------------------------


def _xla_unit(qp, scales, pre, stride, has_shortcut):
    """The operands of one unit on the XLA path: the requant multipliers
    (s_x * scale) / s_out and biases / s_out, composed in f32."""
    s_p = _scale(scales[pre + "preact"])
    s_h1 = _scale(scales[pre + "conv1"])
    s_h2 = _scale(scales[pre + "conv2"])
    u = {
        "kind": "xla", "stride": stride,
        "pa": qp[pre + "preact/A"].to(bf16).float(),
        "pb": qp[pre + "preact/B"].to(bf16).float(),
        "s_p": s_p.reshape(1),
        "w1": hwio_to_kmajor(qp[pre + "conv1/wq"]),
        "m1": s_p * qp[pre + "conv1/scale"] / s_h1,
        "a1": qp[pre + "conv1/bias"] / s_h1,
        "w2": hwio_to_kmajor(qp[pre + "conv2/wq"]),
        "m2": s_h1 * qp[pre + "conv2/scale"] / s_h2,
        "a2": qp[pre + "conv2/bias"] / s_h2,
        "w3": hwio_to_kmajor(qp[pre + "conv3/wq"]),
        "m3": s_h2 * qp[pre + "conv3/scale"],
        "a3": qp[pre + "conv3/bias"],
    }
    if has_shortcut:
        u["wsc"] = hwio_to_kmajor(qp[pre + "shortcut/wq"])
        u["msc"] = s_p * qp[pre + "shortcut/scale"]
        u["asc"] = qp[pre + "shortcut/bias"]
    return u


def _step_preact(step: Dict) -> Preact:
    """The pre-activation of a plan step's first unit."""
    if step["kind"] == "k2":
        return unit_preact(step["params"][0])
    return Preact(step["pa"], step["pb"], step["s_p"], 1)


@torch.no_grad()
def prepare_int8_static(qp: Dict[str, torch.Tensor],
                        scales: Dict[str, torch.Tensor],
                        use_pallas: bool = False,
                        pallas_blocks: tuple = (2, 3, 4)) -> Dict:
    """Everything ``apply_int8_static`` derives from (qp, scales), computed
    once: per unit the kernels' k-major weights and composed multipliers,
    with consecutive K2-eligible units (stride 1, Cb >= 128, block in
    ``pallas_blocks``) gathered into one chain per block. Each step's
    "next" is the ``Preact`` of the unit after it (None for the last),
    which its last conv quantises; "first" is the first unit's, the one
    standalone pre-activation pass."""
    steps: List[Dict] = []
    chain: Optional[Dict] = None
    depth_in = qp["root/w"].shape[-1]
    for bi, _ui, stride, pre in _unit_prefixes():
        depth, db = BLOCKS[bi - 1][1], BLOCKS[bi - 1][2]
        has_shortcut = depth != depth_in
        depth_in = depth
        if use_pallas and stride == 1 and db >= 128 and bi in pallas_blocks:
            if chain is None:
                chain = {"kind": "k2", "params": [], "specs": []}
                steps.append(chain)
            chain["params"].append(
                prepare_pallas_unit(qp, scales, pre, has_shortcut))
            chain["specs"].append(has_shortcut)
            continue
        chain = None
        steps.append(_xla_unit(qp, scales, pre, stride, has_shortcut))
    for step, following in zip(steps, steps[1:] + [None]):
        step["next"] = None if following is None else _step_preact(following)
    head = {k: qp[k] for k in ("root/w", "root/b", "postnorm/A", "postnorm/B")}
    return {"head": head, "first": _step_preact(steps[0]), "steps": steps}


@torch.no_grad()
def run_int8_static(plan: Dict, images: torch.Tensor) -> torch.Tensor:
    """The static-scale trunk on a ``prepare_int8_static`` plan: one
    standalone pre-activation pass, after the root; every later one is
    fused into the conv that produces its input."""
    x = _root(plan["head"], images)
    first = plan["first"]
    pq = preact_quant(x, first.pa, first.pb, first.s, mode=first.mode)
    for u in plan["steps"]:
        if u["kind"] == "k2":
            x, pq = fused_block_pq(x, u["params"], h=x.shape[1],
                                   w=x.shape[2], unit_specs=tuple(u["specs"]),
                                   pq=pq, next_preact=u["next"])
            continue
        stride = u["stride"]
        if "wsc" in u:
            shortcut = conv_s8(pq, u["wsc"], stride, epilogue="dequant",
                               mul=u["msc"], add=u["asc"])
        else:
            shortcut = _subsample(x, stride)
        h = conv_s8(pq, u["w1"], 1, epilogue="requant", mul=u["m1"],
                    add=u["a1"], relu=True)
        h = conv_s8(h, u["w2"], stride, epilogue="requant", mul=u["m2"],
                    add=u["a2"], relu=True)
        out = conv_s8(h, u["w3"], 1, epilogue="dequant", mul=u["m3"],
                      add=u["a3"], residual=shortcut, preact=u["next"])
        x, pq = out if u["next"] is not None else (out, None)
    return _head(plan["head"], x)


def apply_int8_static(qp: Dict[str, torch.Tensor],
                      scales: Dict[str, torch.Tensor], images: torch.Tensor,
                      use_pallas: bool = False,
                      pallas_blocks: tuple = (2, 3, 4),
                      int8_stream=False, int8_root=False) -> torch.Tensor:
    """Static-scale int8 trunk: (N, H, W, 3) [-1, 1] -> (N, 2048) f32 phi.

    ``use_pallas`` runs the stride-1 units of ``pallas_blocks`` through K2.
    ``int8_stream`` and ``int8_root`` are not ported and raise.
    """
    if int8_stream:
        raise NotImplementedError(_NOT_PORTED.format("int8_stream"))
    if int8_root:
        raise NotImplementedError(_NOT_PORTED.format("int8_root"))
    plan = prepare_int8_static(qp, scales, use_pallas, pallas_blocks)
    return run_int8_static(plan, images)
