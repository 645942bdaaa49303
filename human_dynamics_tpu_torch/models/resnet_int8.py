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
- ``int8_root`` (static scales) quantises the stem instead: the 7x7/2 conv
  as the exact 4x4/1 conv over the space-to-depth view (True, weights
  ``root/wq_s2d``), as the (7, 4)/(2, 1) conv over the width-folded view
  ("wfold", ``root/wq_wfold``), or that conv on raw uint8 frames as u ^
  0x80 with an exact border-correction map in the bias ("u8"); its epilogue
  requantises to int8 with ``root/out``'s scale, and the max pool runs on
  int8, in the same kernel (``ops.int8_root_cuda.root_stem_pool``).
- ``int8_stream`` (static scales; True or a tuple of blocks) carries the
  residual stream of those blocks as int8 with per-unit ``out`` scales:
  a quantise or dequantise pass at block boundaries, the pre-activation
  read from the int8 stream, and conv3's epilogue fused with the residual
  add and the requantisation (``conv_s8``'s "stream" epilogue). K2 takes
  only the blocks that are not streamed.
- ``use_pallas=True`` runs every stride-1 unit of blocks 2-4 through K2
  (``ops.resnet_int8_cuda.fused_block``), whose preact is f32 and whose
  multiply-adds are fused, exactly as the JAX Pallas kernel's.
- On the static path every unit's int8 pre-activation is quantised by
  whatever produced its input, from the value it stores: the previous
  unit's last conv (bf16 or int8 stream) or the int8 root's pool; only
  where JAX quantises from a value no kernel stores (after the bf16 root,
  and after a bf16 -> int8 block boundary's quantise pass) is it a
  standalone pass. Bit-identical to a separate pass over that value.

- Where XLA contracts a multiply-add on the CPU in the JAX package's
  jitted program, the port fuses it too: every static-path requant and
  dequant epilogue, the int8 stem's epilogue, the u8 stem's float snap and
  border map, the stream's pre-activation, its conv3 epilogue and
  shortcut add, and the streamed postnorm. XLA also
  rewrites a division by a constant as a multiply by its float32
  reciprocal (``w_scale / 127.0``, ``/ 255.0``), which the plan copies.

Tensors are NHWC and weights HWIO, with the JAX key names
('block1/unit_1/bottleneck_v2/conv1/wq', ...). The convs run through
``ops.resnet_int8_cuda`` and the int8 stem and pool through
``ops.int8_root_cuda``: the CUDA kernels for CUDA tensors, the plain
versions on the CPU.
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
from human_dynamics_tpu_torch.ops.int8_root_cuda import (
    border_mask,
    root_conv_reference,
    root_stem_pool,
)
from human_dynamics_tpu_torch.ops.resnet_int8_cuda import (
    Preact,
    conv_s8,
    fma_reference,
    fused_block_pq,
    hwio_to_kmajor,
    preact_quant,
    prepare_pallas_unit,
    unit_preact,
)

BLOCKS = RESNET50_BLOCKS
BN_EPS = 1e-5
# prepare_int8_params keys that belong to int8_root.
INT8_ROOT_KEYS = ("root/wq_s2d", "root/scale_s2d", "root/wq_wfold",
                  "root/scale_wfold")
INT8_ROOTS = (False, True, "wfold", "u8")

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


def _s2d_root_weights(w: torch.Tensor) -> torch.Tensor:
    """The root 7x7/2 conv (HWIO) as the exact 4x4/1 conv over the
    space-to-depth view (``_s2d``): original tap (ky, kx) goes to s2d tap
    (ay, ax) and phase (dy, dx) with ky - 3 = 2 (ay - 2) + dy; the unused
    slots are zero."""
    c = w.shape[2]
    w2 = w.new_zeros((4, 4, 4 * c, w.shape[-1]))
    for ky in range(7):
        dy = (ky - 3) % 2
        ay = (ky - 3 - dy) // 2 + 2
        for kx in range(7):
            dx = (kx - 3) % 2
            ax = (kx - 3 - dx) // 2 + 2
            c2 = (dy * 2 + dx) * c
            w2[ay, ax, c2:c2 + c, :] = w[ky, kx]
    return w2


def _s2d(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), 2x2 phase-major."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def _wfold_root_weights(w: torch.Tensor) -> torch.Tensor:
    """The root 7x7/2 conv (HWIO) as the (7, 4)/(2, 1) conv over the
    width-paired view (``_wfold``): tap kx goes to folded column
    (kx + 1) // 2, phase (kx + 1) % 2 (channel slot phase * C + c)."""
    k, _, c, o = w.shape
    if k != 7:
        raise ValueError(f"the width fold takes the 7x7 root, got {k}x{k}")
    w2 = w.new_zeros((7, 4, 2 * c, o))
    for kx in range(7):
        a, p = (kx + 1) // 2, (kx + 1) % 2
        w2[:, a, p * c:(p + 1) * c, :] = w[:, kx]
    return w2


def _wfold(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W/2, 2C): a reshape in NHWC."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w // 2, 2 * c)


@torch.no_grad()
def prepare_int8_params(resnet: ResNetV2_50) -> Dict[str, torch.Tensor]:
    """Fold BatchNorm and quantise the weights of a ResNetV2_50, on its
    device. Keys as the JAX package's, the int8_root stems' included."""
    w_root = _hwio(resnet.conv1)
    wq_s2d, s_s2d = _quant_weight(_s2d_root_weights(w_root))
    wq_wf, s_wf = _quant_weight(_wfold_root_weights(w_root))
    out: Dict[str, torch.Tensor] = {
        "root/w": w_root.to(bf16),
        "root/b": resnet.conv1.bias.to(bf16),
        "root/wq_s2d": wq_s2d,
        "root/scale_s2d": s_s2d,
        "root/wq_wfold": wq_wf,
        "root/scale_wfold": s_wf,
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

# XLA rewrites a division by a constant into a multiply by its float32
# reciprocal inside the JAX package's jitted program (w_scale / 127.0,
# w_scale / 255.0); w_scale * (2.0 / 255.0) is a multiply by the constant.
_RECIP_127 = 1.0 / 127.0
_RECIP_255 = 1.0 / 255.0
_TWO_OVER_255 = 2.0 / 255.0


def _stream_blocks(int8_stream) -> tuple:
    """The blocks ``int8_stream`` carries as int8 (True: all four)."""
    blocks = ((1, 2, 3, 4) if int8_stream is True
              else tuple(int8_stream) if int8_stream else ())
    if any(b not in (1, 2, 3, 4) for b in blocks):
        raise ValueError(f"int8_stream={int8_stream!r}: blocks are 1-4")
    return blocks


def _check_int8_root(int8_root):
    if not any(int8_root is r or (isinstance(r, str) and int8_root == r)
               for r in INT8_ROOTS):
        raise ValueError(f"int8_root={int8_root!r}; want one of {INT8_ROOTS}")


def _xla_unit(qp, scales, pre, stride, has_shortcut):
    """The operands of one unit on the XLA path: the requant multipliers
    (s_x * scale) / s_out and biases / s_out, composed in f32."""
    s_p = _scale(scales[pre + "preact"])
    s_h1 = _scale(scales[pre + "conv1"])
    s_h2 = _scale(scales[pre + "conv2"])
    u = {
        "kind": "xla", "stream": False, "stride": stride,
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
    u["pre"] = Preact(u["pa"], u["pb"], u["s_p"], 1)
    return u


def _stream_unit(qp, scales, pre, stride, has_shortcut, s_in):
    """A unit of an int8-streamed block (``resnet_int8.py:565-650``): the
    XLA unit's convs, conv3 requantised to the stream with its shortcut
    added (m3 = s_h2 * scale / s_out, a3 = bias / s_out; an identity
    shortcut is the int8 stream times s_in / s_out, a projection the bf16
    shortcut over s_out), the pre-activation read from the int8 stream
    (mode 2: pa = s_in * A / s_p, pb = B / s_p)."""
    u = _xla_unit(qp, scales, pre, stride, has_shortcut)
    s_p = _scale(scales[pre + "preact"])
    s_h2 = _scale(scales[pre + "conv2"])
    s_out = _scale(scales[pre + "out"])
    u.update(
        stream=True,
        m3=s_h2 * qp[pre + "conv3/scale"] / s_out,
        a3=qp[pre + "conv3/bias"] / s_out,
        res_scale=(s_out if has_shortcut else s_in / s_out).reshape(1),
        pre=Preact(s_in * qp[pre + "preact/A"] / s_p,
                   qp[pre + "preact/B"] / s_p, None, 2),
    )
    return u


def _boundary_scale(scales, bi):
    """The stream scale of block bi's input: root/out, or the out scale of
    block bi - 1's last unit."""
    if bi == 1:
        return _scale(scales["root/out"])
    n_prev = BLOCKS[bi - 2][0]
    return _scale(scales[f"block{bi - 1}/unit_{n_prev}/bottleneck_v2/out"])


def _root_plan(qp, scales, int8_root):
    """The int8 stem's operands (``resnet_int8.py:379-458``): the fold's
    k-major weights, mul = mult / s_root and add = bias / s_root; for "u8"
    the border-correction map is made per frame size (``_root_add``)."""
    s_root = _scale(scales["root/out"])
    fold = "s2d" if int8_root is True else "wfold"
    w_scale = qp["root/scale_" + fold]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=w_scale.device)
    u8 = int8_root == "u8"
    mult = w_scale * f32(_TWO_OVER_255 if u8 else _RECIP_127)
    return {
        "fold": fold, "u8": u8, "wt": hwio_to_kmajor(qp["root/wq_" + fold]),
        "mul": mult / s_root, "s_root": s_root,
        "add": None if u8 else qp["root/b32"] / s_root,
        # "u8": the map's operands, w_scale / 255 (as XLA computes it)
        # and the bias, and the maps made so far, by frame size.
        "k255": w_scale * f32(_RECIP_255),
        "b32": qp["root/b32"], "maps": {},
    }


def _root_add(root, h: int, w: int):
    """The stem epilogue's (add, border) on h x w frames: the per-channel
    add and no border map, or for "u8" the per-channel add of the interior
    and the map fma(ones_conv, w_scale / 255, bias) / s_root, where
    ones_conv is the stem's contraction of an all-ones int8 image (the
    weights' sum over the taps inside the frame: exact at every border).
    The kernel reads the map only where the tap window leaves the frame
    (``border_mask``), so every other entry must equal the interior add,
    fma(sum of the weights, w_scale / 255, bias) / s_root, bit for bit;
    anything else raises. Made once per frame size, by the plain
    contraction."""
    if not root["u8"]:
        return root["add"], None
    key = (h, w)
    if key not in root["maps"]:
        wt = root["wt"]
        ones = torch.ones((1, h, w, 3), dtype=torch.int8, device=wt.device)
        acc = root_conv_reference(ones, wt, root["fold"])[0]
        bias = lambda a: (fma_reference(a.float(), root["k255"], root["b32"])
                          / root["s_root"]).contiguous()
        border, add = bias(acc), bias(wt.sum(dim=1, dtype=torch.int32))
        inner = ~border_mask(h, w, root["fold"], device=wt.device)
        bits = border.view(torch.int32)[inner]
        if not torch.equal(bits, add.view(torch.int32).expand_as(bits)):
            raise RuntimeError(
                f"the u8 stem's border map on {h}x{w} frames differs from "
                f"the interior add away from the border: the kernel, which "
                f"reads the map only at the border, would not compute it")
        root["maps"][key] = (add, border)
    return root["maps"][key]


def _run_stem(root, images: torch.Tensor,
              preact: Optional[Preact] = None) -> torch.Tensor:
    """The int8 stem and max pool on (N, H, W, 3) frames, one launch:
    uint8 frames only for "u8" (as bytes), any other frames as float32 in
    [-1, 1]. With ``preact`` it returns the first unit's pre-activation of
    the pooled map instead of the map."""
    if images.dtype == torch.uint8:
        if not root["u8"]:
            raise ValueError("uint8 frames need int8_root='u8'; normalise "
                             "them to [-1, 1] floats for the other stems")
        kind = "u8"
    else:
        images = images.to(torch.float32)
        kind = "u8_float" if root["u8"] else "f32"
    images = images.contiguous()
    add, border = _root_add(root, images.shape[1], images.shape[2])
    return root_stem_pool(images, root["wt"], root["mul"], add,
                          fold=root["fold"], kind=kind, preact=preact,
                          border=border)


@torch.no_grad()
def prepare_int8_static(qp: Dict[str, torch.Tensor],
                        scales: Dict[str, torch.Tensor],
                        use_pallas: bool = False,
                        pallas_blocks: tuple = (2, 3, 4),
                        int8_stream=False, int8_root=False) -> Dict:
    """Everything ``apply_int8_static`` derives from (qp, scales), computed
    once, following ``apply_int8``'s control flow (``resnet_int8.py:362-674``):
    the root (bf16, or the int8 stem's operands), then per unit the
    kernels' k-major weights and composed multipliers, with consecutive
    K2-eligible units (stride 1, Cb >= 128, block in ``pallas_blocks`` and
    not streamed) gathered into one chain per block.

    Each step has "enter", the block boundary's pass before it (None,
    ("quantise", s) from bf16 to the int8 stream, or ("dequant", s) to
    bf16), "pre", the ``Preact`` of its first unit, and "pq_from": where
    that pre-activation comes from. "producer": whatever made the step's
    input quantises it from the value it stores (the previous step's "next"
    is then this "pre"; the int8 root's pool takes it as "pool_preact").
    "standalone": a separate ``preact_quant`` pass, after the bf16 root or
    a quantise boundary, where JAX reads the pre-activation from a value no
    kernel stores. "none": a K2 chain after a dequantise boundary, which
    reads the bf16 map itself. "first" is the first step's "pre"."""
    _check_int8_root(int8_root)
    stream_blocks = _stream_blocks(int8_stream)
    steps: List[Dict] = []
    chain: Optional[Dict] = None
    s_stream = _scale(scales["root/out"]) if int8_root else None
    depth_in = qp["root/w"].shape[-1]
    for bi, ui, stride, pre in _unit_prefixes():
        depth, db = BLOCKS[bi - 1][1], BLOCKS[bi - 1][2]
        has_shortcut = depth != depth_in
        depth_in = depth
        in_stream = bi in stream_blocks
        enter = None
        if ui == 1 and in_stream and s_stream is None:
            s_stream = _boundary_scale(scales, bi)
            enter = ("quantise", s_stream)
        elif ui == 1 and not in_stream and s_stream is not None:
            enter = ("dequant", s_stream)
            s_stream = None
        if (use_pallas and not in_stream and stride == 1 and db >= 128
                and bi in pallas_blocks):
            if chain is None:
                chain = {"kind": "k2", "params": [], "specs": [],
                         "enter": enter}
                steps.append(chain)
            chain["params"].append(
                prepare_pallas_unit(qp, scales, pre, has_shortcut))
            chain["specs"].append(has_shortcut)
            chain["pre"] = unit_preact(chain["params"][0])
            continue
        chain = None
        if in_stream:
            u = _stream_unit(qp, scales, pre, stride, has_shortcut, s_stream)
            s_stream = _scale(scales[pre + "out"])
        else:
            u = _xla_unit(qp, scales, pre, stride, has_shortcut)
            if enter is not None:
                # JAX dequantises to bf16(q) * bf16(s), and the unit's
                # pre-activation reads that value (mode 3); its shortcut
                # is a projection, so nothing else reads the bf16 map.
                if "wsc" not in u:
                    raise ValueError(f"{pre}: a block boundary without a "
                                     f"projection shortcut")
                u["pre"] = u["pre"]._replace(
                    mode=3, ds=enter[1].to(bf16).float().reshape(1))
        u["enter"] = enter
        steps.append(u)
    for i, step in enumerate(steps):
        enter = step["enter"]
        if step["kind"] == "k2" and enter is not None:
            step["pq_from"] = "none"
        elif (enter is not None and enter[0] == "quantise") or (
                i == 0 and not int8_root):
            step["pq_from"] = "standalone"
        else:
            step["pq_from"] = "producer"
    for step, following in zip(steps, steps[1:] + [None]):
        step["next"] = (following["pre"] if following is not None
                        and following["pq_from"] == "producer" else None)
    head = {k: qp[k] for k in ("root/w", "root/b", "postnorm/A", "postnorm/B")}
    head["stream_scale"] = s_stream
    return {
        "head": head,
        "root": _root_plan(qp, scales, int8_root) if int8_root else None,
        "pool_preact": (steps[0]["pre"] if int8_root
                        and steps[0]["pq_from"] == "producer" else None),
        "first": steps[0]["pre"], "steps": steps,
    }


def plan_launches(plan: Dict) -> Dict:
    """The kernel launches of one ``run_int8_static`` call on CUDA tensors,
    from the plan alone: "root_pool" (the int8 stem and pool, one kernel),
    "block" (K2, one per unit), "conv" by epilogue, "preact" (standalone
    pre-activation passes) and "preact_modes", every pre-activation
    computed by mode, standalone or fused into the conv, K2 or the stem's
    pool that made its input (K2's own per-unit pre-activations not
    counted)."""
    epilogues = {"dequant": 0, "requant": 0, "stream": 0}
    modes = {m: 0 for m in (0, 1, 2, 3)}
    n = {"root_pool": 0, "block": 0, "preact": 0}
    if plan["root"] is not None:
        n["root_pool"] = 1
        if plan["pool_preact"] is not None:
            modes[plan["pool_preact"].mode] += 1
    for u in plan["steps"]:
        if u["pq_from"] == "standalone":
            n["preact"] += 1
            modes[u["pre"].mode] += 1
        if u["next"] is not None:
            modes[u["next"].mode] += 1
        if u["kind"] == "k2":
            n["block"] += len(u["params"])
            continue
        epilogues["dequant"] += "wsc" in u
        epilogues["requant"] += 2
        epilogues["stream" if u["stream"] else "dequant"] += 1
    return dict(n, conv=epilogues, preact_modes=modes)


def _quantise(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A bf16 -> int8 block boundary (``resnet_int8.py:534-539``)."""
    return torch.round(x.float() / s).clamp(-127.0, 127.0).to(torch.int8)


def _dequantise(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """An int8 -> bf16 block boundary: bf16(x) * bf16(s) (:540-542)."""
    return x.to(bf16) * s.to(bf16)


def _stream_head(head, x: torch.Tensor) -> torch.Tensor:
    """The postnorm read from the int8 stream (:662-667; XLA contracts its
    multiply-add on the CPU), then the head's mean."""
    k = head["stream_scale"] * head["postnorm/A"]
    x = torch.relu(fma_reference(x.float(), k, head["postnorm/B"])).to(bf16)
    return x.float().mean(dim=(1, 2)).to(bf16).float()


def _run_unit(u, x, pq):
    """One XLA-path unit, bf16 or int8 stream; returns (out, the next
    unit's pq or None)."""
    stride = u["stride"]
    if "wsc" in u:
        shortcut = conv_s8(pq, u["wsc"], stride, epilogue="dequant",
                           mul=u["msc"], add=u["asc"], fma=True)
    elif u["stream"]:
        shortcut = x  # read at the stride by the conv3 epilogue
    else:
        shortcut = _subsample(x, stride)
    h = conv_s8(pq, u["w1"], 1, epilogue="requant", mul=u["m1"],
                add=u["a1"], relu=True, fma=True)
    h = conv_s8(h, u["w2"], stride, epilogue="requant", mul=u["m2"],
                add=u["a2"], relu=True, fma=True)
    if u["stream"]:
        out = conv_s8(h, u["w3"], 1, epilogue="stream", mul=u["m3"],
                      add=u["a3"], residual=shortcut,
                      res_scale=u["res_scale"],
                      res_stride=1 if "wsc" in u else stride,
                      preact=u["next"])
    else:
        out = conv_s8(h, u["w3"], 1, epilogue="dequant", mul=u["m3"],
                      add=u["a3"], residual=shortcut, fma=True,
                      preact=u["next"])
    return out if u["next"] is not None else (out, None)


@torch.no_grad()
def run_int8_static(plan: Dict, images: torch.Tensor) -> torch.Tensor:
    """The static-scale trunk on a ``prepare_int8_static`` plan. Each
    unit's pre-activation comes from the kernel that made its input (see
    ``prepare_int8_static``'s "pq_from"); the block boundaries' quantise
    and dequantise passes and the streamed postnorm are PyTorch
    elementwise ops."""
    pq = None
    if plan["root"] is None:
        x = _root(plan["head"], images)
    else:
        pooled = _run_stem(plan["root"], images, plan["pool_preact"])
        if plan["pool_preact"] is not None:
            x, pq = None, pooled
        else:
            x = pooled
    for u in plan["steps"]:
        enter = u["enter"]
        if enter is not None and enter[0] == "quantise":
            x = _quantise(x, enter[1])
        elif enter is not None and u["pq_from"] == "none":
            x = _dequantise(x, enter[1])
        elif enter is not None:
            x = None  # only the pre-activation read the dequantised map
        if u["pq_from"] == "standalone":
            pre = u["pre"]
            pq = preact_quant(x, pre.pa, pre.pb, pre.s, mode=pre.mode,
                              ds=pre.ds)
        if u["kind"] == "k2":
            x, pq = fused_block_pq(x, u["params"], h=x.shape[1],
                                   w=x.shape[2], unit_specs=tuple(u["specs"]),
                                   pq=pq, next_preact=u["next"])
        else:
            x, pq = _run_unit(u, x, pq)
    if plan["head"]["stream_scale"] is not None:
        return _stream_head(plan["head"], x)
    return _head(plan["head"], x)


def apply_int8_static(qp: Dict[str, torch.Tensor],
                      scales: Dict[str, torch.Tensor], images: torch.Tensor,
                      use_pallas: bool = False,
                      pallas_blocks: tuple = (2, 3, 4),
                      int8_stream=False, int8_root=False) -> torch.Tensor:
    """Static-scale int8 trunk: (N, H, W, 3) frames -> (N, 2048) f32 phi.

    ``use_pallas`` runs the stride-1 units of ``pallas_blocks`` that are
    not streamed through K2. ``int8_root``: False (the bf16 root), True
    (the s2d stem), "wfold" (the width-folded stem) or "u8" (the wfold
    stem on bytes; it also takes uint8 frames, which the other stems do
    not). ``int8_stream``: False, True (all blocks) or a tuple of blocks
    whose residual stream is int8. Frames are [-1, 1] floats otherwise.
    """
    plan = prepare_int8_static(qp, scales, use_pallas, pallas_blocks,
                               int8_stream=int8_stream, int8_root=int8_root)
    return run_int8_static(plan, images)
