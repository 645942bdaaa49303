"""The int8 root stem and the int8 max pool of the static-scale int8 trunk,
fused into one kernel, with its plain version.

Counterpart of the ``int8_root`` stems and the max pool of
``human_dynamics_tpu/models/resnet_int8.py`` (``apply_int8``, :371-462),
which XLA runs as integer convolutions and a ``reduce_window``. The CUDA
source is ``csrc/int8_root.cu``; ``root_stem_pool`` launches it:

- the stem: NHWC frames -> the root conv's int8 output, requantised with
  ``root/out``'s scale. The input transform is done on the way into the
  kernel's shared memory: f32 frames in [-1, 1] as clip(rint(x*127), -127,
  127) (``int8_root`` True and "wfold"), raw uint8 frames as u ^ 0x80 and
  f32 frames snapped back to the 255-grid as clip(rint(x*127.5 + 127.5), 0,
  255) - 128 (``"u8"``). The contraction is the space-to-depth 4x4/1 conv
  (``fold="s2d"``, K = 192, ``_s2d_root_weights``) or the width-folded
  (7, 4)/(2, 1) conv (``fold="wfold"``, K = 168, ``_wfold_root_weights``)
  over views that the kernel never builds: each K index maps to an input
  pixel by index arithmetic (``root_taps``). The epilogue is
  clip(rint(fma(y, mul, add)), -127, 127), with ``add`` per channel, and
  for the "u8" stem a ``border`` map at the pixels whose tap window leaves
  the frame (``border_mask``).
- the pool: the 3x3/2 XLA "SAME" max pool over the stem's int8 map (the odd
  pad at the end, pad value -128); with a ``Preact`` of mode 2 or 3 the
  kernel writes the trunk's first pre-activation of the pooled map instead
  of the map (the first unit's shortcut is a projection, so nothing else
  reads it). The stem's map stays in the kernel's shared memory.

Which version runs is decided by the device of the tensors: CUDA tensors
launch the kernel, CPU tensors run the plain version. A failed build or
launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from human_dynamics_tpu_torch.ops import resnet_int8_cuda as _K
from human_dynamics_tpu_torch.ops.resnet_int8_cuda import (
    Preact,
    fma_reference,
    preact_quant_reference,
)

KERNEL_NAME = "int8_root"
STEM_POOL = "resnet_int8_root_pool"

# Kernel launches by wrapper (chip_smoke.py resets and reads them).
LAUNCHES = {STEM_POOL: 0}

# Fold and input codes of csrc/int8_root.cu.
FOLDS = {"s2d": 0, "wfold": 1}
INPUTS = {"f32": 0, "u8_float": 1, "u8": 2}
COUT = 64
ROOT_K = {"s2d": 192, "wfold": 168}


@functools.lru_cache(maxsize=None)
def root_taps(fold: str) -> Tuple[Tuple[int, int, int], ...]:
    """(row offset, column offset, channel) of every K index of a fold's
    k-major weights, relative to input pixel (2*oy, 2*ox) of output (oy,
    ox); offsets lie in [-4, 3].

    s2d: k = (ay*4 + ax)*12 + (dy*2 + dx)*3 + c reads s2d pixel (oy+ay-2,
    ox+ax-2), phase (dy, dx): input (2(oy+ay-2) + dy, 2(ox+ax-2) + dx).
    wfold: k = (ky*4 + a)*6 + p*3 + c reads row 2*oy + ky - 3 of the
    width-paired column ox + a - 2, phase p: input column 2(ox+a-2) + p.
    """
    if fold == "s2d":
        return tuple((2 * (ay - 2) + dy, 2 * (ax - 2) + dx, c)
                     for ay in range(4) for ax in range(4)
                     for dy in range(2) for dx in range(2) for c in range(3))
    if fold == "wfold":
        return tuple((ky - 3, 2 * (a - 2) + p, c)
                     for ky in range(7) for a in range(4)
                     for p in range(2) for c in range(3))
    raise ValueError(f"unknown fold {fold!r}; want one of {sorted(FOLDS)}")


def root_geometry(h: int, w: int, fold: str) -> Tuple[int, int]:
    """(Ho, Wo) of a fold's stem on H x W frames. The s2d view needs H and
    W even and the wfold view W even (the JAX package reshapes without a
    check); anything else raises."""
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}; want one of {sorted(FOLDS)}")
    if h < 1 or w < 2 or w % 2 or (fold == "s2d" and h % 2):
        raise ValueError(
            f"the {fold} stem takes {'H and W' if fold == 's2d' else 'W'} "
            f"even, got {h}x{w}")
    ho = h // 2 if fold == "s2d" else (h - 1) // 2 + 1
    return ho, w // 2


def border_mask(h: int, w: int, fold: str,
                device=None) -> torch.Tensor:
    """(Ho, Wo) bool: the stem pixels (oy, ox) whose 8 x 8 tap window, input
    rows 2*oy - 4 .. 2*oy + 3 and columns 2*ox - 4 .. 2*ox + 3 (``root_taps``'
    offsets, both folds), leaves the h x w frame. Everywhere else the "u8"
    stem's border-correction map is the per-channel weight sum's."""
    ho, wo = root_geometry(h, w, fold)
    oy = torch.arange(ho, device=device)
    ox = torch.arange(wo, device=device)
    rows = (oy < 2) | (2 * oy + 3 >= h)
    cols = (ox < 2) | (2 * ox + 3 >= w)
    return rows[:, None] | cols[None, :]


def root_input_reference(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The int8 image the stem contracts, from the frames (plain version of
    the kernel's transform on load)."""
    if kind == "f32":
        return torch.round(x.float() * 127.0).clamp(-127, 127).to(torch.int8)
    if kind == "u8_float":
        # XLA contracts images * 127.5 + 127.5 into one fused multiply-add.
        half = torch.tensor(127.5, dtype=torch.float32, device=x.device)
        v = torch.round(fma_reference(x.float(), half, half)).clamp(0, 255)
        return (v - 128.0).to(torch.int8)
    if kind == "u8":
        return x.bitwise_xor(128).view(torch.int8)
    raise ValueError(f"unknown input kind {kind!r}; want one of "
                     f"{sorted(INPUTS)}")


def root_conv_reference(q: torch.Tensor, wt: torch.Tensor,
                        fold: str) -> torch.Tensor:
    """Plain contraction of the stem: int8 image q (N, H, W, 3) against the
    fold's k-major weights (64, K), every K index gathered by
    ``root_taps``; float64 products and sums, exact (|sum| <= 192 * 128 *
    127). Returns int32 (N, Ho, Wo, 64)."""
    n, h, w, _ = q.shape
    ho, wo = root_geometry(h, w, fold)
    xp = F.pad(q.to(torch.float64), (0, 0, 4, 4, 4, 4))
    cols: List[torch.Tensor] = [
        xp[:, 4 + dr:4 + dr + 2 * ho - 1:2, 4 + dc:4 + dc + 2 * wo - 1:2, c]
        for dr, dc, c in root_taps(fold)
    ]
    a = torch.stack(cols, dim=-1)
    return (a @ wt.to(torch.float64).t()).to(torch.int32)


def _epilogue(acc, mul, add):
    v = fma_reference(acc.float(), mul, add)
    return torch.round(v).clamp(-127.0, 127.0).to(torch.int8)


def root_stem_reference(x: torch.Tensor, wt: torch.Tensor, mul: torch.Tensor,
                        add: torch.Tensor, *, fold: str,
                        kind: str) -> torch.Tensor:
    """The stem alone, in plain PyTorch: (N, H, W, 3) frames -> (N, Ho, Wo,
    64) int8, out = clip(rint(fma(y, mul, add)), -127, 127) with y the int32
    contraction and add (64,) or a (Ho, Wo, 64) map."""
    _check_root(x, wt, mul, add, fold, kind)
    return _epilogue(root_conv_reference(root_input_reference(x, kind), wt,
                                         fold), mul, add)


def _check_root(x, wt, mul, add, fold, kind):
    if kind not in INPUTS:
        raise ValueError(f"unknown input kind {kind!r}; want one of "
                         f"{sorted(INPUTS)}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"the stem takes (N, H, W, 3) frames, got "
                         f"{tuple(x.shape)}")
    want = torch.uint8 if kind == "u8" else torch.float32
    if x.dtype != want:
        raise ValueError(f"input kind {kind!r} takes {want}, got {x.dtype}")
    ho, wo = root_geometry(x.shape[1], x.shape[2], fold)
    if tuple(wt.shape) != (COUT, ROOT_K[fold]) or wt.dtype != torch.int8:
        raise ValueError(f"the {fold} stem's weights are ({COUT}, "
                         f"{ROOT_K[fold]}) int8, got {tuple(wt.shape)} "
                         f"{wt.dtype}")
    if tuple(mul.shape) != (COUT,) or mul.dtype != torch.float32:
        raise ValueError(f"mul must be ({COUT},) float32")
    if (tuple(add.shape) not in ((COUT,), (ho, wo, COUT))
            or add.dtype != torch.float32):
        raise ValueError(f"add must be ({COUT},) or ({ho}, {wo}, {COUT}) "
                         f"float32, got {tuple(add.shape)} {add.dtype}")
    return ho, wo


def same_pool_geometry(size: int, window: int = 3,
                       stride: int = 2) -> Tuple[int, int, int]:
    """(output size, leading pad, trailing pad) of XLA's "SAME" window: the
    output is ceil(size / stride), the total pad max((out-1)*stride +
    window - size, 0), its odd element at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return out, total // 2, total - total // 2


def _check_pool(x, preact):
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f"the int8 pool takes (N, H, W, C) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _check_preact(x.shape[-1], preact)


def _check_preact(c, preact):
    if preact is not None:
        if preact.mode not in (2, 3):
            raise ValueError(f"the pool's pre-activation reads int8: mode 2 "
                             f"or 3, not {preact.mode}")
        _K._check_preact_operands(c, *preact)


def max_pool_s8_reference(x: torch.Tensor,
                          preact: Optional[Preact] = None) -> torch.Tensor:
    """3x3/2 "SAME" max pool over an int8 map (N, H, W, C), pad value -128
    (``resnet_int8.py:459-462``; exact on int8: the max commutes with the
    positive scale), in plain PyTorch. With ``preact`` (mode 2: the pooled
    map is the int8 stream; mode 3: it is dequantised to bf16 first, as at
    an int8 -> bf16 block boundary) it returns the int8 pre-activation of
    the pooled map instead of the map."""
    _check_pool(x, preact)
    _, lo_h, hi_h = same_pool_geometry(x.shape[1])
    _, lo_w, hi_w = same_pool_geometry(x.shape[2])
    xp = F.pad(x.float().permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h),
               value=-128.0)
    pooled = F.max_pool2d(xp, 3, 2).permute(0, 2, 3, 1).to(torch.int8)
    if preact is None:
        return pooled.contiguous()
    return preact_quant_reference(pooled, *preact[:3], mode=preact.mode,
                                  ds=preact.ds)


def _check_stem_pool(x, wt, mul, add, border, fold, kind, preact):
    ho, wo = _check_root(x, wt, mul, add, fold, kind)
    if tuple(add.shape) != (COUT,):
        raise ValueError(f"add must be ({COUT},) float32: the interior's "
                         f"per-channel add (a map goes in border)")
    if border is not None and (tuple(border.shape) != (ho, wo, COUT)
                               or border.dtype != torch.float32):
        raise ValueError(f"border must be ({ho}, {wo}, {COUT}) float32, got "
                         f"{tuple(border.shape)} {border.dtype}")
    _check_preact(COUT, preact)
    return ho, wo


def stem_add_map(add: torch.Tensor, border: torch.Tensor, h: int, w: int,
                 fold: str) -> torch.Tensor:
    """The per-pixel add ``root_stem_pool`` applies: ``border`` where the
    tap window leaves the h x w frame (``border_mask``), ``add`` elsewhere;
    (Ho, Wo, 64)."""
    mask = border_mask(h, w, fold, device=border.device)
    return torch.where(mask[..., None], border, add).contiguous()


def root_stem_pool_reference(x: torch.Tensor, wt: torch.Tensor,
                             mul: torch.Tensor, add: torch.Tensor, *,
                             fold: str, kind: str,
                             preact: Optional[Preact] = None,
                             border: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of ``root_stem_pool``: ``max_pool_s8_reference`` of
    ``root_stem_reference``."""
    _check_stem_pool(x, wt, mul, add, border, fold, kind, preact)
    if border is not None:
        add = stem_add_map(add, border, x.shape[1], x.shape[2], fold)
    return max_pool_s8_reference(
        root_stem_reference(x, wt, mul, add, fold=fold, kind=kind), preact)


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built library, with its C signatures declared."""
    from human_dynamics_tpu_torch.ops._build import load_kernel_library

    lib = load_kernel_library(KERNEL_NAME).lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.int8_root_pool_launch.argtypes = ([ptr, i32] + [ptr] * 9
                                          + [i32] * 7 + [ptr])
    lib.int8_root_pool_launch.restype = i32
    lib.int8_root_error_string.argtypes = [i32]
    lib.int8_root_error_string.restype = ctypes.c_char_p
    lib.int8_root_layout.argtypes = [i32]
    lib.int8_root_layout.restype = i32
    layout = tuple(lib.int8_root_layout(i) for i in range(6))
    want = tuple(FOLDS.values()) + tuple(INPUTS.values()) + (COUT,)
    if layout != want:
        raise RuntimeError(f"{KERNEL_NAME} was built with codes {layout}, "
                           f"the wrapper expects {want}")
    return lib


def _aligned16(t):
    """t, or a copy of it when it does not start on 16 bytes (a contiguous
    slice of frames can start anywhere): the kernel reads it by 16-byte
    cp.async from 16-byte aligned addresses."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _stem_pool_cuda(x, wt, mul, add, fold, kind, preact, border):
    ho, wo = _check_stem_pool(x, wt, mul, add, border, fold, kind, preact)
    x, border = _aligned16(x), _aligned16(border)
    n, h, w, _ = x.shape
    po, qo = same_pool_geometry(ho)[0], same_pool_geometry(wo)[0]
    out = torch.empty((n, po, qo, COUT), dtype=torch.int8, device=x.device)
    pre = preact if preact is not None else Preact(None, None, None, -1)
    _K._check_cuda_layout(_K._operands(x, out, border),
                          _K._operands(wt, mul, add, pre.pa, pre.pb, pre.s,
                                       pre.ds))
    lib = _kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.int8_root_pool_launch(
            x.data_ptr(), INPUTS[kind], wt.data_ptr(), out.data_ptr(),
            mul.data_ptr(), add.data_ptr(), _K._ptr(border), _K._ptr(pre.pa),
            _K._ptr(pre.pb), _K._ptr(pre.s), _K._ptr(pre.ds), pre.mode, n, h,
            w, po, qo, FOLDS[fold], stream)
    if code != 0:
        msg = lib.int8_root_error_string(code).decode()
        raise RuntimeError(f"{STEM_POOL} launch failed: {msg} ({code})")
    LAUNCHES[STEM_POOL] += 1
    _K._count_preact(preact)
    return out


def root_stem_pool(x: torch.Tensor, wt: torch.Tensor, mul: torch.Tensor,
                   add: torch.Tensor, *, fold: str, kind: str,
                   preact: Optional[Preact] = None,
                   border: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 root stem and its 3x3/2 "SAME" max pool in one launch:
    (N, H, W, 3) frames -> (N, ceil(Ho/2), ceil(Wo/2), 64) int8.

    x: f32 frames in [-1, 1] (``kind`` "f32": the s2d and wfold stems;
    "u8_float": the "u8" stem on float frames) or uint8 frames (``kind``
    "u8"). wt: the fold's k-major int8 weights (64, K), K = 192 for
    ``fold`` "s2d" and 168 for "wfold". mul and add (64,) float32: the stem
    is clip(rint(fma(y, mul, add)), -127, 127) with y the int32 contraction
    (XLA contracts the multiply-add on the CPU). ``border`` (Ho, Wo, 64)
    float32, or None: the add of the pixels whose tap window leaves the
    frame (``border_mask``; the "u8" stem's border-correction map), read
    only there. ``preact`` (mode 2 or 3): the pooled map's pre-activation
    is returned instead of the map.
    """
    pre = preact if preact is not None else Preact(None, None, None, 0)
    tensors = _K._operands(x, wt, mul, add, border, pre.pa, pre.pb, pre.s,
                           pre.ds)
    if _K._device_of(tensors, "root_stem_pool") == "cpu":
        return root_stem_pool_reference(x, wt, mul, add, fold=fold,
                                        kind=kind, preact=preact,
                                        border=border)
    return _stem_pool_cuda(x, wt, mul, add, fold, kind, preact, border)
