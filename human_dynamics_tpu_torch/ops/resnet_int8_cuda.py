"""int8 ResNet kernels: the int8 convolution, the pre-activation quantiser
and K2, the chained int8 bottleneck block, with their plain versions.

Counterpart of ``human_dynamics_tpu/ops/resnet_int8_pallas.py`` (K2) and of
the XLA integer convolutions of ``human_dynamics_tpu/models/resnet_int8.py``
(``_conv_s8`` with its requant / dequant epilogues, and the int8 residual
stream's fused add + requant and pre-activation, ``int8_stream``). The CUDA
sources are ``csrc/resnet_int8.cu`` (the conv and the pre-activation) and
``csrc/k2_unit.cu`` (K2); the int8 root stems and the int8 max pool are in
``ops/int8_root_cuda.py``:

- ``conv_s8``: NHWC int8 x (Cout, K) int8 weights -> int32 accumulators,
  with a per-output-channel f32 epilogue fused in (see ``EPILOGUES``; the
  "stream" epilogue adds an int8 or bf16 shortcut and requantises to the
  int8 stream) and, optionally, the next unit's pre-activation quantiser
  (``Preact``) on the value it stores. ``conv_plan`` picks the kernel's
  path and tile from the geometry: TMA-fed ``wgmma`` for 1x1 stride-1
  convs, a cp.async gather feeding the same ``wgmma`` loop for the rest.
- ``preact_quant``: bf16 or int8 residual stream -> folded BN + ReLU ->
  int8; the standalone pass, for a unit whose input no conv produced
  (``Preact`` lists the four modes).
- ``fused_block``: K2, a chain of stride-1 pre-activation bottleneck units
  with static scales, one launch of ``csrc/k2_unit.cu`` per unit (the
  pre-activation, both requantised convs and the residual conv in one
  kernel, h1 and h2 in shared memory; ``k2_plan`` picks its tiles).

Weights are k-major, (Cout, K) with K = kh*kw*Cin contiguous in the
flattened HWIO order: the transpose of the JAX package's (K, Cout) GEMM
operand (``hwio_to_kmajor``), which is what the tensor-core fragments read.

Contraction: the JAX K2 kernel's four multiply-adds (preact, both
requants, the shortcut dequant, the residual) are fused multiply-adds, as
XLA contracts them inside the kernel; XLA contracts the static path's
requant and dequant epilogues on the CPU too (``fma=True``). The CUDA
source names every rounding, and the plain versions emulate a fused
multiply-add through float64.

Which version runs is decided by the device of the tensors: CUDA tensors
launch the kernels, CPU tensors run the plain versions. A failed build or
launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

KERNEL_NAME = "resnet_int8"
K2_KERNEL_NAME = "k2_unit"
CONV = "resnet_int8_conv"
PREACT = "resnet_int8_preact"
BLOCK = "resnet_int8_block"

# Kernel launches by wrapper; chip_smoke.py resets and reads them to show
# that the main path went through the kernels. BLOCK counts K2's launches,
# one per unit.
LAUNCHES = {CONV: 0, PREACT: 0, BLOCK: 0}

# Epilogue, flag and path codes of csrc/resnet_int8.cu.
EPILOGUES = {"int32": 0, "requant": 1, "dequant": 2, "dequant_f32": 3,
             "residual": 4, "stream": 5}
FLAG_FMA, FLAG_RELU, FLAG_RES_BF16, FLAG_RES_S8 = 1, 2, 4, 8
PATHS = {"tma": 0, "gather": 1}
# Conv launches by main-loop path and by epilogue, and pre-activations
# computed by mode (standalone, or fused into a conv, K2 or the int8 pool),
# whatever LAUNCHES counter they count under.
PATH_LAUNCHES = {path: 0 for path in PATHS}
EPILOGUE_LAUNCHES = {epi: 0 for epi in EPILOGUES}
PREACT_MODES = (0, 1, 2, 3)
PREACT_MODE_LAUNCHES = {mode: 0 for mode in PREACT_MODES}
_OUT_DTYPE = {"int32": torch.int32, "requant": torch.int8,
              "dequant": torch.bfloat16, "dequant_f32": torch.float32,
              "residual": torch.bfloat16, "stream": torch.int8}
# The epilogues that store the bf16 residual stream, and so can quantise
# the next unit's pre-activation from it (modes 0 and 1), and the one that
# stores the int8 stream (modes 2 and 3).
_PREACT_EPILOGUES = {"dequant": (0, 1), "residual": (0, 1), "stream": (2, 3)}


class Preact(NamedTuple):
    """A unit's pre-activation quantiser operands (see ``preact_quant``):
    pa, pb (C,) float32; s the (1,) float32 scale of modes 1 and 3, else
    None; ds the (1,) float32 bf16 stream scale of mode 3, else None.

    Modes: 0 K2's and 1 the XLA path's, from the bf16 stream; 2 from the
    int8 stream (``int8_stream``); 3 at an int8 -> bf16 block boundary,
    mode 1 on the boundary's dequantised value bf16(q * ds)."""

    pa: torch.Tensor
    pb: torch.Tensor
    s: Optional[torch.Tensor]
    mode: int
    ds: Optional[torch.Tensor] = None


def _count_preact(preact: Optional[Preact]):
    if preact is not None:
        PREACT_MODE_LAUNCHES[preact.mode] += 1


class ConvPlan(NamedTuple):
    """How the conv kernel runs one geometry: the main-loop path ("tma":
    A and B by TMA; "gather": A by a cp.async im2col gather, B by TMA), the
    tile's output channels ``bn`` and its K slice in bytes ``bk`` (128 with
    the 128-byte swizzle, 64 with the 64-byte one)."""

    path: str
    bn: int
    bk: int


def conv_plan(ks: int, stride: int, cin: int, cout: int) -> ConvPlan:
    """The conv kernel's path and tile for a geometry (pure, no device).

    1x1 stride-1 convs are plain GEMMs over the NHWC rows, which TMA reads
    as a 2-D (M, Cin) matrix; every other geometry gathers its im2col rows.
    BK is 128 bytes, except on the TMA path where Cin is not a multiple of
    128 (block 1's 64 channels would leave half of each 128-byte slice
    empty): 64 there. The gather fills a slice chunk by chunk across taps,
    so it keeps 128 (9 taps of 64 channels: 5 slices, not 9). BN is 64 for
    Cout <= 64, else 128. Raises for what the kernel does not take: Cin not
    a multiple of 16 (16-byte loads, TMA's stride rule) or Cout not a
    multiple of 8 (8-channel epilogue chunks).
    """
    if cin % 16 or cout % 8 or cin <= 0 or cout <= 0:
        raise ValueError(
            f"the conv kernel takes Cin % 16 == 0 and Cout % 8 == 0, got "
            f"Cin={cin}, Cout={cout}"
        )
    if ks < 1 or ks % 2 == 0 or stride < 1:
        raise ValueError(f"no conv kernel for k={ks}, stride={stride}")
    path = "tma" if ks == 1 and stride == 1 else "gather"
    bk = 64 if path == "tma" and cin % 128 else 128
    return ConvPlan(path, 64 if cout <= 64 else 128, bk)


PARAM_KEYS = ("pA", "pB", "w1", "q1m", "q1a", "w2", "q2m", "q2a",
              "w3", "d3m", "d3a")
SC_KEYS = PARAM_KEYS + ("wsc", "dscm", "dsca")


def _keys(has_shortcut: bool):
    return SC_KEYS if has_shortcut else PARAM_KEYS


def hwio_to_kmajor(wq: torch.Tensor) -> torch.Tensor:
    """(kh, kw, Cin, Cout) -> (Cout, kh*kw*Cin), K contiguous."""
    return wq.reshape(-1, wq.shape[-1]).t().contiguous()


def conv_geometry(xq: torch.Tensor, wt: torch.Tensor, stride: int):
    """(kernel size, output height, output width) of conv_s8."""
    if xq.dim() != 4 or wt.dim() != 2:
        raise ValueError(
            f"conv_s8 takes x (N, H, W, Cin) and wt (Cout, K), got "
            f"{tuple(xq.shape)} and {tuple(wt.shape)}"
        )
    cin = xq.shape[-1]
    taps = wt.shape[1] // cin if cin else 0
    ks = math.isqrt(taps)
    if ks * ks * cin != wt.shape[1] or ks % 2 == 0:
        raise ValueError(
            f"wt has K={wt.shape[1]}, not k*k*Cin for an odd k and Cin={cin}"
        )
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    pad = (ks - 1) // 2
    ho = (xq.shape[1] + 2 * pad - ks) // stride + 1
    wo = (xq.shape[2] + 2 * pad - ks) // stride + 1
    return ks, ho, wo


def conv_s8_reference(xq: torch.Tensor, wt: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    """Plain int8 conv: float64 ``F.conv2d``, exact because every sum is
    below 2**53 (|sum| <= 4608 * 127**2). Returns int32 NHWC."""
    ks, _, _ = conv_geometry(xq, wt, stride)
    cout, cin = wt.shape[0], xq.shape[-1]
    w = wt.reshape(cout, ks, ks, cin).permute(0, 3, 1, 2).double()
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, stride=stride,
                 padding=(ks - 1) // 2)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def fma_reference(a, b, c):
    """float32 fused multiply-add a*b + c, rounded once (through float64:
    the product of two floats is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def epilogue_reference(acc, epilogue, mul=None, add=None, *, relu=False,
                       fma=False, residual=None,
                       res_scale: Optional[torch.Tensor] = None,
                       res_stride: int = 1,
                       preact: Optional[Preact] = None):
    """The conv epilogues of the CUDA source, in plain PyTorch. With
    ``preact`` it returns (out, the next unit's pre-activation of out)."""
    out = _epilogue_out(acc, epilogue, mul, add, relu, fma, residual,
                        res_scale, res_stride)
    if preact is None:
        return out
    return out, preact_quant_reference(out, *preact[:3], mode=preact.mode,
                                       ds=preact.ds)


def _stream_shortcut(residual, res_stride):
    if res_stride == 1:
        return residual
    return residual[:, ::res_stride, ::res_stride, :]


def _epilogue_out(acc, epilogue, mul, add, relu, fma, residual, res_scale,
                  res_stride):
    if epilogue == "stream":
        # XLA's contractions on the CPU: fma(y, m, a), then fma(q, k, .)
        # for an int8 shortcut, or + sc / s_out for a bf16 one.
        v = fma_reference(acc.float(), mul, add)
        sc = _stream_shortcut(residual, res_stride).float()
        k = res_scale.reshape(())
        if residual.dtype == torch.int8:
            v = fma_reference(sc, k, v)
        else:
            v = v + sc / k
        return torch.round(v).clamp(-127.0, 127.0).to(torch.int8)
    if epilogue == "int32":
        return acc
    y = acc.float()
    if epilogue == "requant":
        v = fma_reference(y, mul, add) if fma else y * mul + add
        return torch.round(v).clamp(0.0 if relu else -127.0, 127.0).to(torch.int8)
    if epilogue == "dequant":
        v = (fma_reference(y, mul, add) if fma else y * mul + add).to(
            torch.bfloat16)
        if relu:
            v = torch.clamp_min(v, 0)
        return v if residual is None else residual + v
    if epilogue == "dequant_f32":
        return fma_reference(y, mul, add)
    if epilogue == "residual":
        return (fma_reference(y, mul, residual.float()) + add).to(torch.bfloat16)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def _check_scalar(name, t):
    if t is None or t.numel() != 1 or t.dtype != torch.float32:
        raise ValueError(f"{name} must be a (1,) float32 tensor")


def _check_conv(xq, wt, stride, epilogue, mul, add, residual, preact=None,
                res_scale=None, res_stride=1):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    ks, ho, wo = conv_geometry(xq, wt, stride)
    if xq.dtype != torch.int8 or wt.dtype != torch.int8:
        raise ValueError(f"conv_s8 takes int8, got {xq.dtype} and {wt.dtype}")
    cout = wt.shape[0]
    if epilogue != "int32":
        for name, t in (("mul", mul), ("add", add)):
            if t is None or tuple(t.shape) != (cout,) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be ({cout},) float32")
    if epilogue in ("residual", "stream") and residual is None:
        raise ValueError(f"the {epilogue} epilogue needs a residual")
    if epilogue == "stream":
        _check_scalar("res_scale", res_scale)
        if res_stride < 1 or (res_stride > 1
                              and residual.dtype != torch.int8):
            raise ValueError("only an int8 shortcut is read strided")
    elif res_scale is not None or res_stride != 1:
        raise ValueError(f"epilogue {epilogue!r} takes no res_scale or "
                         f"res_stride")
    if residual is not None:
        if epilogue not in ("dequant", "residual", "stream"):
            raise ValueError(f"epilogue {epilogue!r} takes no residual")
        want = (xq.shape[0], ho, wo, cout)
        got = tuple(residual.shape)
        if epilogue == "stream" and residual.dtype == torch.int8:
            got = tuple(_stream_shortcut(residual, res_stride).shape)
        if got != want:
            raise ValueError(f"residual shape {tuple(residual.shape)} (read "
                             f"at stride {res_stride}), want {want}")
        ok = {"dequant": (torch.bfloat16,),
              "residual": (torch.bfloat16, torch.float32),
              "stream": (torch.int8, torch.bfloat16)}[epilogue]
        if residual.dtype not in ok:
            raise ValueError(f"residual dtype {residual.dtype}, want one of {ok}")
    if preact is not None:
        if epilogue not in _PREACT_EPILOGUES:
            raise ValueError(
                f"epilogue {epilogue!r} stores no bf16 or int8 stream to "
                f"quantise; a preact takes {sorted(_PREACT_EPILOGUES)}")
        modes = _PREACT_EPILOGUES[epilogue]
        if preact.mode not in modes:
            stream = "int8" if epilogue == "stream" else "bf16"
            raise ValueError(
                f"epilogue {epilogue!r} stores the {stream} stream: a preact "
                f"after it takes modes {modes}, not a mode-{preact.mode} one")
        _check_preact_operands(cout, *preact)
    return ks, ho, wo


def _operands(*tensors):
    return [t for t in tensors if t is not None]


def _device_of(tensors, what):
    if all(t.is_cuda for t in tensors):
        dev = tensors[0].device
        if any(t.device != dev for t in tensors):
            raise ValueError(f"{what} operands on several CUDA devices")
        return "cuda"
    if all(t.device.type == "cpu" for t in tensors):
        return "cpu"
    raise ValueError(
        f"{what} operands must all be CUDA or all CPU tensors, got "
        f"{sorted({str(t.device) for t in tensors})}"
    )


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from human_dynamics_tpu_torch.ops._build import load_kernel_library

    lib = load_kernel_library(KERNEL_NAME).lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.resnet_int8_conv_launch.argtypes = [ptr] * 12 + [i32] * 18 + [ptr]
    lib.resnet_int8_conv_launch.restype = i32
    lib.resnet_int8_preact_launch.argtypes = (
        [ptr] * 6 + [ctypes.c_longlong, i32, i32, ptr])
    lib.resnet_int8_preact_launch.restype = i32
    lib.resnet_int8_error_string.argtypes = [i32]
    lib.resnet_int8_error_string.restype = ctypes.c_char_p
    lib.resnet_int8_layout.argtypes = [i32]
    lib.resnet_int8_layout.restype = i32
    layout = tuple(lib.resnet_int8_layout(i) for i in range(12))
    want = (tuple(EPILOGUES.values())
            + (FLAG_FMA, FLAG_RELU, FLAG_RES_BF16, FLAG_RES_S8)
            + tuple(PATHS.values()))
    if layout != want:
        raise RuntimeError(
            f"{KERNEL_NAME} was built with codes {layout}, the wrapper "
            f"expects {want}"
        )
    return lib


def _raise_on(code, what):
    if code != 0:
        msg = _kernel_library().resnet_int8_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({code})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda_layout(aligned, others=()):
    """Contiguity of every operand; 16-byte alignment of those the kernels
    read or write in 16-byte vectors (or through a tensor map)."""
    for t in list(aligned) + list(others):
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous operands")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned tensors "
                             "where they read or write 16-byte vectors")


def _conv_cuda(counter, xq, wt, stride, epilogue, mul=None, add=None, *,
               relu=False, fma=False, residual=None, res_scale=None,
               res_stride=1, preact: Optional[Preact] = None):
    """Launch the conv kernel on PyTorch's current stream, on the path
    ``conv_plan`` picks; the launch counts under LAUNCHES[counter],
    PATH_LAUNCHES[path], EPILOGUE_LAUNCHES[epilogue] and, with ``preact``,
    PREACT_MODE_LAUNCHES[mode]. Returns out, or (out, pq) with ``preact``."""
    ks, ho, wo = _check_conv(xq, wt, stride, epilogue, mul, add, residual,
                             preact, res_scale, res_stride)
    n, h, w, cin = xq.shape
    cout = wt.shape[0]
    plan = conv_plan(ks, stride, cin, cout)
    shape = (n, ho, wo, cout)
    out = torch.empty(shape, dtype=_OUT_DTYPE[epilogue], device=xq.device)
    pq = (None if preact is None
          else torch.empty(shape, dtype=torch.int8, device=xq.device))
    pre = preact if preact is not None else Preact(None, None, None, 0)
    _check_cuda_layout(_operands(xq, wt, out, residual, pq),
                       _operands(mul, add, pre.pa, pre.pb, pre.s, pre.ds,
                                 res_scale))
    res_dtype = None if residual is None else residual.dtype
    flags = ((FLAG_FMA if fma else 0) | (FLAG_RELU if relu else 0)
             | (FLAG_RES_BF16 if res_dtype == torch.bfloat16 else 0)
             | (FLAG_RES_S8 if res_dtype == torch.int8 else 0))
    rh, rw = (ho, wo) if residual is None else residual.shape[1:3]
    lib = _kernel_library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        code = lib.resnet_int8_conv_launch(
            xq.data_ptr(), wt.data_ptr(), out.data_ptr(), _ptr(mul),
            _ptr(add), _ptr(residual), _ptr(pq), _ptr(pre.pa), _ptr(pre.pb),
            _ptr(pre.s), _ptr(pre.ds), _ptr(res_scale), pre.mode, n, h, w,
            cin, cout, ks, stride, ho, wo, EPILOGUES[epilogue], flags,
            PATHS[plan.path], plan.bn, plan.bk, rh, rw, res_stride, stream,
        )
    _raise_on(code, CONV)
    LAUNCHES[counter] += 1
    PATH_LAUNCHES[plan.path] += 1
    EPILOGUE_LAUNCHES[epilogue] += 1
    _count_preact(preact)
    return out if preact is None else (out, pq)


def conv_s8(xq: torch.Tensor, wt: torch.Tensor, stride: int = 1, *,
            epilogue: str = "int32", mul: Optional[torch.Tensor] = None,
            add: Optional[torch.Tensor] = None, relu: bool = False,
            fma: bool = False,
            residual: Optional[torch.Tensor] = None,
            res_scale: Optional[torch.Tensor] = None,
            res_stride: int = 1,
            preact: Optional[Preact] = None):
    """int8 conv with int32 accumulation and a fused epilogue.

    xq (N, H, W, Cin) int8; wt (Cout, k*k*Cin) int8, k odd; padding
    (k-1)//2 on both sides. ``epilogue`` (per output channel c, y the
    accumulator as f32):

    - "int32": y as int32;
    - "requant": int8 clip(rint(y*mul + add), lo, 127), lo 0 with ``relu``
      else -127; ``fma`` fuses the multiply-add (K2, and XLA's contraction
      on the static path), else it is a separate multiply and add;
    - "dequant": bf16(y*mul + add) (``fma`` as for "requant"), then
      max(., 0) with ``relu``, then + ``residual`` (bf16) when given;
    - "dequant_f32": f32 fma(y, mul, add) (K2's projection shortcut);
    - "residual": bf16(fma(y, mul, residual) + add) (K2's last conv),
      residual f32 or bf16;
    - "stream" (the int8 stream's conv3): int8 clip(rint(v), -127, 127)
      with v = fma(y, mul, add) and then, for an int8 ``residual`` (the
      identity shortcut, read at ``res_stride``), fma(residual, res_scale,
      v) with res_scale = s_in / s_out, or, for a bf16 one (the projection
      shortcut), v + residual / res_scale with res_scale = s_out.

    With ``preact`` it returns (out, pq): pq is ``preact_quant(out,
    *preact)``, computed in the same pass from the value stored (modes 0
    and 1 after the bf16 epilogues "dequant" and "residual", modes 2 and 3
    after "stream").
    """
    pre = preact if preact is not None else Preact(None, None, None, 0)
    tensors = _operands(xq, wt, mul, add, residual, res_scale, pre.pa,
                        pre.pb, pre.s, pre.ds)
    if _device_of(tensors, "conv_s8") == "cpu":
        _check_conv(xq, wt, stride, epilogue, mul, add, residual, preact,
                    res_scale, res_stride)
        return epilogue_reference(
            conv_s8_reference(xq, wt, stride), epilogue, mul, add,
            relu=relu, fma=fma, residual=residual, res_scale=res_scale,
            res_stride=res_stride, preact=preact,
        )
    return _conv_cuda(CONV, xq, wt, stride, epilogue, mul, add, relu=relu,
                      fma=fma, residual=residual, res_scale=res_scale,
                      res_stride=res_stride, preact=preact)


def _check_preact_operands(c, pa, pb, s, mode, ds=None):
    if mode not in PREACT_MODES:
        raise ValueError(f"preact mode {mode} is not one of {PREACT_MODES}")
    for name, t in (("pa", pa), ("pb", pb)):
        if (t is None or tuple(t.shape) != (c,)
                or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({c},) float32")
    if mode in (1, 3) and (s is None or s.numel() != 1
                           or s.dtype != torch.float32):
        raise ValueError(f"mode {mode} needs the float32 scale s")
    if mode == 3 and (ds is None or ds.numel() != 1
                      or ds.dtype != torch.float32):
        raise ValueError("mode 3 needs the float32 dequantisation scale ds")


def _check_preact(x, pa, pb, s, mode, ds=None):
    want, name = ((torch.bfloat16, "bf16") if mode in (0, 1)
                  else (torch.int8, "int8"))
    if x.dtype != want:
        raise ValueError(f"preact_quant mode {mode} takes {name}, got "
                         f"{x.dtype}")
    _check_preact_operands(x.shape[-1], pa, pb, s, mode, ds)


def preact_quant_reference(x, pa, pb, s=None, *, mode: int = 0, ds=None):
    """Plain version of ``preact_quant``."""
    if mode in (0, 2):
        v = torch.clamp_min(fma_reference(x.float(), pa, pb), 0.0)
    else:
        if mode == 3:
            x = (x.float() * ds.reshape(())).to(torch.bfloat16)
        t = (x.float() * pa).to(torch.bfloat16).float()
        p = torch.clamp_min((t + pb).to(torch.bfloat16).float(), 0.0)
        v = p / s.reshape(())
    return torch.round(v).clamp(0.0, 127.0).to(torch.int8)


def _preact_cuda(counter, x, pa, pb, s=None, *, mode: int = 0, ds=None):
    """Launch the pre-activation kernel; counts under LAUNCHES[counter] and
    PREACT_MODE_LAUNCHES[mode]."""
    _check_preact(x, pa, pb, s, mode, ds)
    c = x.shape[-1]
    if c % 8:
        raise ValueError(f"the preact kernel takes C % 8 == 0, got {c}")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _check_cuda_layout((x, out, pa, pb), _operands(s, ds))
    lib = _kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.resnet_int8_preact_launch(
            x.data_ptr(), out.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            _ptr(s), _ptr(ds), x.numel() // max(c, 1), c, mode, stream,
        )
    _raise_on(code, PREACT)
    LAUNCHES[counter] += 1
    PREACT_MODE_LAUNCHES[mode] += 1
    return out


def preact_quant(x: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                 s: Optional[torch.Tensor] = None, *,
                 mode: int = 0,
                 ds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Residual stream (..., C) -> int8 pre-activation, per channel c:

    - mode 0 (K2, ``_unit_body``), bf16 x: clip(rint(max(fma(x, pa, pb),
      0)), 0, 127) with pa = A / s_p, pb = B / s_p;
    - mode 1 (the XLA static path), bf16 x: p = max(bf16(bf16(x*pa) + pb),
      0) with pa, pb the bf16-rounded BN fold; clip(rint(p / s), 0, 127);
    - mode 2 (the int8 stream, ``resnet_int8.py:565-576``), int8 x: mode
      0's arithmetic with pa = s_stream * A / s_p, pb = B / s_p (XLA
      contracts the multiply-add on the CPU);
    - mode 3 (an int8 -> bf16 block boundary), int8 x: mode 1 on bf16(x *
      ds), ds the bf16-rounded stream scale.
    """
    if _device_of(_operands(x, pa, pb, s, ds), "preact_quant") == "cpu":
        _check_preact(x, pa, pb, s, mode, ds)
        return preact_quant_reference(x, pa, pb, s, mode=mode, ds=ds)
    return _preact_cuda(PREACT, x, pa, pb, s, mode=mode, ds=ds)


# ---------------------------------------------------------------------------
# K2: the chained bottleneck block
# ---------------------------------------------------------------------------


def prepare_pallas_unit(qp: Dict[str, torch.Tensor],
                        scales: Dict[str, torch.Tensor], pre: str,
                        has_shortcut: bool) -> Dict[str, torch.Tensor]:
    """Fold (qp, static scales) for one unit into K2's operands.

    ``qp``/``scales`` come from models/resnet_int8.prepare_int8_params and
    calibrate_int8_scales; ``pre`` is the unit prefix
    ('block2/unit_2/bottleneck_v2/'). The multipliers compose dequant
    (s_x * scale) and the next layer's quant (1 / s_out) in f32 in the JAX
    order. Weights are k-major (the JAX operands transposed): w1 (Cb, Cin),
    w2 (Cb, 9*Cb), w3 (Cout, Cb), wsc (Cout, Cin); multipliers are (C,).
    """
    f32 = lambda v: v.to(torch.float32)
    s_p = f32(scales[pre + "preact"])
    s_h1 = f32(scales[pre + "conv1"])
    s_h2 = f32(scales[pre + "conv2"])
    out = {
        "pA": f32(qp[pre + "preact/A"]) / s_p,
        "pB": f32(qp[pre + "preact/B"]) / s_p,
        "w1": hwio_to_kmajor(qp[pre + "conv1/wq"]),
        "q1m": f32(qp[pre + "conv1/scale"]) * s_p / s_h1,
        "q1a": f32(qp[pre + "conv1/bias"]) / s_h1,
        "w2": hwio_to_kmajor(qp[pre + "conv2/wq"]),
        "q2m": f32(qp[pre + "conv2/scale"]) * s_h1 / s_h2,
        "q2a": f32(qp[pre + "conv2/bias"]) / s_h2,
        "w3": hwio_to_kmajor(qp[pre + "conv3/wq"]),
        "d3m": f32(qp[pre + "conv3/scale"]) * s_h2,
        "d3a": f32(qp[pre + "conv3/bias"]),
    }
    if has_shortcut:
        out["wsc"] = hwio_to_kmajor(qp[pre + "shortcut/wq"])
        out["dscm"] = f32(qp[pre + "shortcut/scale"]) * s_p
        out["dsca"] = f32(qp[pre + "shortcut/bias"])
    return {k: v.contiguous() for k, v in out.items()}


def _check_block(x, unit_params, h, w, unit_specs):
    if x.dim() != 4 or tuple(x.shape[1:3]) != (h, w):
        raise ValueError(f"x shape {tuple(x.shape)}, want (N, {h}, {w}, C)")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_block takes a bf16 stream, got {x.dtype}")
    if len(unit_params) != len(unit_specs) or not unit_params:
        raise ValueError("one has_shortcut flag per unit, at least one unit")
    cb = unit_params[0]["w1"].shape[0]
    c = x.shape[-1]
    for p, sc in zip(unit_params, unit_specs):
        missing = set(_keys(sc)) - set(p)
        if missing:
            raise ValueError(f"unit operands lack {sorted(missing)}")
        if p["w1"].shape[0] != cb:
            raise ValueError("a chain shares one Cb")
        if p["w1"].shape[1] != c:
            raise ValueError(f"w1 takes Cin={p['w1'].shape[1]}, stream has {c}")
        if not sc and p["w3"].shape[0] != c:
            raise ValueError("an identity shortcut needs Cout == Cin")
        c = p["w3"].shape[0]


def unit_preact(p: Dict[str, torch.Tensor]) -> Preact:
    """The pre-activation of a K2 unit (mode 0) from its operands."""
    return Preact(p["pA"], p["pB"], None, 0)


def _conv_plain(xq, wt, stride, epilogue, mul=None, add=None, **kw):
    return epilogue_reference(conv_s8_reference(xq, wt, stride), epilogue,
                              mul, add, **kw)


def _unit_plain(x, p, has_shortcut, nxt):
    """One K2 unit on the plain versions; ``nxt`` is the next unit's
    ``Preact`` for the last conv to quantise. Returns (out, the next unit's
    pq or None)."""
    pq = preact_quant_reference(x, p["pA"], p["pB"], mode=0)
    if has_shortcut:
        shortcut = _conv_plain(pq, p["wsc"], 1, "dequant_f32", p["dscm"],
                               p["dsca"])
    else:
        shortcut = x
    h1 = _conv_plain(pq, p["w1"], 1, "requant", p["q1m"], p["q1a"],
                     relu=True, fma=True)
    h2 = _conv_plain(h1, p["w2"], 1, "requant", p["q2m"], p["q2a"],
                     relu=True, fma=True)
    out = _conv_plain(h2, p["w3"], 1, "residual", p["d3m"], p["d3a"],
                      residual=shortcut, preact=nxt)
    return out if nxt is not None else (out, None)


# Shared memory a block may take on an H100 (227 KB).
K2_SMEM_MAX = 232448
# Layout constants of csrc/k2_unit.cu: the padding of every activation row,
# the weight ring's least and most slots and its padded 64-byte rows; one
# warp's tile is 64 pixels x 32 channels and a block has 8 warps.
_K2_PAD, _K2_STAGES, _K2_BROW = 16, (3, 8), 80
_K2_WARPS, _K2_WARP_ROWS = 8, 64


class K2Plan(NamedTuple):
    """How the K2 kernel runs one unit: each block computes ``rows`` output
    rows of one frame (``tiles`` blocks a frame, ``grid`` in all) with
    ``warp_rows`` of its 8 warps along the pixels (one pass of 64 *
    warp_rows pixels, 256 / warp_rows channels a chunk), its weights
    through a ring of ``stages`` slots, in ``smem_bytes`` of shared
    memory."""

    rows: int
    tiles: int
    warp_rows: int
    stages: int
    smem_bytes: int
    grid: int


def _round128(b: int) -> int:
    return (b + 127) // 128 * 128


def _k2_smem(h, w, cin, cb, rows, warp_rows, has_shortcut, stages):
    """Shared memory of one K2 block (csrc/k2_unit.cu's ``layout``): the
    zero-bordered h1 plane of rows + 2 rows, pq of the tile's rows and
    their halo, h2 (in pq's place without a projection shortcut) and the
    weight ring of ``stages`` slots."""
    h1 = _round128((rows + 2) * (w + 2) * (cb + _K2_PAD))
    pq = _round128(min(rows + 2, h) * w * (cin + _K2_PAD))
    h2 = _round128(rows * w * (cb + _K2_PAD))
    region = pq + h2 if has_shortcut else max(pq, h2)
    nc = _K2_WARPS // warp_rows * 32
    return h1 + region + stages * nc * _K2_BROW


def _k2_warp_rows(pixels: int) -> int:
    """Warps along the pixels: the fewest whose pass covers ``pixels``."""
    for wm in (1, 2, 4):
        if pixels <= wm * _K2_WARP_ROWS:
            return wm
    return 4


def k2_plan(n: int, h: int, w: int, cin: int, cb: int, cout: int,
            has_shortcut: bool) -> K2Plan:
    """The K2 kernel's tiles for one unit (pure, no device).

    A block takes whole rows of one frame: the largest row count whose
    pixels and one-row halo (phase A's pixels) fit one 256-pixel pass and
    whose shared memory fits ``K2_SMEM_MAX``; then the frame's rows are
    split evenly over as many tiles (7-row tiles at 28x28 and 14x14, the
    whole frame at 7x7). Two frames a block do not fit at 7x7 with Cin
    2048 (their pq alone is 202 KB). The weight ring takes what shared
    memory is left, up to 8 slots. Raises ``ValueError`` for what the
    kernel does not take: channel counts that are not positive multiples
    of 32, an identity shortcut with Cin != Cout, a row too wide for the
    shared memory.
    """
    if min(cin, cb, cout) <= 0 or cin % 32 or cb % 32 or cout % 32:
        raise ValueError(
            f"the K2 kernel takes channel counts that are multiples of 32, "
            f"got Cin={cin}, Cb={cb}, Cout={cout}")
    if not has_shortcut and cin != cout:
        raise ValueError(f"an identity shortcut needs Cout == Cin, got "
                         f"Cin={cin}, Cout={cout}")
    if min(n, h, w) < 1:
        raise ValueError(f"no K2 tile for n={n}, h={h}, w={w}")

    least, most = _K2_STAGES

    def fits(rows):
        pixels = min(rows + 2, h) * w
        smem = _k2_smem(h, w, cin, cb, rows, _k2_warp_rows(pixels),
                        has_shortcut, least)
        return smem <= K2_SMEM_MAX and (pixels <= 4 * _K2_WARP_ROWS
                                        or rows == 1)

    largest = next((r for r in range(h, 0, -1) if fits(r)), None)
    if largest is None:
        raise ValueError(f"a {w}-pixel row of Cin={cin}, Cb={cb} does not "
                         f"fit the K2 kernel's shared memory")
    tiles = -(-h // largest)
    rows = -(-h // tiles)
    wm = _k2_warp_rows(min(rows + 2, h) * w)
    stages = max(s for s in range(least, most + 1)
                 if _k2_smem(h, w, cin, cb, rows, wm, has_shortcut, s)
                 <= K2_SMEM_MAX)
    return K2Plan(rows, tiles, wm, stages,
                  _k2_smem(h, w, cin, cb, rows, wm, has_shortcut, stages),
                  n * tiles)


@functools.lru_cache(maxsize=None)
def _k2_library() -> ctypes.CDLL:
    """The built K2 library, with its C signatures declared."""
    from human_dynamics_tpu_torch.ops._build import load_kernel_library

    lib = load_kernel_library(K2_KERNEL_NAME).lib
    lib.k2_unit_launch.argtypes = ([ctypes.c_void_p] * 20
                                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.k2_unit_launch.restype = ctypes.c_int
    lib.k2_unit_error_string.argtypes = [ctypes.c_int]
    lib.k2_unit_error_string.restype = ctypes.c_char_p
    return lib


def _check_unit(p, cin, has_shortcut):
    """K2's operands of one unit: int8 k-major weights and (C,) float32
    multipliers of the unit's widths. Returns (Cb, Cout)."""
    cb, cout = p["w1"].shape[0], p["w3"].shape[0]
    shapes = {"w1": (cb, cin), "w2": (cb, 9 * cb), "w3": (cout, cb),
              "pA": (cin,), "pB": (cin,), "q1m": (cb,), "q1a": (cb,),
              "q2m": (cb,), "q2a": (cb,), "d3m": (cout,), "d3a": (cout,)}
    if has_shortcut:
        shapes.update(wsc=(cout, cin), dscm=(cout,), dsca=(cout,))
    for k, shape in shapes.items():
        dtype = torch.int8 if k.startswith("w") else torch.float32
        if tuple(p[k].shape) != shape or p[k].dtype != dtype:
            raise ValueError(f"unit operand {k} is {tuple(p[k].shape)} "
                             f"{p[k].dtype}, want {shape} {dtype}")
    return cb, cout


def _unit_cuda(x, p, has_shortcut, nxt):
    """Launch the K2 kernel for one unit on PyTorch's current stream; the
    launch counts under LAUNCHES[BLOCK]. Returns (out, the next unit's pq
    or None)."""
    n, h, w, cin = x.shape
    cb, cout = _check_unit(p, cin, has_shortcut)
    plan = k2_plan(n, h, w, cin, cb, cout, has_shortcut)
    nx = nxt if nxt is not None else Preact(None, None, None, 0)
    if nxt is not None:
        if nxt.mode not in (0, 1):
            raise ValueError(f"K2 stores the bf16 stream: its next preact "
                             f"takes mode 0 or 1, not {nxt.mode}")
        _check_preact_operands(cout, *nxt)
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    pq = (None if nxt is None
          else torch.empty((n, h, w, cout), dtype=torch.int8,
                           device=x.device))
    sc = [p[k] for k in ("wsc", "dscm", "dsca")] if has_shortcut else [None] * 3
    vectors = [p[k] for k in ("q1m", "q1a", "q2m", "q2a", "d3m", "d3a")]
    _check_cuda_layout(
        _operands(x, out, pq, p["w1"], p["w2"], p["w3"], sc[0], p["pA"],
                  p["pB"], nx.pa, nx.pb),
        _operands(*vectors, sc[1], sc[2], nx.s))
    lib = _k2_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.k2_unit_launch(
            x.data_ptr(), out.data_ptr(), _ptr(pq), p["pA"].data_ptr(),
            p["pB"].data_ptr(), p["w1"].data_ptr(), p["q1m"].data_ptr(),
            p["q1a"].data_ptr(), p["w2"].data_ptr(), p["q2m"].data_ptr(),
            p["q2a"].data_ptr(), p["w3"].data_ptr(), p["d3m"].data_ptr(),
            p["d3a"].data_ptr(), _ptr(sc[0]), _ptr(sc[1]), _ptr(sc[2]),
            _ptr(nx.pa), _ptr(nx.pb), _ptr(nx.s), nx.mode, n, h, w, cin, cb,
            cout, plan.rows, plan.warp_rows, plan.stages, plan.smem_bytes,
            stream,
        )
    if code != 0:
        msg = lib.k2_unit_error_string(code).decode()
        raise RuntimeError(f"{BLOCK} launch failed: {msg} ({code})")
    LAUNCHES[BLOCK] += 1
    _count_preact(nxt)
    return out, pq


def fused_block_reference(x: torch.Tensor, unit_params: Sequence[Dict], *,
                          h: int, w: int,
                          unit_specs: Sequence[bool]) -> torch.Tensor:
    """Plain version of ``fused_block``, any device: every unit quantises
    its own pre-activation."""
    _check_block(x, unit_params, h, w, unit_specs)
    for p, sc in zip(unit_params, unit_specs):
        x, _ = _unit_plain(x, p, sc, None)
    return x


def fused_block_pq(x: torch.Tensor, unit_params: Sequence[Dict], *, h: int,
                   w: int, unit_specs: Sequence[bool],
                   pq: Optional[torch.Tensor] = None,
                   next_preact: Optional[Preact] = None):
    """``fused_block`` that carries pre-activations across its ends: ``pq``
    is the first unit's int8 pre-activation of x when the previous conv
    made it (checked, then unused: every unit quantises its own from x,
    which it reads anyway), and ``next_preact`` the operands of the unit
    after the chain, which the chain's last unit then quantises from its
    output too. Returns (out, the next unit's pq or None). CUDA tensors
    launch the K2 kernel once per unit, CPU tensors run the plain
    version."""
    tensors = [x] + [t for p in unit_params for t in p.values()]
    cuda = _device_of(tensors, "fused_block") == "cuda"
    if next_preact is not None and next_preact.mode not in (0, 1):
        raise ValueError(f"a K2 chain stores the bf16 stream: its next "
                         f"preact takes mode 0 or 1, not {next_preact.mode}")
    _check_block(x, unit_params, h, w, unit_specs)
    if pq is not None and (pq.shape != x.shape or pq.dtype != torch.int8):
        raise ValueError(f"pq must be int8 of x's shape {tuple(x.shape)}")
    unit = _unit_cuda if cuda else _unit_plain
    last = len(unit_params) - 1
    for i, (p, sc) in enumerate(zip(unit_params, unit_specs)):
        x, pq = unit(x, p, sc, next_preact if i == last else None)
    return x, pq


def fused_block(x: torch.Tensor, unit_params: Sequence[Dict], *, h: int,
                w: int, unit_specs: Sequence[bool]) -> torch.Tensor:
    """K2: a chain of stride-1 int8 bottleneck units (``_unit_body``).

    Args:
        x: (N, H, W, Cin) bf16 residual stream.
        unit_params: per-unit operand dicts from ``prepare_pallas_unit``.
        h/w: the spatial size, unchanged along the chain.
        unit_specs: one has_shortcut flag per unit.

    Returns:
        (N, H, W, Cout) bf16.
    """
    return fused_block_pq(x, unit_params, h=h, w=w,
                          unit_specs=unit_specs)[0]


def fused_bottleneck_unit(x: torch.Tensor, params: Dict, *, h: int, w: int,
                          has_shortcut: bool = False) -> torch.Tensor:
    """One fused unit (a chain of one); see ``fused_block``."""
    return fused_block(x, (params,), h=h, w=w, unit_specs=(has_shortcut,))
