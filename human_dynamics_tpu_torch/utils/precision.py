"""Precision helpers.

- ``to_bf16``: the mixed-precision cast, counterpart of
  ``human_dynamics_tpu/utils/precision.py``'s ``tree_bf16``.
- ``full_fp32``: fp32 convolutions and matmuls in full fp32, not TF32, for
  the fp32 paths that are held to the JAX package (the predictor's fp32
  encoder and window tail, the training step).
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import torch
from torch import nn


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def to_bf16(obj):
    """Cast every fp32 tensor to bf16; anything else (int8 weights, int
    counters) is left alone.

    A module has its fp32 parameters and buffers cast in place and is
    returned; a mapping comes back as a new dict of the same keys. The
    tensor cast is differentiable, so a mapping of parameters cast here and
    applied with ``torch.func.functional_call`` gives fp32 gradients.
    """
    if isinstance(obj, nn.Module):
        with torch.no_grad():
            for t in list(obj.parameters()) + list(obj.buffers()):
                t.data = _bf16(t.data)
        return obj
    if isinstance(obj, Mapping):
        return {k: to_bf16(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return _bf16(obj)
    return obj


@contextlib.contextmanager
def full_fp32():
    """fp32 convolutions and matmuls in full fp32, not TF32, inside. On an
    H100 with cuDNN's TF32 default the fp32 predictor's omegas were 1.6e-4
    from the same model's on the CPU, and 7e-7 without TF32 (PERF.md, §7).
    The flags are process-wide: the device work inside runs on one thread
    (see infer/service.py); autograd's device threads run a backward
    started inside before it returns."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
