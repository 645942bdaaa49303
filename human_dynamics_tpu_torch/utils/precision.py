"""Mixed-precision cast, counterpart of ``human_dynamics_tpu/utils/precision.py``."""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def to_bf16(obj):
    """Cast every fp32 tensor to bf16; anything else (int8 weights, int
    counters) is left alone.

    A module has its fp32 parameters and buffers cast in place and is
    returned; a mapping comes back as a new dict of the same keys.
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
