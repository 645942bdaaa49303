"""The flax initializers the JAX models use, drawn from a torch.Generator.

Tests load flax-initialised weights through ``utils.weights``; these exist
so that a model made from a seed alone (``chip_smoke.py``) has the same
weight scales as the JAX one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# The std of a standard normal truncated to [-2, 2]; flax's lecun_normal
# divides by it so the truncated draw keeps variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _fans(weight: torch.Tensor):
    """(fan_in, fan_out) of a torch Linear/Conv weight (out, in, *k)."""
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """flax ``lecun_normal``: truncated normal with variance 1 / fan_in."""
    std = math.sqrt(1.0 / _fans(weight)[0]) / _TRUNC_STD
    return nn.init.trunc_normal_(
        weight, std=std, a=-2 * std, b=2 * std, generator=generator
    )


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor, scale: float = 1.0,
                    generator: Optional[torch.Generator] = None):
    """flax ``variance_scaling(scale, "fan_avg", "uniform")``."""
    return nn.init.xavier_uniform_(
        weight, gain=math.sqrt(scale), generator=generator
    )
