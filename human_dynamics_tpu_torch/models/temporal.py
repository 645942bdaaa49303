"""AZ_FC2GN temporal "movie strip" encoder.

Counterpart of ``human_dynamics_tpu/models/temporal.py``. Each residual
block is GN -> relu -> conv[3] -> GN -> relu -> conv[3] -> +skip over
(B, T, C) features. The flax GroupNorm normalises over (T, channels of the
group); torch's GroupNorm on (B, C, T) with 32 contiguous channel groups
computes the same statistics (eps 1e-6). As in flax, the statistics and the
normalisation are f32 whatever the input dtype, and the result takes the
input's dtype (bf16 under ``bf16_temporal``). The public layout stays
(B, T, C); it is permuted to (B, C, T) once for the whole stack.

Receptive field: fov = 4 * num_layers + 1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from human_dynamics_tpu_torch.models.init import lecun_normal_, xavier_uniform_


def _group_norm(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``gn`` computed in f32, returned in x's dtype."""
    return F.group_norm(
        x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(), gn.eps
    ).to(x.dtype)


class TemporalBlockFC2GN(nn.Module):
    """One pre-norm residual temporal conv block on (B, C, T)."""

    def __init__(self, num_filter: int = 2048, kernel_width: int = 3,
                 device=None):
        super().__init__()
        pad = (kernel_width - 1) // 2
        self.gn1 = nn.GroupNorm(32, num_filter, eps=1e-6, device=device)
        self.conv1 = nn.Conv1d(num_filter, num_filter, kernel_width,
                               padding=pad, device=device)
        self.gn2 = nn.GroupNorm(32, num_filter, eps=1e-6, device=device)
        self.conv2 = nn.Conv1d(num_filter, num_filter, kernel_width,
                               padding=pad, device=device)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.conv1.weight, generator)
        xavier_uniform_(self.conv2.weight, 0.001, generator)
        for conv in (self.conv1, self.conv2):
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.conv1(F.relu(_group_norm(self.gn1, x)))
        net = self.conv2(F.relu(_group_norm(self.gn2, net)))
        return net + x


class TemporalEncoderFC2GN(nn.Module):
    """num_layers temporal blocks: phi (B, T, C) -> movie strip (B, T, C)."""

    def __init__(self, num_layers: int = 3, num_filter: int = 2048,
                 kernel_width: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(
                f"block_{i}",
                TemporalBlockFC2GN(num_filter, kernel_width, device=device),
            )
        self.init_weights(generator)

    @property
    def fov(self) -> int:
        return 4 * self.num_layers + 1

    def init_weights(self, generator: Optional[torch.Generator] = None):
        for block in self.children():
            block.init_weights(generator)

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        net = phi.transpose(1, 2)
        for block in self.children():
            net = block(net)
        return net.transpose(1, 2)
