"""Iterative-error-feedback (IEF) Omega regressor.

Counterpart of ``human_dynamics_tpu/models/ief.py``: the shared 3-layer MLP
(fc1024 -> dropout 0.5 -> fc1024 -> dropout 0.5 -> fc{out}) and the
additive refinement over ``num_stage`` stages with shared weights. Each
stage reads ``[phi, theta]`` in that order.

Dropout is active only with ``train=True``, and then draws its masks from
the ``torch.Generator`` passed in (never from the global RNG): a fresh
mask per layer and per stage call, as flax draws one per ``nn.Dropout``
call. Kept values are scaled by 1 / keep, as flax does. Under data
parallelism the generator comes as a ``RowBlock``: each mask is drawn at
the global batch's shape and this rank keeps its rows, so the ranks
together apply the masks of the single-process step. On a (data, time)
mesh a rank's rows are a (data, time) block of the (B, T) grid, not a
contiguous run of the b·T rows: the mask is drawn at (B, T, ...) and the
block kept.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from human_dynamics_tpu_torch.models.init import xavier_uniform_


class RowBlock(NamedTuple):
    """A dropout generator of a sharded step: every rank draws each mask at
    the global shape, in the same order, and keeps its block. The rows are
    the (B, T) grid flattened; the rank holds block ``index`` of ``parts``
    along B and block ``time_index`` of ``time_parts`` along T, ``frames``
    frames of each of its tubes."""

    generator: torch.Generator
    index: int
    parts: int
    frames: int
    time_index: int
    time_parts: int


def dropout(x: torch.Tensor, rate: float,
            generator: Union[torch.Generator, RowBlock]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    and scale it by 1 / (1 - rate); the mask comes from ``generator``."""
    keep = 1.0 - rate
    if isinstance(generator, RowBlock):
        g, rest = generator, x.shape[1:]
        bl, tl = x.shape[0] // g.frames, g.frames
        draws = torch.rand((bl * g.parts, tl * g.time_parts) + rest,
                           generator=g.generator, device=x.device)
        block = draws[g.index * bl:(g.index + 1) * bl,
                      g.time_index * tl:(g.time_index + 1) * tl]
        mask = block.reshape(x.shape) < keep
    else:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class IefRegressor(nn.Module):
    """state (N, in_features) -> delta (N, num_output)."""

    dropout_rate = 0.5

    def __init__(self, in_features: int, num_output: int = 85, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 1024, device=device)
        self.fc2 = nn.Linear(1024, 1024, device=device)
        self.fc3 = nn.Linear(1024, num_output, device=device)
        self.init_weights(generator)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        xavier_uniform_(self.fc1.weight, 1.0, generator)
        xavier_uniform_(self.fc2.weight, 1.0, generator)
        xavier_uniform_(self.fc3.weight, 0.01, generator)
        for fc in (self.fc1, self.fc2, self.fc3):
            nn.init.zeros_(fc.bias)

    def forward(self, state: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train and generator is None:
            raise ValueError("train=True needs a generator for the dropout")
        net = F.relu(self.fc1(state))
        if train:
            net = dropout(net, self.dropout_rate, generator)
        net = F.relu(self.fc2(net))
        if train:
            net = dropout(net, self.dropout_rate, generator)
        return self.fc3(net)


def ief_refine(regressor: IefRegressor, phi: torch.Tensor,
               omega_start: torch.Tensor, num_stage: int = 3,
               train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """num_stage additive refinements of omega_start (N, num_output)."""
    theta = omega_start
    for _ in range(num_stage):
        theta = theta + regressor(torch.cat([phi, theta], dim=1), train,
                                  generator)
    return theta
