"""Iterative-error-feedback (IEF) Omega regressor, inference form.

Counterpart of ``human_dynamics_tpu/models/ief.py``: the shared 3-layer MLP
(fc1024 -> fc1024 -> fc{out}; dropout is inactive at inference) and the
additive refinement over ``num_stage`` stages with shared weights. Each
stage reads ``[phi, theta]`` in that order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from human_dynamics_tpu_torch.models.init import xavier_uniform_


class IefRegressor(nn.Module):
    """state (N, in_features) -> delta (N, num_output)."""

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

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        net = F.relu(self.fc1(state))
        net = F.relu(self.fc2(net))
        return self.fc3(net)


def ief_refine(regressor: IefRegressor, phi: torch.Tensor,
               omega_start: torch.Tensor, num_stage: int = 3) -> torch.Tensor:
    """num_stage additive refinements of omega_start (N, num_output)."""
    theta = omega_start
    for _ in range(num_stage):
        theta = theta + regressor(torch.cat([phi, theta], dim=1))
    return theta
