"""Single-frame movie-strip hallucinator.

Counterpart of ``human_dynamics_tpu/models/hallucinator.py``: two relu
fc layers and a small-init fc, added to the input as a residual.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from human_dynamics_tpu_torch.models.init import xavier_uniform_


class Hallucinator(nn.Module):
    """phi (..., features) -> hallucinated movie strip (..., features)."""

    def __init__(self, features: int = 2048, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(features, features, device=device)
        self.fc2 = nn.Linear(features, features, device=device)
        self.fc3 = nn.Linear(features, features, device=device)
        self.init_weights(generator)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        xavier_uniform_(self.fc1.weight, 1.0, generator)
        xavier_uniform_(self.fc2.weight, 1.0, generator)
        xavier_uniform_(self.fc3.weight, 0.001, generator)
        for fc in (self.fc1, self.fc2, self.fc3):
            nn.init.zeros_(fc.bias)

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        net = F.relu(self.fc1(phi))
        net = F.relu(self.fc2(net))
        return self.fc3(net) + phi
