"""LSGAN pose-prior discriminator.

Counterpart of ``human_dynamics_tpu/models/discriminator.py``. The input is
the rotation matrices of the 23 non-global joints, (N, 23, 9). Two shared
per-joint Dense layers to 32 channels, then 23 per-joint linear heads (one
einsum against a (23, 32) weight) and an all-joints fc1024-fc1024-fc1 head;
output (N, 24) logits. Module and parameter names are the flax ones, so
``utils.weights`` maps them without a table.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from human_dynamics_tpu_torch.models.init import xavier_uniform_


class PoseDiscriminator(nn.Module):
    """poses_rot (N, 23, 9) or (N, 23, 3, 3) -> logits (N, 24)."""

    def __init__(self, num_joints: int = 23, hidden: int = 32,
                 nz_feat: int = 1024, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_joints = num_joints
        self.D_conv1 = nn.Linear(9, hidden, device=device)
        self.D_conv2 = nn.Linear(hidden, hidden, device=device)
        self.per_joint_w = nn.Parameter(
            torch.empty(num_joints, hidden, device=device))
        self.per_joint_b = nn.Parameter(torch.empty(num_joints, device=device))
        self.D_alljoints_fc1 = nn.Linear(num_joints * hidden, nz_feat,
                                         device=device)
        self.D_alljoints_fc2 = nn.Linear(nz_feat, nz_feat, device=device)
        self.D_alljoints_out = nn.Linear(nz_feat, 1, device=device)
        self.init_weights(generator)

    def _dense(self):
        return (self.D_conv1, self.D_conv2, self.D_alljoints_fc1,
                self.D_alljoints_fc2, self.D_alljoints_out)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        for fc in self._dense():
            xavier_uniform_(fc.weight, 1.0, generator)
            nn.init.zeros_(fc.bias)
        xavier_uniform_(self.per_joint_w, 1.0, generator)
        nn.init.zeros_(self.per_joint_b)

    def forward(self, poses_rot: torch.Tensor) -> torch.Tensor:
        n = poses_rot.shape[0]
        x = poses_rot.reshape(n, self.num_joints, 9)
        x = F.relu(self.D_conv1(x))
        x = F.relu(self.D_conv2(x))
        theta_out = torch.einsum("njh,jh->nj", x, self.per_joint_w)
        theta_out = theta_out + self.per_joint_b                 # (N, 23)
        h = F.relu(self.D_alljoints_fc1(x.reshape(n, -1)))
        h = F.relu(self.D_alljoints_fc2(h))
        all_out = self.D_alljoints_out(h)                        # (N, 1)
        return torch.cat([theta_out, all_out], dim=1)
