"""Offline ResNet phi extraction for dataset building.

Counterpart of ``human_dynamics_tpu/datasets/phi_extractor.py`` (the
reference's FeatureExtractor, src/datasets/resnet_extractor.py:13-98):
batches of 64 crops, the tail zero-padded, through the frozen ResNet-50 v2
-> (N, 2048) features stored in the records (precomputed-phi training
mode). The ResNet runs in fp32 without TF32 (``utils.precision.full_fp32``),
as the port's fp32 predictor does, and on the card unless the CPU is asked
for.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping

import numpy as np
import torch

from human_dynamics_tpu_torch.infer.predictor import resolve_device
from human_dynamics_tpu_torch.models.resnet import ResNetV2_50
from human_dynamics_tpu_torch.utils.precision import full_fp32
from human_dynamics_tpu_torch.utils.weights import load_jax_variables


def resnet_from_variables(variables, device) -> ResNetV2_50:
    """A port ResNetV2_50 holding a flax variables tree: the tree's
    'resnet_v2_50' subtree when it has one (an HmmrModel(include_resnet)
    tree or a converted reference checkpoint), else the tree itself."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    if "resnet_v2_50" in params:
        params = params["resnet_v2_50"]
        batch_stats = batch_stats.get("resnet_v2_50", batch_stats)
    resnet = ResNetV2_50(device="meta").to_empty(device=device)
    return load_jax_variables(
        resnet, {"params": params, "batch_stats": batch_stats})


def _on(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device`` ('cuda' is the current card)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return t.device == device


class FeatureExtractor:
    def __init__(self, resnet, batch_size: int = 64, device=None):
        """resnet: a port ``ResNetV2_50`` (copied when it lies on another
        device), a flax variables tree in the JAX package's layout (see
        ``resnet_from_variables``), or the path of an npz checkpoint (a
        Trainer checkpoint's ``params_e`` is taken) or the prefix of a
        reference TF-slim checkpoint. ``device``: None is
        the card, and raises without one; the CPU runs only when asked."""
        from human_dynamics_tpu_torch.eval.harness import load_model_variables

        self.device = resolve_device(device)
        if isinstance(resnet, str):
            resnet = load_model_variables(resnet)
        if isinstance(resnet, Mapping):
            resnet = resnet_from_variables(resnet, self.device)
        elif not all(_on(t, self.device)
                     for t in resnet.state_dict().values()):
            resnet = copy.deepcopy(resnet).to(self.device)
        self.resnet = resnet.eval()
        self.batch_size = batch_size

    @torch.no_grad()
    def compute_all_phis(self, images) -> np.ndarray:
        """(N, H, W, 3) images in [-1, 1], numpy or a tensor (one already on
        the extractor's device is not copied) -> (N, 2048) float32 numpy
        features (resnet_extractor.py:74-98). Batches of ``batch_size``;
        the last is zero-padded, which changes no phi (BatchNorm in
        inference mode)."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        n, bs = images.shape[0], self.batch_size
        phis = []
        with full_fp32():
            for start in range(0, n, bs):
                batch = images[start:start + bs]
                if batch.shape[0] < bs:
                    batch = torch.cat([batch, batch.new_zeros(
                        (bs - batch.shape[0],) + batch.shape[1:])])
                phis.append(self.resnet(batch))
        return torch.cat(phis)[:n].cpu().numpy()
