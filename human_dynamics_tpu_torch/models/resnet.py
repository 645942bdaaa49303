"""ResNet-50 v2 (pre-activation) per-frame feature encoder.

Counterpart of ``human_dynamics_tpu/models/resnet.py`` (TF-slim
``resnet_v2_50`` with global pooling: 2048-D phi per frame). What the
slim layout needs, kept exactly:

- The stride goes on the *last* unit of blocks 1-3.
- An identity shortcut subsamples the raw input; a projection shortcut
  reads the pre-activation.
- Slim's ``conv2d_same`` pads (k-1)//2 on both sides for stride > 1; with
  the odd kernels used here that equals the stride-1 "SAME" padding.
- The root 3x3/2 max pool is XLA "SAME": for an even input it pads (0, 1),
  not (1, 1), so it pads explicitly with -inf.
- BatchNorm (eps 1e-5) uses its moving statistics, or with ``train=True``
  the batch's mean and biased variance over N, H, W. Its moving averages
  (decay 0.997, fp32) advance only inside ``updating_batch_stats``, the
  counterpart of flax's ``mutable=["batch_stats"]``, and once per BatchNorm
  there: a unit that ``remat`` recomputes in the backward does not advance
  them again.
- ``remat`` checkpoints each bottleneck unit (``nn.remat`` in the JAX
  package): only unit inputs are kept for the backward.
- With a ``mesh``, train-mode BatchNorm normalises with the statistics of
  the frames of every rank along its batch axes (``data``, and ``time`` on a
  (data, time) mesh), as GSPMD makes them: each rank's fp32 mean and
  biased variance go to every rank in one ``parallel.mesh.psum``, which
  every rank combines alike (the global mean, then the mean of the squared
  deviations from it); the backward sums their gradients over the ranks in
  one more. A remat recompute runs the forward one again, on every rank.
- The inference branch returns the type flax's promotion gives: a bf16
  input with the fp32 moving statistics of a bf16 training step
  (``freeze_bn_stats``) comes out fp32, and so does the trunk after it.

The public input is NHWC, as in the JAX package; it is permuted to NCHW
once at the trunk's entry. Module names follow the flax tree
(``block{i}.unit_{j}`` for ``block{i}/unit_{j}/bottleneck_v2``), so that
``utils.weights`` maps one onto the other.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from human_dynamics_tpu_torch.models.init import lecun_normal_
from human_dynamics_tpu_torch.parallel.mesh import psum

RESNET50_BLOCKS = ((3, 256, 64), (4, 512, 128), (6, 1024, 256), (3, 2048, 512))


class SlimBatchNorm(nn.Module):
    """BatchNorm with slim's names: gamma, beta, moving_mean,
    moving_variance (eps 1e-5, moving-average decay 0.997)."""

    momentum = 0.997

    def __init__(self, channels: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("moving_mean", torch.zeros(channels, device=device))
        self.register_buffer("moving_variance", torch.ones(channels, device=device))
        # Set by updating_batch_stats; cleared by the update it allows.
        self.update_pending = False

    def forward(self, x: torch.Tensor, train: bool = False,
                mesh=None) -> torch.Tensor:
        """x (N, C, H, W). With ``train`` it normalises with the batch's
        statistics (every rank's, under a data ``mesh``); else with the
        moving ones, in the promoted type of ``x`` and the statistics (fp32
        for a bf16 ``x`` in a bf16 training step, as flax computes it)."""
        if not train:
            inv = torch.rsqrt(self.moving_variance + self.epsilon) * self.gamma
            shift = self.beta - self.moving_mean * inv
            return x * inv[:, None, None] + shift[:, None, None]
        # In fp32 until one rounding to x's type, as jnp.mean and jnp.var
        # compute a bf16 input's; a data-parallel step combines the ranks'
        # fp32 moments before that rounding. torch.var would round a bf16
        # variance to bf16 first.
        mean = x.mean(dim=(0, 2, 3), dtype=torch.float32)
        var = (x.var(dim=(0, 2, 3), unbiased=False)
               if x.dtype == torch.float32 else _Variance.apply(x, mean))
        if mesh is not None:
            mean, var = _global_moments(mean, var, mesh)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        if self.update_pending:
            self.update_pending = False
            m = self.momentum
            with torch.no_grad():
                # In the buffers' fp32, as flax accumulates in the stored
                # dtype: a 0.003-scale increment would vanish in bf16.
                self.moving_mean.copy_(
                    m * self.moving_mean
                    + (1.0 - m) * mean.detach().to(self.moving_mean.dtype))
                self.moving_variance.copy_(
                    m * self.moving_variance
                    + (1.0 - m) * var.detach().to(self.moving_variance.dtype))
        inv = torch.rsqrt(var + self.epsilon) * self.gamma
        return x * inv[:, None, None] + (self.beta - mean * inv)[:, None, None]


class _Variance(torch.autograd.Function):
    """The biased variance of a bf16 x (N, C, H, W) over (N, H, W), in
    fp32, from the fp32 deviations from its fp32 ``mean`` (jnp.var's two
    passes). Only x and the mean are kept for the backward, as torch.var
    keeps x; the deviations are formed again there."""

    @staticmethod
    def forward(ctx, x, mean):
        ctx.save_for_backward(x, mean)
        dev = x.float() - mean[:, None, None]
        return dev.square_().mean(dim=(0, 2, 3))

    @staticmethod
    def backward(ctx, grad):
        x, mean = ctx.saved_tensors
        scale = grad * (2.0 * x.shape[1] / x.numel())
        dx = (x.float() - mean[:, None, None]) * scale[:, None, None]
        # d var / d mean = -2 mean(x - mean) is zero.
        return dx.to(x.dtype), None


def _global_moments(mean: torch.Tensor, var: torch.Tensor, mesh):
    """The fp32 mean and biased variance of the frames of every rank along
    the mesh's batch axes from each rank's own (every rank holds as many
    frames), by one ``psum`` of every rank's pair placed in its row of a
    zeroed (ranks, 2, C) buffer: the
    global mean, then the mean of the squared deviations from it (each
    rank's variance plus its mean's squared distance from the global one),
    summed in rank order on every rank. With one rank they are ``mean`` and
    ``var`` unchanged."""
    axes = mesh.batch_axes
    world = mesh.axis_size(axes)
    rows = torch.zeros((world, 2) + mean.shape, device=mean.device)
    rows[mesh.index(axes)] = torch.stack([mean.float(), var.float()])
    m, v = psum(rows, mesh, axes).unbind(1)
    g_mean = (m * (1.0 / world)).sum(0)
    g_var = ((v + (m - g_mean) ** 2) * (1.0 / world)).sum(0)
    return g_mean, g_var


@contextlib.contextmanager
def updating_batch_stats(module: nn.Module):
    """Inside, each train-mode SlimBatchNorm of ``module`` advances its moving
    averages at its first call, in place; later calls (a remat recompute, a
    second forward) only normalise."""
    bns = [m for m in module.modules() if isinstance(m, SlimBatchNorm)]
    for bn in bns:
        bn.update_pending = True
    try:
        yield
    finally:
        for bn in bns:
            bn.update_pending = False


def _conv(cin, cout, kernel, stride, bias, device):
    return nn.Conv2d(
        cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2,
        bias=bias, device=device,
    )


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2):
    """Max pool with XLA "SAME" padding, which puts the odd pad at the end."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        out = math.ceil(size / stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck unit (slim resnet_v2.bottleneck)."""

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int,
                 stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.preact = SlimBatchNorm(depth_in, device=device)
        self.shortcut = (
            None if depth == depth_in
            else _conv(depth_in, depth, 1, stride, True, device)
        )
        self.conv1 = _conv(depth_in, depth_bottleneck, 1, 1, False, device)
        self.conv1_bn = SlimBatchNorm(depth_bottleneck, device=device)
        self.conv2 = _conv(depth_bottleneck, depth_bottleneck, 3, stride,
                           False, device)
        self.conv2_bn = SlimBatchNorm(depth_bottleneck, device=device)
        self.conv3 = _conv(depth_bottleneck, depth, 1, 1, True, device)

    def forward(self, x: torch.Tensor, train: bool = False,
                mesh=None) -> torch.Tensor:
        preact = F.relu(self.preact(x, train, mesh))
        if self.shortcut is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut(preact)
        residual = F.relu(self.conv1_bn(self.conv1(preact), train, mesh))
        residual = F.relu(self.conv2_bn(self.conv2(residual), train, mesh))
        return shortcut + self.conv3(residual)


def _rematerialised(unit: BottleneckV2, x: torch.Tensor, train: bool,
                    mesh=None):
    """``unit(x, train, mesh)`` keeping only ``x`` for the backward, which
    runs the unit again. The unit's parameters go in as arguments, so that
    the recompute sees the tensors the forward saw (the bf16 casts under
    ``torch.func.functional_call``), not the module's own."""
    names, tensors = zip(*unit.named_parameters())

    def run(x, *tensors):
        return functional_call(unit, dict(zip(names, tensors)),
                               (x, train, mesh))

    return checkpoint(run, x, *tensors, use_reentrant=False,
                      preserve_rng_state=False)


class ResNetV2_50(nn.Module):
    """resnet_v2_50 trunk: (N, H, W, 3) images in [-1, 1] -> (N, 2048)."""

    def __init__(
        self,
        blocks: Sequence[Tuple[int, int, int]] = RESNET50_BLOCKS,
        device=None,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.conv1 = _conv(3, 64, 7, 2, True, device)
        depth_in = 64
        self.num_blocks = len(blocks)
        for bi, (num_units, depth, depth_bottleneck) in enumerate(blocks, 1):
            units = nn.ModuleDict()
            for ui in range(1, num_units + 1):
                last = ui == num_units and bi < len(blocks)
                units[f"unit_{ui}"] = BottleneckV2(
                    depth_in, depth, depth_bottleneck, 2 if last else 1,
                    device=device,
                )
                depth_in = depth
            self.add_module(f"block{bi}", units)
        self.postnorm = SlimBatchNorm(depth_in, device=device)
        self.init_weights(generator)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun-normal kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, train: bool = False,
                mesh=None) -> torch.Tensor:
        """``train``: BatchNorm on the batch's statistics (every rank's
        frames under a data ``mesh``)."""
        net = self.conv1(x.permute(0, 3, 1, 2))
        net = max_pool_same(net)
        remat = self.remat and torch.is_grad_enabled()
        for bi in range(1, self.num_blocks + 1):
            for unit in getattr(self, f"block{bi}").values():
                net = (_rematerialised(unit, net, train, mesh) if remat
                       else unit(net, train, mesh))
        net = F.relu(self.postnorm(net, train, mesh))
        return net.mean(dim=(2, 3))
