"""Tensor-parallel parameter sharding: the port's ``shard_params_tp``.

Counterpart of ``shard_params_tp`` in ``human_dynamics_tpu/parallel/mesh.py``.
The policy is the JAX package's, read on each parameter's JAX layout
(``utils.weights.variable_map``): a weight of at least 2 dims whose last
dim (its output features) is at least ``min_dim`` wide and divisible by the
``model`` axis's size is split over that axis; everything else stays
whole on every rank. In the port that last dim is dim 0 of an
``nn.Linear``, ``nn.Conv1d`` or ``nn.Conv2d`` weight: the IEF heads' fc1
and fc2, the temporal convs and the hallucinator at 2048 features, the
discriminator's all-joints fc1 and fc2, and in image mode the ResNet's
wide convs.

GSPMD writes the collectives for the JAX package; here each sharded
layer's forward is replaced by its column-parallel one:

- the rank computes its slice of output features from the whole input;
- the slices are gathered over the ``model`` row (one ``all_reduce`` of a
  zeroed buffer into which each rank writes its slice: gloo runs it on
  CUDA tensors, and x + 0 is exact);
- the whole bias is added after the gather, so its gradient is the same on
  every model rank.

Every model rank of a data row holds the same rows and computes the same
loss from the same gathered activations, so the backward of the gather
takes the rank's own slice of the incoming gradient and sums nothing
(a sum would make it m-fold). The input's gradient, which each rank
computes from its slice of the weight only, is summed over the model row
(the input's identity forward has that backward). So every replicated
parameter gets the whole gradient on every model rank, and every gradient,
sharded or not, is then summed over ``data`` alone (``train.trainer``).
Adam's moments of a sharded weight stay with their slice.

``gathered`` puts the whole tensors back for a while (checkpoints: rank 0
writes the JAX-layout npz of the whole model; a restore loads whole
tensors, which are sharded again on the way out).
"""

from __future__ import annotations

import contextlib
import types
from typing import Iterator, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from human_dynamics_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    _flat_collective,
    all_sum,
)


class Shard(NamedTuple):
    """The sharding of a module's weight: split over ``axis`` of ``mesh``
    along dim 0, ``full`` output features in all."""

    mesh: Mesh
    axis: str
    full: int

    @property
    def width(self) -> int:
        return self.full // self.mesh.shape[self.axis]

    @property
    def start(self) -> int:
        return self.mesh.index(self.axis) * self.width


class _Gather(torch.autograd.Function):
    """Forward: the ranks' output slices along ``dim`` assembled whole on
    every rank. Backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, shard: Shard, dim: int):
        ctx.shard, ctx.dim = shard, dim
        shape = list(y.shape)
        shape[dim] = shard.full
        buf = y.new_zeros(shape)
        buf.narrow(dim, shard.start, shard.width).copy_(y)
        return all_sum(buf, shard.mesh, shard.axis)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        return grad.narrow(ctx.dim, s.start, s.width), None, None


class _Replicated(torch.autograd.Function):
    """Forward: the input as it is. Backward: its gradient summed over the
    model row (each rank's holds only its weight slice's share)."""

    @staticmethod
    def forward(ctx, x, shard: Shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        return all_sum(grad.clone(memory_format=torch.contiguous_format),
                       s.mesh, s.axis), None


def _linear_columns(self, x):
    s = self._tp
    y = _Gather.apply(F.linear(_Replicated.apply(x, s), self.weight), s,
                      x.dim() - 1)
    return y if self.bias is None else y + self.bias


def _conv_columns(self, x):
    s = self._tp
    y = _Gather.apply(self._conv_forward(_Replicated.apply(x, s),
                                         self.weight, None), s, 1)
    if self.bias is None:
        return y
    return y + self.bias.reshape((-1,) + (1,) * (y.dim() - 2))


_FORWARDS = {nn.Linear: _linear_columns, nn.Conv1d: _conv_columns,
             nn.Conv2d: _conv_columns}


def _modules(tree) -> List[Tuple[nn.Module, object]]:
    """(model, its optimizer or None) of a TrainState or a module."""
    if isinstance(tree, nn.Module):
        return [(tree, None)]
    if all(hasattr(tree, k) for k in ("hmmr", "disc", "opt_e", "opt_d")):
        return [(tree.hmmr, tree.opt_e), (tree.disc, tree.opt_d)]
    raise TypeError(f"shard_params_tp takes a TrainState or an nn.Module, "
                    f"not {type(tree).__name__}")


def _policy(module: nn.Module, model_size: int,
              min_dim: int = 128) -> List[str]:
    """The names of ``module``'s parameters that the JAX policy shards over
    a ``model`` axis of ``model_size`` ranks, by their JAX layout."""
    # Imported here: the models import this package.
    from human_dynamics_tpu_torch.utils.weights import variable_map

    mapping = variable_map(module)
    out = []
    for name, p in module.named_parameters():
        perm = mapping[name][1]
        shape = (tuple(p.shape) if perm is None
                 else tuple(p.shape[i] for i in np.argsort(perm)))
        if (len(shape) >= 2 and shape[-1] >= min_dim
                and shape[-1] % model_size == 0):
            out.append(name)
    return out


def _sharded(tree) -> Iterator[Tuple[nn.Module, object]]:
    """(module holding a sharded weight, the optimizer stepping it)."""
    for model, opt in _modules(tree):
        for m in model.modules():
            if "_tp" in m.__dict__:
                yield m, opt


def is_sharded(tree) -> bool:
    """Whether any weight of a TrainState or module is TP-sharded."""
    return next(_sharded(tree), None) is not None


@torch.no_grad()
def _replace(m: nn.Module, opt, fn) -> None:
    """Each tensor that takes ``m``'s weight's shape (the weight, its
    gradient, its Adam moments) replaced by ``fn`` of it; the weight
    first, as a gradient must match it."""
    p = m.weight
    p.data = fn(p.data)
    if p.grad is not None:
        p.grad = fn(p.grad)
    state = opt.state.get(p, {}) if opt is not None else {}
    for k in ("exp_avg", "exp_avg_sq"):
        if k in state:
            state[k] = fn(state[k])


def _slice_all(tree) -> None:
    """Each sharded weight, gradient and moment cut to this rank's slice."""
    for m, opt in _sharded(tree):
        s = m._tp
        _replace(m, opt, lambda t: t.narrow(0, s.start, s.width).clone()
                 if t.shape[0] == s.full else t)


def shard_params_tp(tree, mesh: Mesh, model_axis: str = MODEL_AXIS,
                    min_dim: int = 128):
    """Tensor-parallel hook: every weight of ``tree`` (a Trainer's
    TrainState, or a module) that the JAX policy picks is cut, in place,
    to this rank's slice of output features over ``model_axis``, with its
    gradient and Adam moments, and its layer computes column-parallel.
    Every rank of the mesh calls it on the same state. Returns ``tree``."""
    if model_axis not in mesh.shape:
        raise ValueError(f"shard_params_tp: the mesh has no {model_axis!r} "
                         f"axis (axes {mesh.axis_names})")
    if is_sharded(tree):
        raise ValueError("shard_params_tp: the state is sharded already")
    size = mesh.shape[model_axis]
    for model, _ in _modules(tree):
        mods = dict(model.named_modules())
        for name in _policy(model, size, min_dim):
            mod_name, _, pname = name.rpartition(".")
            m = mods[mod_name]
            if pname != "weight" or type(m) not in _FORWARDS:
                raise ValueError(
                    f"shard_params_tp: the policy picks {name}, which has "
                    "no column-parallel forward")
            m._tp = Shard(mesh, model_axis, m.weight.shape[0])
            m.forward = types.MethodType(_FORWARDS[type(m)], m)
    _slice_all(tree)
    return tree


@contextlib.contextmanager
def gathered(tree):
    """Inside, every TP-sharded weight of ``tree`` (with its gradient and
    Adam moments) is whole on every rank, gathered by one ``all_reduce``
    per dtype over the model row; on the way out each rank keeps its slice
    of what they then hold (so tensors loaded inside are sharded). A no-op
    on a state with nothing sharded; else every rank must enter it."""
    shards = list(_sharded(tree))
    if not shards:
        yield tree
        return
    whole = []

    def placed(t, s):
        full = t.new_zeros((s.full,) + t.shape[1:])
        full.narrow(0, s.start, s.width).copy_(t)
        whole.append(full)
        return full

    for m, opt in shards:
        _replace(m, opt, lambda t, s=m._tp: placed(t, s))
    s = shards[0][0]._tp
    with torch.no_grad():
        _flat_collective(whole, lambda flat: all_sum(flat, s.mesh, s.axis))
    try:
        yield tree
    finally:
        _slice_all(tree)
