"""Carry weights from the JAX package into the port.

- ``load_jax_npz`` reads a checkpoint that the JAX package's
  ``save_checkpoint(path.npz, tree)`` wrote: flat keys joined with '::'
  (module names such as 'block1/unit_1/bottleneck_v2' contain '/').
- ``load_jax_variables`` copies a flax ``variables`` tree, given as numpy
  arrays, into a port module's parameters and buffers. Conv HWIO becomes
  OIHW, a 1-D conv (k, cin, cout) becomes (cout, cin, k), Dense (in, out)
  becomes (out, in), GroupNorm scale/bias become weight/bias, and the
  batch_stats moving_mean/moving_variance become the BatchNorm buffers.

The mapping is strict: every leaf is used exactly once, and every port
parameter and buffer receives one; a missing, left-over or mis-shaped leaf
raises before anything is copied.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from human_dynamics_tpu_torch.models.resnet import SlimBatchNorm

_SEP = "::"

Key = Tuple[str, ...]
Perm = Optional[Tuple[int, ...]]

_KERNEL_PERM = {
    nn.Conv2d: (3, 2, 0, 1),  # HWIO -> OIHW
    nn.Conv1d: (2, 1, 0),     # (k, cin, cout) -> (cout, cin, k)
    nn.Linear: (1, 0),        # (in, out) -> (out, in)
}


def load_jax_npz(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a JAX package npz checkpoint."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as flat:
        for key in flat.files:
            parts = key.split(_SEP) if _SEP in key else key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def _flax_path(module_name: str) -> Key:
    """Port module path -> flax module path.

    'resnet_v2_50.block1.unit_2.conv1' -> ('resnet_v2_50',
    'block1/unit_2/bottleneck_v2', 'conv1'); 'ief_delta.past5.fc1' ->
    ('ief_delta_past5', 'fc1'); everything else keeps its names.
    """
    path = re.sub(
        r"(^|\.)(block\d+)\.(unit_\d+)(?=\.|$)", r"\1\2/\3/bottleneck_v2",
        module_name,
    )
    path = re.sub(r"(^|\.)ief_delta\.", r"\1ief_delta_", path)
    return tuple(path.split(".")) if path else ()


def variable_map(module: nn.Module) -> Dict[str, Tuple[Key, Perm]]:
    """Port tensor name -> (flax key (collection, *path), permutation that
    turns the flax array into the port layout, or None)."""
    out: Dict[str, Tuple[Key, Perm]] = {}
    for name, mod in module.named_modules():
        prefix = name + "." if name else ""
        path = _flax_path(name)
        params = ("params",) + path
        if type(mod) in _KERNEL_PERM:
            out[prefix + "weight"] = (params + ("kernel",), _KERNEL_PERM[type(mod)])
            if mod.bias is not None:
                out[prefix + "bias"] = (params + ("bias",), None)
        elif isinstance(mod, nn.GroupNorm):
            out[prefix + "weight"] = (params + ("scale",), None)
            out[prefix + "bias"] = (params + ("bias",), None)
        elif isinstance(mod, SlimBatchNorm):
            stats = ("batch_stats",) + path
            out[prefix + "gamma"] = (params + ("gamma",), None)
            out[prefix + "beta"] = (params + ("beta",), None)
            out[prefix + "moving_mean"] = (stats + ("moving_mean",), None)
            out[prefix + "moving_variance"] = (stats + ("moving_variance",), None)
        for pname, _ in mod.named_parameters(recurse=False):
            out.setdefault(prefix + pname, (params + (pname,), None))
    return out


def mapped_shape(shape, perm: Perm) -> Tuple[int, ...]:
    """The shape a flax leaf takes in the port."""
    return tuple(shape) if perm is None else tuple(shape[p] for p in perm)


def _flatten(tree, prefix: Key = ()) -> Dict[Key, Any]:
    if isinstance(tree, Mapping):
        out: Dict[Key, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Copy a flax variables tree ({'params': ..., 'batch_stats': ...}, numpy
    leaves) into ``module``'s parameters and buffers, strictly."""
    leaves = _flatten(variables)
    mapping = variable_map(module)
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())

    uncovered = sorted(set(tensors) - set(mapping))
    if uncovered:
        raise ValueError(f"port tensors with no flax counterpart: {uncovered}")
    used = set()
    for name, (key, perm) in mapping.items():
        if key not in leaves:
            raise KeyError(f"flax leaf {'/'.join(key)} (for {name}) is missing")
        if key in used:
            raise ValueError(f"flax leaf {'/'.join(key)} mapped twice")
        used.add(key)
        want = tuple(tensors[name].shape)
        got = mapped_shape(np.shape(leaves[key]), perm)
        if got != want:
            raise ValueError(
                f"{'/'.join(key)} -> {name}: shape {got}, port has {want}"
            )
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if unused:
        raise ValueError(f"flax leaves with no port counterpart: {unused}")

    with torch.no_grad():
        for name, (key, perm) in mapping.items():
            arr = np.asarray(leaves[key], dtype=np.float32)
            if perm is not None:
                arr = arr.transpose(perm)
            tensors[name].copy_(torch.tensor(arr))
    return module
