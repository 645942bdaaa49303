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

- ``export_jax_variables`` is the other direction: a port module's tensors
  (or any tensors named like them, such as Adam moments) as a flax
  variables tree in flax layouts; ``jax_to_port`` reads such a tree back
  for a chosen set of port tensors. The port trainer's checkpoints are
  written and read through them.

- ``load_jax_int8`` carries the JAX int8 encoder's quantised weights and
  calibrated scales across, as strictly.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from human_dynamics_tpu_torch.models.resnet import SlimBatchNorm
from human_dynamics_tpu_torch.utils.checkpoint import load_checkpoint

Key = Tuple[str, ...]
Perm = Optional[Tuple[int, ...]]

_KERNEL_PERM = {
    nn.Conv2d: (3, 2, 0, 1),  # HWIO -> OIHW
    nn.Conv1d: (2, 1, 0),     # (k, cin, cout) -> (cout, cin, k)
    nn.Linear: (1, 0),        # (in, out) -> (out, in)
}


def load_jax_npz(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a JAX package npz checkpoint."""
    return load_checkpoint(path)


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
    mapping = variable_map(module)
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    uncovered = sorted(set(tensors) - set(mapping))
    if uncovered:
        raise ValueError(f"port tensors with no flax counterpart: {uncovered}")
    values = jax_to_port(module, variables, list(mapping))
    with torch.no_grad():
        for name, v in values.items():
            tensors[name].copy_(v)
    return module


def export_jax_variables(module: nn.Module,
                         tensors: Optional[Mapping[str, torch.Tensor]] = None):
    """The inverse of ``load_jax_variables``: a flax variables tree of numpy
    arrays in flax layouts. ``tensors`` maps port tensor names to the
    tensors to export (default: every parameter and buffer of ``module``);
    each name must be one of the module's."""
    mapping = variable_map(module)
    if tensors is None:
        tensors = dict(module.named_parameters())
        tensors.update(module.named_buffers())
    tree: Dict[str, Any] = {}
    for name, t in tensors.items():
        key, perm = mapping[name]
        arr = t.detach().to("cpu", torch.float32).numpy()
        if perm is not None:
            arr = arr.transpose(np.argsort(perm))
        node = tree
        for p in key[:-1]:
            node = node.setdefault(p, {})
        node[key[-1]] = np.ascontiguousarray(arr)
    return tree


def jax_to_port(module: nn.Module, variables, names,
                strict: bool = True) -> Dict[str, torch.Tensor]:
    """The leaves of a flax variables tree for the port tensors ``names``,
    in port layout (f32 CPU tensors). Every name needs its own leaf with
    the tensor's shape; with ``strict`` the tree holds no other leaf.
    Raises before anything is returned."""
    leaves = _flatten(variables)
    mapping = variable_map(module)
    shapes = {n: tuple(t.shape) for n, t in module.named_parameters()}
    shapes.update((n, tuple(t.shape)) for n, t in module.named_buffers())
    used = set()
    for name in names:
        key, perm = mapping[name]
        if key not in leaves:
            raise KeyError(f"flax leaf {'/'.join(key)} (for {name}) is missing")
        if key in used:
            raise ValueError(f"flax leaf {'/'.join(key)} mapped twice")
        used.add(key)
        got = mapped_shape(np.shape(leaves[key]), perm)
        if got != shapes[name]:
            raise ValueError(
                f"{'/'.join(key)} -> {name}: shape {got}, port has "
                f"{shapes[name]}"
            )
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if strict and unused:
        raise ValueError(f"flax leaves with no port counterpart: {unused}")
    out = {}
    for name in names:
        key, perm = mapping[name]
        arr = np.array(leaves[key], dtype=np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(
            arr if perm is None else arr.transpose(perm)))
    return out


def _int8_tensor(key: str, arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy()).to(device)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: exact through float32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if arr.dtype == np.float32:
        return torch.from_numpy(arr.copy()).to(device)
    raise ValueError(f"{key}: dtype {arr.dtype} is not int8, bf16 or f32")


def load_jax_int8(qp, scales, device=None):
    """The JAX package's ``prepare_int8_params`` and
    ``calibrate_int8_scales`` dicts (numpy leaves; ``scales`` may be None)
    as the port's, on ``device``.

    Strict: every key of ``qp`` must be a key the port's
    ``prepare_int8_params`` makes (the int8_root stems' weights and scales
    included), and every key the port makes must be present. Every scale
    must be a scalar.
    """
    from human_dynamics_tpu_torch.models.resnet import ResNetV2_50
    from human_dynamics_tpu_torch.models.resnet_int8 import (
        prepare_int8_params,
    )

    # The key set (and the shapes) the port makes, from a meta-device trunk.
    want = prepare_int8_params(ResNetV2_50(device="meta"))
    extra = sorted(set(qp) - set(want))
    missing = sorted(set(want) - set(qp))
    if extra or missing:
        raise ValueError(
            f"int8 params: keys with no port counterpart {extra}, "
            f"missing {missing}"
        )
    out_qp = {}
    for key, ref in want.items():
        if tuple(np.shape(qp[key])) != tuple(ref.shape):
            raise ValueError(
                f"{key}: shape {np.shape(qp[key])}, port has {tuple(ref.shape)}"
            )
        t = _int8_tensor(key, qp[key], device)
        if t.dtype != ref.dtype:
            raise ValueError(f"{key}: dtype {t.dtype}, port has {ref.dtype}")
        out_qp[key] = t
    if scales is None:
        return out_qp, None
    out_scales = {}
    for key, v in scales.items():
        if np.ndim(v) != 0:
            raise ValueError(f"scale {key} has shape {np.shape(v)}")
        out_scales[key] = torch.tensor(np.float32(v), device=device)
    return out_qp, out_scales
