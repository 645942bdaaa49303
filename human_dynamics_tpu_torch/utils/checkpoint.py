"""npz checkpoints in the JAX package's flat layout.

Counterpart of the npz part of ``human_dynamics_tpu/utils/checkpoint.py``:
a tree of dicts is saved as one npz whose keys are the tree paths joined
with '::' (module names such as 'block1/unit_1/bottleneck_v2' contain
'/'). A file written here loads with the JAX package's
``load_checkpoint(path.npz)``, and the reverse. Orbax directories, pickles
and TF checkpoints need JAX to read; they are refused.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_SEP = "::"


def _require_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path!r}: the port reads and writes .npz checkpoints only; an "
            "orbax directory, a pkl or a TF checkpoint needs JAX"
        )


def flatten_tree(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """Tree of dicts -> {'a::b::c': array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, prefix + (str(k),)))
    else:
        out[_SEP.join(prefix)] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    """Inverse of flatten_tree; keys without '::' split on '/'."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP) if _SEP in key else key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_checkpoint(path: str, tree) -> str:
    """Save a tree of dicts of arrays as a flat npz at ``path``."""
    _require_npz(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_tree(tree))
    return path


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """The ckpt-<step>* entry of ``model_dir`` with the largest step."""
    if not os.path.isdir(model_dir):
        return None
    ckpts = [f for f in os.listdir(model_dir) if f.startswith("ckpt-")]
    if not ckpts:
        return None

    def step_of(name):
        try:
            return int(name.split("-")[1].split(".")[0])
        except ValueError:
            return -1

    return os.path.join(model_dir, max(ckpts, key=step_of))


def checkpoint_top_keys(path: str) -> Optional[List[str]]:
    """Top-level keys of an npz checkpoint, without loading its arrays;
    None for any other format."""
    if not path.endswith(".npz"):
        return None
    with np.load(path, allow_pickle=False) as flat:
        return sorted({k.split(_SEP)[0].split("/")[0] for k in flat.keys()})


def load_checkpoint(path: str):
    """The tree of an npz checkpoint (numpy leaves)."""
    _require_npz(path)
    with np.load(path, allow_pickle=False) as flat:
        return unflatten_tree({k: flat[k] for k in flat.files})
