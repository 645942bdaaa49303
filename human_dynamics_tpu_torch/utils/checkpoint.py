"""npz checkpoints in the JAX package's flat layout, and the reference's
TF-slim checkpoints.

Counterpart of ``human_dynamics_tpu/utils/checkpoint.py`` without orbax:

- a tree of dicts is saved as one npz whose keys are the tree paths joined
  with '::' (module names such as 'block1/unit_1/bottleneck_v2' contain
  '/'). A file written here loads with the JAX package's
  ``load_checkpoint(path.npz)``, and the reverse. Orbax directories and
  pickles need JAX to read; they are refused.
- ``convert_tf_checkpoint`` maps the reference's TF-1 slim variable names
  (resnet_v2_50/*, single_view_ief*/3D_module/*, AZ_FC_block*, fc2_res/*,
  D_pose/*, mean_param) onto the JAX package's flax variables tree, which
  ``utils.weights.load_jax_variables`` copies into the port's modules. It
  reads the checkpoint with ``utils.tf_bundle``, so TensorFlow is not
  needed; ``export_to_slim_names`` is its inverse.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from human_dynamics_tpu_torch.utils import tf_bundle

_SEP = "::"


def _require_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path!r}: the port reads and writes .npz checkpoints here; an "
            "orbax directory or a pkl needs JAX, and a TF checkpoint is read "
            "by convert_tf_checkpoint"
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


# ---------------------------------------------------------------------------
# TF-slim -> flax conversion
# ---------------------------------------------------------------------------

_RESNET_UNITS = {1: 3, 2: 4, 3: 6, 4: 3}


def _slim_resnet_name_map() -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """slim var name -> (collection, flax path under resnet_v2_50)."""
    m: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
    r = "resnet_v2_50"

    def bn(slim_prefix, flax_prefix):
        m[f"{slim_prefix}/gamma"] = ("params", flax_prefix + ("gamma",))
        m[f"{slim_prefix}/beta"] = ("params", flax_prefix + ("beta",))
        m[f"{slim_prefix}/moving_mean"] = (
            "batch_stats", flax_prefix + ("moving_mean",)
        )
        m[f"{slim_prefix}/moving_variance"] = (
            "batch_stats", flax_prefix + ("moving_variance",)
        )

    m[f"{r}/conv1/weights"] = ("params", ("conv1", "kernel"))
    m[f"{r}/conv1/biases"] = ("params", ("conv1", "bias"))
    for b, units in _RESNET_UNITS.items():
        for u in range(1, units + 1):
            sp = f"{r}/block{b}/unit_{u}/bottleneck_v2"
            fp = (f"block{b}/unit_{u}/bottleneck_v2",)
            bn(f"{sp}/preact", fp + ("preact",))
            for conv in ("conv1", "conv2"):
                m[f"{sp}/{conv}/weights"] = (
                    "params", fp + (conv, "kernel")
                )
                bn(f"{sp}/{conv}/BatchNorm", fp + (f"{conv}_bn",))
            m[f"{sp}/conv3/weights"] = ("params", fp + ("conv3", "kernel"))
            m[f"{sp}/conv3/biases"] = ("params", fp + ("conv3", "bias"))
            m[f"{sp}/shortcut/weights"] = (
                "params", fp + ("shortcut", "kernel")
            )
            m[f"{sp}/shortcut/biases"] = (
                "params", fp + ("shortcut", "bias")
            )
    bn(f"{r}/postnorm", ("postnorm",))
    return m


def _ief_name_map(scope: str, flax_name: str):
    """single_view_ief*/3D_module/fc{1,2,3} -> IefRegressor params."""
    m = {}
    for fc in ("fc1", "fc2", "fc3"):
        m[f"{scope}/3D_module/{fc}/weights"] = (
            "params", (flax_name, fc, "kernel")
        )
        m[f"{scope}/3D_module/{fc}/biases"] = (
            "params", (flax_name, fc, "bias")
        )
    return m


def slim_to_flax_name_map(
    num_conv_layers: int = 3,
    delta_t_values=(-5, 5),
    do_hallucinate: bool = True,
    include_resnet: bool = True,
) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """Full reference-variable -> flax-path map for HmmrModel."""
    m: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
    if include_resnet:
        for k, (coll, path) in _slim_resnet_name_map().items():
            m[k] = (coll, ("resnet_v2_50",) + path)

    m["mean_param"] = ("params", ("mean_param",))
    m.update(_ief_name_map("single_view_ief", "single_view_ief"))
    for dt in delta_t_values:
        if dt == 0:
            continue
        key = f"past{abs(dt)}" if dt < 0 else f"future{dt}"
        m.update(
            _ief_name_map(f"single_view_ief_{key}", f"ief_delta_{key}")
        )

    # Temporal encoder (az_fc_block2 scopes, models.py:155-220).
    for i in range(num_conv_layers):
        blk = ("temporal_encoder", f"block_{i}")
        m[f"AZ_FC_block_preact_gn1block_{i}/gamma"] = (
            "params", blk + ("gn1", "scale")
        )
        m[f"AZ_FC_block_preact_gn1block_{i}/beta"] = (
            "params", blk + ("gn1", "bias")
        )
        m[f"AZ_FC_block_preact_gn2block_{i}/gamma"] = (
            "params", blk + ("gn2", "scale")
        )
        m[f"AZ_FC_block_preact_gn2block_{i}/beta"] = (
            "params", blk + ("gn2", "bias")
        )
        m[f"AZ_FC_block2_conv1block_{i}/weights"] = (
            "params", blk + ("conv1", "kernel")
        )
        m[f"AZ_FC_block2_conv1block_{i}/biases"] = (
            "params", blk + ("conv1", "bias")
        )
        m[f"AZ_FC_block2_conv2block_{i}/weights"] = (
            "params", blk + ("conv2", "kernel")
        )
        m[f"AZ_FC_block2_conv2block_{i}/biases"] = (
            "params", blk + ("conv2", "bias")
        )

    if do_hallucinate:
        for fc in ("fc1", "fc2", "fc3"):
            m[f"fc2_res/{fc}/weights"] = (
                "params", ("hallucinator", fc, "kernel")
            )
            m[f"fc2_res/{fc}/biases"] = (
                "params", ("hallucinator", fc, "bias")
            )
    return m


def disc_slim_to_flax_name_map() -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """PoseDiscriminator D_pose/* -> flax paths (discriminators.py)."""
    m: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
    for conv in ("D_conv1", "D_conv2"):
        m[f"D_pose/{conv}/weights"] = ("params", (conv, "kernel"))
        m[f"D_pose/{conv}/biases"] = ("params", (conv, "bias"))
    for fc in ("D_alljoints_fc1", "D_alljoints_fc2", "D_alljoints_out"):
        m[f"D_pose/{fc}/weights"] = ("params", (fc, "kernel"))
        m[f"D_pose/{fc}/biases"] = ("params", (fc, "bias"))
    # 23 per-joint heads are stacked into per_joint_w/b by the converter.
    return m


def _transform_value(slim_name: str, value: np.ndarray) -> np.ndarray:
    """Layout fixes slim -> flax."""
    if "AZ_FC_block2_conv" in slim_name and slim_name.endswith("weights"):
        # TF conv2d kernel (3, 1, C, C) -> 1-D flax Conv (3, C, C).
        return value[:, 0]
    if slim_name == "mean_param":
        return value.reshape(1, -1)
    if "D_conv" in slim_name and slim_name.endswith("weights"):
        # (1, 1, C_in, C_out) -> Dense (C_in, C_out).
        return value.reshape(value.shape[-2], value.shape[-1])
    return value


def convert_tf_checkpoint(
    ckpt_path: str,
    num_conv_layers: int = 3,
    delta_t_values=(-5, 5),
    do_hallucinate: bool = True,
    include_resnet: bool = True,
    strict: bool = False,
):
    """TF checkpoint (hmr/hmmr) -> flax variables dict.

    Returns {'params': ..., 'batch_stats': ...} loadable into HmmrModel.
    Also converts the discriminator into a second tree if D_pose vars are
    present: returns (hmmr_vars, disc_vars_or_None).
    """
    reader = tf_bundle.load_checkpoint(ckpt_path)
    shapes = reader.get_variable_to_shape_map()
    available = set(shapes)

    # Strip the single_view_ief scope if this is the plain-HMR checkpoint
    # (trainer_sequence_fc.py:374-389 mangles the reverse way).
    def get(name):
        if name in available:
            return reader.get_tensor(name)
        if name.startswith("single_view_ief/"):
            alt = name[len("single_view_ief/"):]
            if alt in available:
                return reader.get_tensor(alt)
        return None

    name_map = slim_to_flax_name_map(
        num_conv_layers, delta_t_values, do_hallucinate, include_resnet
    )
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    missing = []
    for slim_name, (coll, path) in name_map.items():
        value = get(slim_name)
        if value is None:
            missing.append(slim_name)
            continue
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _transform_value(slim_name, np.asarray(value))
    if strict and missing:
        raise KeyError(f"Missing {len(missing)} vars, e.g. {missing[:5]}")

    disc_out = None
    if any(n.startswith("D_pose/") for n in available):
        disc_out = {"params": {}}
        for slim_name, (coll, path) in disc_slim_to_flax_name_map().items():
            value = get(slim_name)
            if value is None:
                continue
            node = disc_out[coll]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = _transform_value(slim_name, np.asarray(value))
        # Stack the 23 per-joint linear heads.
        ws, bs = [], []
        for j in range(23):
            w = get(f"D_pose/pose_out_j{j}/weights")
            b = get(f"D_pose/pose_out_j{j}/biases")
            if w is None:
                break
            ws.append(np.asarray(w).reshape(-1))
            bs.append(np.asarray(b).reshape(()))
        if len(ws) == 23:
            disc_out["params"]["per_joint_w"] = np.stack(ws)
            disc_out["params"]["per_joint_b"] = np.stack(bs)

    if not out["batch_stats"]:
        out.pop("batch_stats")
    return (out, disc_out) if disc_out is not None else out


def export_to_slim_names(
    variables,
    num_conv_layers: int = 3,
    delta_t_values=(-5, 5),
    do_hallucinate: bool = True,
    include_resnet: bool = True,
) -> Dict[str, np.ndarray]:
    """Inverse mapping (flax -> slim var dict); used for converter
    round-trip testing and for exporting back to TF tooling."""
    name_map = slim_to_flax_name_map(
        num_conv_layers, delta_t_values, do_hallucinate, include_resnet
    )
    flat: Dict[str, np.ndarray] = {}
    for slim_name, (coll, path) in name_map.items():
        node = variables.get(coll)
        if node is None:
            continue
        ok = True
        for p in path:
            if not isinstance(node, dict) or p not in node:
                ok = False
                break
            node = node[p]
        if not ok:
            continue
        value = np.asarray(node)
        # Undo the layout fixes.
        if ("AZ_FC_block2_conv" in slim_name
                and slim_name.endswith("weights")):
            value = value[:, None]
        if slim_name == "mean_param":
            value = value.reshape(1, -1)
        flat[slim_name] = value
    return flat
