"""SMPL body model in PyTorch.

Counterpart of ``human_dynamics_tpu/core/smpl.py``:

- ``SmplModel`` holds the model constants as tensors on one device, in the
  reference's transposed-for-matmul layout: shapedirs (num_betas, V*3),
  posedirs (207, V*3), j_regressor (V, 24), joint_regressor (V, K).
- The 24-joint kinematic chain is evaluated level-parallel: joints are
  grouped by tree depth (SMPL has 8 levels) and each level is one batched
  3x3 product. The levels are collected in Python lists and stacked, so
  autograd follows every step (no in-place writes).
- ``convert_smpl_pkl`` turns the original SMPL pickle into an npz without
  chumpy (its objects are unpickled through a stub); ``load_smpl_model``
  reads the npz or the pickle.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from human_dynamics_tpu_torch.core.rotations import rodrigues

# parents[i] is the parent joint of joint i (root = -1).
SMPL_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
    19, 20, 21,
)
NUM_JOINTS = 24
NUM_POSE_BASIS = 207  # 23 joints x 9 rotation entries

_ARRAY_FIELDS = (
    "v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
    "joint_regressor",
)


@dataclasses.dataclass(frozen=True)
class SmplModel:
    """SMPL constants as tensors on one device."""

    v_template: torch.Tensor       # (V, 3)
    shapedirs: torch.Tensor        # (num_betas, V*3)
    posedirs: torch.Tensor         # (207, V*3)
    j_regressor: torch.Tensor      # (V, 24)
    lbs_weights: torch.Tensor      # (V, 24)
    joint_regressor: torch.Tensor  # (V, K)
    parents: Tuple[int, ...] = SMPL_PARENTS
    faces: Optional[np.ndarray] = None  # (F, 3) int, rendering only

    @classmethod
    def from_numpy(cls, arrays, parents=SMPL_PARENTS, faces=None,
                   device=None, dtype=torch.float32) -> "SmplModel":
        """Build from a mapping of numpy arrays named like the fields."""
        return cls(
            **{k: torch.as_tensor(np.asarray(arrays[k]), dtype=dtype,
                                  device=device)
               for k in _ARRAY_FIELDS},
            parents=tuple(parents),
            faces=faces,
        )

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[0]

    @property
    def num_kps(self) -> int:
        return self.joint_regressor.shape[1]

    def to(self, device) -> "SmplModel":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _ARRAY_FIELDS}
        )

    def with_joint_type(self, joint_type: str) -> "SmplModel":
        """A model whose keypoint regressor is cocoplus or lsp (first 14)."""
        if joint_type == "cocoplus":
            return self
        if joint_type == "lsp":
            return dataclasses.replace(
                self, joint_regressor=self.joint_regressor[:, :14]
            )
        raise ValueError(f"Unknown joint type: {joint_type!r}")


@dataclasses.dataclass(frozen=True)
class SmplForward:
    """Result of one SMPL forward pass.

    verts: (N, V, 3) posed vertices, or None when they were not asked for.
    joints: (N, K, 3) regressed keypoints.
    rots: (N, 24, 3, 3) per-joint rotations (Rodrigues of theta).
    j_posed: (N, 24, 3) posed SMPL joints.
    """

    verts: Optional[torch.Tensor]
    joints: torch.Tensor
    rots: torch.Tensor
    j_posed: torch.Tensor


def _fk_levels(parents: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """Non-root joints grouped by kinematic-tree depth."""
    depth = [0] * len(parents)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    return [
        tuple(i for i in range(len(parents)) if depth[i] == d)
        for d in range(1, max(depth) + 1)
    ]


def global_rigid_transformation(
    rots: torch.Tensor,
    joints: torch.Tensor,
    parents: Tuple[int, ...] = SMPL_PARENTS,
    rotate_base: bool = False,
):
    """Forward kinematics over the SMPL tree, level-parallel.

    Args:
        rots: (N, J, 3, 3) local rotations.
        joints: (N, J, 3) rest-pose joints.
        rotate_base: rotate the root by 180 degrees about x.

    Returns:
        j_posed (N, J, 3), world_rot (N, J, 3, 3), rel_t (N, J, 3) with
        rel_t = world_t - world_rot @ j_rest (the skinning translation).
    """
    root_rot = rots[:, 0]
    if rotate_base:
        rot_x = torch.tensor(
            [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
            dtype=rots.dtype, device=rots.device,
        )
        root_rot = root_rot @ rot_x

    # Bone vectors J[i] - J[parent[i]]; the root keeps J[0].
    parent_idx = [max(p, 0) for p in parents]
    j_rel = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), joints[:, parent_idx[1:]]], dim=1
    )

    world_rot: List[Optional[torch.Tensor]] = [None] * len(parents)
    world_t: List[Optional[torch.Tensor]] = [None] * len(parents)
    world_rot[0] = root_rot
    world_t[0] = joints[:, 0]
    for level in _fk_levels(parents):
        idx = list(level)
        pidx = [parents[i] for i in level]
        parent_r = torch.stack([world_rot[p] for p in pidx], dim=1)
        parent_t = torch.stack([world_t[p] for p in pidx], dim=1)
        new_r = parent_r @ rots[:, idx]
        new_t = (parent_r @ j_rel[:, idx, :, None])[..., 0] + parent_t
        for li, i in enumerate(idx):
            world_rot[i] = new_r[:, li]
            world_t[i] = new_t[:, li]

    world_rot_t = torch.stack(world_rot, dim=1)
    world_t_t = torch.stack(world_t, dim=1)
    rel_t = world_t_t - (world_rot_t @ joints[..., None])[..., 0]
    return world_t_t, world_rot_t, rel_t


def pose_feature(rots: torch.Tensor) -> torch.Tensor:
    """(N, 24, 3, 3) rotations -> (N, 207) pose-blendshape feature."""
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    return (rots[:, 1:] - eye).reshape(rots.shape[0], NUM_POSE_BASIS)


def smpl_forward(
    model: SmplModel,
    beta: torch.Tensor,
    theta: torch.Tensor,
    skip_verts: bool = False,
    rotate_base: bool = False,
) -> SmplForward:
    """Posed mesh + regressed keypoints for a batch of (beta, theta).

    Args:
        beta: (N, 10) shape coefficients.
        theta: (N, 72) or (N, 24, 3) axis-angle pose.
        skip_verts: stop after FK; joints are then the 24 SMPL joints.
    """
    n = beta.shape[0]
    v = model.num_verts

    v_shaped = (beta @ model.shapedirs).reshape(n, v, 3) + model.v_template
    joints_rest = torch.einsum("nvc,vj->njc", v_shaped, model.j_regressor)

    rots = rodrigues(theta.reshape(n, NUM_JOINTS, 3))
    v_posed = (
        (pose_feature(rots) @ model.posedirs).reshape(n, v, 3) + v_shaped
    )

    j_posed, world_rot, rel_t = global_rigid_transformation(
        rots, joints_rest, model.parents, rotate_base=rotate_base
    )
    if skip_verts:
        return SmplForward(None, j_posed, rots, j_posed)

    # Linear blend skinning with (R | t) packed as 12 columns.
    rt = torch.cat([world_rot.reshape(n, NUM_JOINTS, 9), rel_t], dim=-1)
    blended = torch.einsum("vj,njk->nvk", model.lbs_weights, rt)
    blend_rot = blended[..., :9].reshape(n, v, 3, 3)
    verts = (blend_rot @ v_posed[..., None])[..., 0] + blended[..., 9:]

    joints = torch.einsum("nvc,vk->nkc", verts, model.joint_regressor)
    return SmplForward(verts, joints, rots, j_posed)


def _undo_chumpy(x):
    """chumpy array -> numpy."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "r"):
        return np.asarray(x.r)
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    return np.asarray(x)


class _ChumpyStub:
    """Unpickles chumpy objects without chumpy installed.

    chumpy.Ch pickles its ``__dict__``; the wrapped ndarray lives under
    ``x`` (sometimes ``_data``). Only the raw array is needed.
    """

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @property
    def r(self):
        for key in ("x", "_data", "a"):
            val = self.__dict__.get(key)
            if isinstance(val, np.ndarray):
                return val
            if val is not None and hasattr(val, "r"):
                return val.r
        raise ValueError("Cannot extract array from chumpy stub")

    @property
    def shape(self):  # chumpy.Ch exposes the wrapped array's shape
        return self.r.shape


class _SmplUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def convert_smpl_pkl(pkl_path: str, npz_path: str) -> None:
    """One-time conversion of the original SMPL pickle to a plain npz, the
    same file as the JAX package's ``convert_smpl_pkl`` writes. chumpy
    objects are unpickled through a stub, so chumpy is not needed."""
    with open(pkl_path, "rb") as f:
        dd = _SmplUnpickler(f, encoding="latin1").load()

    num_betas = dd["shapedirs"].shape[-1]
    out = dict(
        v_template=_undo_chumpy(dd["v_template"]).astype(np.float32),
        shapedirs=_undo_chumpy(dd["shapedirs"])
        .reshape(-1, num_betas).T.astype(np.float32),
        posedirs=_undo_chumpy(dd["posedirs"])
        .reshape(-1, NUM_POSE_BASIS).T.astype(np.float32),
        j_regressor=np.asarray(
            _undo_chumpy(dd["J_regressor"]).T, dtype=np.float32
        ),
        lbs_weights=_undo_chumpy(dd["weights"]).astype(np.float32),
        cocoplus_regressor=np.asarray(
            _undo_chumpy(dd["cocoplus_regressor"]).T, dtype=np.float32
        ),
        parents=np.asarray(dd["kintree_table"][0], dtype=np.int64),
        faces=np.asarray(dd["f"], dtype=np.int32) if "f" in dd else None,
    )
    np.savez(npz_path, **{k: v for k, v in out.items() if v is not None})


def load_smpl_model(
    path: str, joint_type: str = "cocoplus", device=None,
    dtype=torch.float32,
) -> SmplModel:
    """Load an SmplModel from an npz written by ``convert_smpl_pkl`` (this
    package's or the JAX package's), or from the original SMPL pickle,
    converted on the way."""
    if path.endswith(".pkl"):
        with tempfile.TemporaryDirectory() as tmp:
            npz = os.path.join(tmp, "smpl.npz")
            convert_smpl_pkl(path, npz)
            return load_smpl_model(npz, joint_type, device, dtype)
    if not path.endswith(".npz"):
        raise ValueError(
            f"load_smpl_model reads an npz (convert_smpl_pkl) or the SMPL "
            f"pkl, got {path!r}")
    with np.load(path, allow_pickle=False) as dd:
        parents = dd["parents"].astype(np.int64)
        parents = tuple(int(p) if p < len(parents) else -1 for p in parents)
        arrays = {k: dd[k] for k in _ARRAY_FIELDS if k != "joint_regressor"}
        arrays["joint_regressor"] = dd["cocoplus_regressor"]
        faces = dd["faces"] if "faces" in dd else None
    model = SmplModel.from_numpy(
        arrays, parents=parents, faces=faces, device=device, dtype=dtype
    )
    return model.with_joint_type(joint_type)


def synthetic_smpl_model(
    num_verts: int = 256,
    num_kps: int = 19,
    seed: int = 0,
    device=None,
    dtype=torch.float32,
) -> SmplModel:
    """Deterministic random SMPL-shaped model for tests and benchmarks: the
    real kinematic tree and dimensions, with random constants drawn from
    the same ``RandomState`` sequence as the JAX package's, so that the
    arrays are bit-identical."""
    rng = np.random.RandomState(seed)
    v = num_verts
    v_template = rng.uniform(-1, 1, (v, 3)).astype(np.float32)
    shapedirs = (rng.randn(10, v * 3) * 0.03).astype(np.float32)
    posedirs = (rng.randn(NUM_POSE_BASIS, v * 3) * 0.01).astype(np.float32)

    j_reg = rng.rand(v, NUM_JOINTS).astype(np.float32) ** 8
    j_reg /= j_reg.sum(axis=0, keepdims=True)
    w = rng.rand(v, NUM_JOINTS).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    joint_reg = rng.rand(v, num_kps).astype(np.float32)
    joint_reg /= joint_reg.sum(axis=0, keepdims=True)

    faces = rng.randint(0, v, (2 * v, 3)).astype(np.int32)
    arrays = dict(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_reg, lbs_weights=w, joint_regressor=joint_reg,
    )
    return SmplModel.from_numpy(
        arrays, faces=faces, device=device, dtype=dtype
    )
