"""Process meshes and sharding helpers on torch.distributed.

Counterpart of ``human_dynamics_tpu/parallel/mesh.py``. One process per
device: a ``Mesh`` lays the process group's ranks out on named axes, row
major, so rank = d * time_size + t on a (data, time) mesh, ``time``
innermost as in the JAX mesh. Every rank calls the same sharded functions
with the same arguments, as ``shard_map`` does, and results come back
whole on every rank.

Every collective here is an ``all_reduce`` (SUM) or a ``broadcast``: gloo
runs those two on CUDA tensors too, so several ranks can share one GPU
over gloo, which NCCL refuses. A gather is an ``all_reduce`` of a zeroed
buffer into which each rank writes its own block (x + 0 is exact).

- ``make_mesh`` / ``make_mesh_2d`` / ``make_mesh_tp``: the mesh over the
  whole process group.
- ``shard_batch`` / ``shard_batch_2d``: this rank's contiguous block of a
  batch, with the JAX functions' divisibility errors.
- ``replicate``: rank 0's tensors on every rank; ``broadcast_tensors`` does it
  in place.
- ``psum``: a sum over the ranks that autograd differentiates (its backward
  sums the incoming gradients over the same ranks); ``sum_gradients``: every
  gradient of some modules summed over the ranks in one ``all_reduce``.

A collective runs over one axis, a set of axes or the whole mesh: ``Mesh``
makes a process group for every row of every set of axes. A training
batch's rows are split over the mesh's ``batch_axes``: every axis but
``model`` (``data``, and ``time`` on a (data, time) mesh), so the losses'
counts, the BatchNorm moments and the gradients are summed over those.
The tensor-parallel hook, ``shard_params_tp``, is ``parallel.tp``'s.
"""

from __future__ import annotations

import itertools
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# The axis data-parallel training splits the batch over.
DATA_AXIS = "data"
# The axis 2-D training splits a clip's frames over.
TIME_AXIS = "time"
# The axis tensor-parallel training splits wide weights over; its ranks
# hold the same rows of the batch.
MODEL_AXIS = "model"

Axes = Union[None, str, Sequence[str]]


def _dist():
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a Mesh needs an initialised process group: call "
            "parallel.initialize (or torch.distributed.init_process_group) "
            "in every process first"
        )
    return dist


def _mesh_device(device, rank: int) -> torch.device:
    """``device``, or this rank's CUDA device when it is None (raises
    without one: the CPU runs only when asked for)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the mesh "
            "on the CPU"
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """This process's place in a grid of ranks with named axes.

    Attributes:
        axis_names: the axes, outermost first.
        shape: {axis: size}.
        coords: {axis: this rank's index along it}.
        device: where this rank computes (its collectives' tensors live
            there).
        size: the number of ranks (the process group's world size).
    """

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 device=None):
        dist = _dist()
        sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(sizes):
            raise ValueError(f"axes {axis_names} do not fit sizes {sizes}")
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(sizes)) != world:
            raise ValueError(
                f"a {'x'.join(map(str, sizes))} mesh needs {int(np.prod(sizes))} "
                f"processes, the process group has {world}"
            )
        self.device = _mesh_device(device, rank)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        elif dist.get_backend() == "nccl":
            raise ValueError("the NCCL backend cannot run a mesh on the CPU")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.size = world
        self.rank = rank
        grid = np.arange(world).reshape(sizes)
        self.coords = {
            a: int(i) for a, i in
            zip(axis_names, np.unravel_index(rank, sizes))
        }
        # One group per row of each set of axes, made in the same order on
        # every rank (new_group is collective); a row that spans every rank
        # is the world group.
        self._groups = {}
        for n in range(1, len(sizes) + 1):
            for dims in itertools.combinations(range(len(sizes)), n):
                kept = [d for d in range(len(sizes)) if d not in dims]
                rows = np.transpose(grid, kept + list(dims)).reshape(
                    -1, int(np.prod([sizes[d] for d in dims])))
                for row in rows:
                    ranks = row.tolist()
                    group = (dist.group.WORLD if len(ranks) == world
                             else dist.new_group(ranks))
                    if rank in ranks:
                        self._groups[tuple(axis_names[d] for d in dims)] = group

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The axes a training batch's rows are split over: all but
        ``model``, whose ranks hold the same rows."""
        return tuple(a for a in self.axis_names if a != MODEL_AXIS)

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple in the mesh's order (None: every axis)."""
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise KeyError(f"axes {sorted(unknown)} are not in the mesh's "
                           f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes: Axes = None) -> int:
        """The number of ranks in a row along ``axes``."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes``: its place in its row, row
        major over the axes in the mesh's order."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes = None):
        """The process group of this rank's row along ``axes`` (an axis, a
        set of axes; None: every rank)."""
        axes = self._axes(axes)
        if axes == self.axis_names:
            return _dist().group.WORLD
        return self._groups[axes]


def make_mesh(
    num_devices: Optional[int] = None,
    axis_name: str = "data",
    device=None,
) -> Mesh:
    """1-D mesh over every process of the group; ``num_devices``, when
    given, must be the group's size (one process per device)."""
    world = _dist().get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"make_mesh({num_devices}): the process group has {world} "
            "processes, one per device"
        )
    return Mesh((world,), (axis_name,), device=device)


def make_mesh_2d(
    data_size: int,
    time_size: int,
    axis_names: Sequence[str] = ("data", "time"),
    device=None,
) -> Mesh:
    """(data_size x time_size) mesh, ``time`` innermost: rank
    d * time_size + t, so a halo exchange stays within neighbouring
    ranks."""
    return Mesh((data_size, time_size), axis_names, device=device)


def make_mesh_tp(
    data_size: int,
    model_size: int,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    device=None,
) -> Mesh:
    """(data_size x model_size) mesh for tensor-parallel training,
    ``model`` innermost: rank d * model_size + m, so the activation
    gathers of a data row stay within neighbouring ranks."""
    return Mesh((data_size, model_size), axis_names, device=device)


# ---------------------------------------------------------------------------
# Collectives (all_reduce and broadcast only; see the module docstring)
# ---------------------------------------------------------------------------


# gloo runs a collective on CUDA tensors through a host copy that it writes
# back with a torch op, in place: an inference tensor (made under
# torch.inference_mode) takes that write only inside inference mode.


def all_sum(t: torch.Tensor, mesh: Mesh, axis: Axes = None
            ) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of this rank's ``axis`` row (an
    axis or a set of axes; None: every rank)."""
    with torch.inference_mode(t.is_inference()):
        _dist().all_reduce(t, group=mesh.group(axis))
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, axis: Axes = None
              ) -> torch.Tensor:
    """``t`` in place from the first rank of this rank's ``axis`` row
    (None: from rank 0)."""
    dist = _dist()
    group = mesh.group(axis)
    with torch.inference_mode(t.is_inference()):
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh gets here (an ``all_reduce`` of one
    element on the mesh's device, which gloo and NCCL both run)."""
    all_sum(torch.zeros(1, device=mesh.device), mesh)


class _PSum(torch.autograd.Function):
    """Sum over the ranks of a row; the backward sums the incoming
    gradients over the same ranks. The forward reduces a copy: gloo writes
    its result back in place, which must not reach a tensor autograd
    saved."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_sum(x.detach().clone(memory_format=torch.contiguous_format),
                       mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return all_sum(grad.clone(memory_format=torch.contiguous_format),
                       ctx.mesh, ctx.axis), None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: Axes = None
         ) -> torch.Tensor:
    """``x`` summed over the ranks of this rank's ``axis`` row, as a new
    tensor that autograd differentiates: with each rank's loss a share of
    one global loss, the gradient that reaches ``x`` is the global loss's.
    Every rank must call it at the same point, forward and backward."""
    return _PSum.apply(x, mesh, axis)


def _flat_collective(tensors, op) -> None:
    """``op`` on one flat buffer per dtype holding every tensor, then the
    results copied back into the tensors."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(piece.view_as(t))


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` (parameters, buffers, optimizer
    moments: the same list in the same order on every rank) on every rank,
    in place, in one broadcast per dtype."""
    _flat_collective(list(tensors), lambda flat: broadcast(flat, mesh))


@torch.no_grad()
def sum_gradients(modules: Sequence[torch.nn.Module], mesh: Mesh,
                  axis: Axes = DATA_AXIS) -> None:
    """Every gradient of ``modules`` (the parameters whose ``grad`` is set)
    summed over the ranks of this rank's ``axis`` row, in place: one
    ``all_reduce`` of a flat buffer per dtype, not one per parameter."""
    grads = [p.grad for m in modules for p in m.parameters()
             if p.grad is not None]
    _flat_collective(grads, lambda flat: all_sum(flat, mesh, axis))


def assemble(
    parts: Mapping,
    lead: Tuple[int, ...],
    index: Tuple[slice, ...],
    mesh: Mesh,
    axis: Axes = None,
) -> Dict[str, torch.Tensor]:
    """Gather each rank's block of several arrays in one ``all_reduce``.

    ``parts`` maps names to this rank's block, of shape (*local_lead,
    *rest); ``index`` places the block's leading dims in the whole arrays'
    ``lead`` dims. Every part is flattened behind its leading dims into one
    zeroed (*lead, W) buffer of the parts' common dtype, summed over this
    rank's ``axis`` row, and cut back into (*lead, *rest) arrays.
    """
    names = list(parts)
    first = parts[names[0]]
    nlead = len(lead)
    local_lead = tuple(first.shape[:nlead])
    dtypes = {parts[k].dtype for k in names}
    if len(dtypes) != 1:
        raise ValueError(f"assemble: parts of several dtypes {dtypes}")
    flat = [parts[k].reshape(local_lead + (-1,)) for k in names]
    widths = [f.shape[-1] for f in flat]
    buf = torch.zeros(tuple(lead) + (sum(widths),), dtype=first.dtype,
                      device=first.device)
    buf[index] = torch.cat(flat, dim=-1)
    all_sum(buf, mesh, axis)
    out = {}
    for k, piece in zip(names, torch.split(buf, widths, dim=-1)):
        out[k] = piece.reshape(tuple(lead) + tuple(parts[k].shape[nlead:]))
    return out


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _block(x, mesh: Mesh, axis: str, dim: int, what: str) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``, split over
    ``axis``."""
    parts, size = mesh.shape[axis], x.shape[dim]
    if size % parts:
        raise ValueError(
            f"{what}: {size} along dim {dim} not divisible by mesh axis "
            f"{axis!r} of size {parts}"
        )
    k = size // parts
    return x.narrow(dim, mesh.index(axis) * k, k)


def _to_device(x, mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(x).to(mesh.device)


def shard_batch(batch, mesh: Mesh, axis_name: str = "data"):
    """This rank's block of every array leaf along its leading (batch)
    axis; scalars are kept whole. Leaves come back as tensors on the
    mesh's device."""
    def put(x):
        x = _to_device(x, mesh)
        if x.dim() == 0:
            return x
        return _block(x, mesh, axis_name, 0, "shard_batch").contiguous()

    return _tree_map(put, batch)


def shard_batch_2d(
    batch,
    mesh: Mesh,
    data_axis: str = "data",
    time_axis: str = "time",
):
    """This rank's block of a train Batch over (data x time).

    Per-frame tensors (phis/kps/poses_gt/joints_gt: (B, T, ...)) split the
    batch over ``data`` and time over ``time``; per-tube tensors ((B, ...))
    over ``data`` only; the mocap real pool is kept whole. T must divide
    the time-axis size.
    """
    time_sharded = {"phis", "kps", "poses_gt", "joints_gt"}
    data_sharded = {"shapes_gt", "has_3d_joints", "has_3d_smpl"}

    t_dev = mesh.shape[time_axis]
    out = {}
    for name, x in batch._asdict().items():
        x = _to_device(x, mesh)
        if name in time_sharded:
            if x.shape[1] % t_dev != 0:
                raise ValueError(
                    f"{name}: T={x.shape[1]} not divisible by "
                    f"time mesh axis {t_dev}"
                )
            x = _block(_block(x, mesh, data_axis, 0, name), mesh,
                       time_axis, 1, name)
        elif name in data_sharded:
            x = _block(x, mesh, data_axis, 0, name)
        out[name] = x.contiguous()
    return type(batch)(**out)


def replicate(tree, mesh: Mesh):
    """Rank 0's tensors on every rank, by broadcast: every array leaf of a
    state dict (or any tree ``shard_batch`` takes) comes back as a new
    tensor on the mesh's device."""
    def put(x):
        return broadcast(
            torch.as_tensor(x).detach().to(mesh.device, copy=True)
            .contiguous(), mesh)

    return _tree_map(put, tree)
