"""Multi-process setup: one Python process per GPU, on torch.distributed.

Counterpart of ``human_dynamics_tpu/parallel/multihost.py``, with the same
environment contract and errors. Where the JAX package starts one process
per host and ``jax.distributed`` finds the chips, the port starts one
process per GPU and ``initialize`` joins them into one process group:
NCCL for CUDA devices, gloo when the caller asks for the CPU.

Usage (one command per GPU)::

    HD_TPU_COORDINATOR=host0:9876 HD_TPU_NUM_PROCESSES=4 \
    HD_TPU_PROCESS_ID=$i python my_script.py ...

The coordinator is ``host:port`` (rank 0 listens there) or a rendezvous URL
that ``torch.distributed.init_process_group`` reads as it is, such as
``file:///shared/path``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

ENV_COORDINATOR = "HD_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "HD_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "HD_TPU_PROCESS_ID"

# A collective that waits longer than this raises instead of hanging.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def process_env(
    environ: Optional[dict] = None,
) -> Optional[Tuple[str, int, int]]:
    """Parse (coordinator_address, num_processes, process_id) from the
    environment, or None when not configured for multi-process."""
    env = os.environ if environ is None else environ
    coordinator = env.get(ENV_COORDINATOR)
    num_processes = int(env.get(ENV_NUM_PROCESSES, "1"))
    if num_processes <= 1:
        return None
    if not coordinator:
        raise ValueError(
            f"{ENV_NUM_PROCESSES}={num_processes} requires "
            f"{ENV_COORDINATOR}=host:port"
        )
    process_id = int(env.get(ENV_PROCESS_ID, "-1"))
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"{ENV_PROCESS_ID} must be in [0, {num_processes})"
        )
    return coordinator, num_processes, process_id


def default_backend(device) -> str:
    """NCCL for a CUDA device (None means CUDA), gloo for the CPU."""
    if device is None or torch.device(device).type == "cuda":
        return "nccl"
    return "gloo"


def initialize(
    environ: Optional[dict] = None,
    device=None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> Tuple[int, int]:
    """Join the process group if configured; returns (rank, world_size).

    Safe to call unconditionally: a single-process run (no env config)
    returns (0, 1) without touching torch.distributed, or the group's
    (rank, size) when the caller has already initialised one.

    Args:
        environ: the environment to read (default ``os.environ``).
        device: where this process computes; picks the backend when
            ``backend`` is None (NCCL for CUDA, which None means).
        backend: a torch.distributed backend name, to override that
            choice: gloo also runs collectives on CUDA tensors (all_reduce
            and broadcast), which lets several processes share one GPU.
        timeout: how long a collective may wait before it raises.
    """
    import torch.distributed as dist

    spec = process_env(environ)
    if spec is None:
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    coordinator, num_processes, process_id = spec
    if backend is None:
        backend = default_backend(device)
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "the NCCL backend needs a CUDA device; pass device='cpu' to run "
            "the process group on gloo"
        )
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes,
        rank=process_id, timeout=timeout,
    )
    return dist.get_rank(), dist.get_world_size()
