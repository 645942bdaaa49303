"""Training entry point.

Counterpart of ``human_dynamics_tpu/train/main.py``: Config -> model_dir
(+ params.json) -> data pipeline -> Trainer with auto-resume (and warm
start) -> train loop -> a final checkpoint. With ``--precomputed_phi
false`` it trains on images through the ResNet (the pipeline augments them
on the device).

    python -m human_dynamics_tpu_torch.train.main \\
        --data_dir /path/to/tf_datasets \\
        --smpl_model_path models/smpl_model.npz --log_dir logs

``--device`` picks the torch device: the CUDA device by default (and an
error without one), ``cpu`` to run on the CPU.

Data-parallel training runs one process per GPU, each started with the
same arguments and the ``HD_TPU_*`` variables of ``parallel.multihost``::

    for i in 0 1 2 3; do
      HD_TPU_COORDINATOR=localhost:9876 HD_TPU_NUM_PROCESSES=4 \\
      HD_TPU_PROCESS_ID=$i python -m human_dynamics_tpu_torch.train.main \\
          --data_dir ... --model_dir runs/dp4 & done

Process r joins the process group (NCCL; gloo with ``--device cpu`` or
``--backend gloo``), computes on ``cuda:{r % device_count}``, reads every
W-th record shard from its r-th on (a pipeline of ``batch_size // W``,
``host_id=r``, ``num_hosts=W``), and steps the data-parallel ``Trainer`` on
a mesh of all W processes: ``--batch_size`` is the global batch. Rank 0
resolves the model directory and writes params.json, the logs and the
checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI flags generated from the Config dataclass, plus --num_steps,
    --profile and --device."""
    from human_dynamics_tpu_torch.utils.config import Config

    parser = argparse.ArgumentParser(description=__doc__)
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        default = f.default
        if f.type == "bool" or isinstance(default, bool):
            parser.add_argument(
                name, type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default, nargs="?", const=True,
            )
        elif isinstance(default, tuple):
            parser.add_argument(name, nargs="*", default=default)
        elif default is None:
            parser.add_argument(name, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)
    parser.add_argument("--num_steps", type=int, default=None,
                        help="override max_iteration")
    parser.add_argument("--profile", action="store_true",
                        help="capture a torch.profiler trace of steps 10-15")
    parser.add_argument("--device", default=None,
                        help="torch device; the CUDA device by default, "
                             "'cpu' to run on the CPU")
    parser.add_argument("--backend", default=None,
                        help="torch.distributed backend of a multi-process "
                             "run: NCCL on CUDA by default, gloo on the CPU; "
                             "gloo lets several processes share one GPU")
    return parser


def config_from_args(args):
    from human_dynamics_tpu_torch.utils.config import Config

    kwargs = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name)
        if isinstance(f.default, tuple) and isinstance(v, list):
            v = tuple(
                int(x) if str(x).lstrip("-").isdigit() else x for x in v
            )
        kwargs[f.name] = v
    return Config(**kwargs)


def _from_rank0(text: str, mesh) -> str:
    """Rank 0's ``text`` on every rank of ``mesh``."""
    import torch

    from human_dynamics_tpu_torch.parallel.mesh import broadcast

    buf = torch.zeros(4096, dtype=torch.uint8, device=mesh.device)
    if mesh.rank == 0:
        data = text.encode()
        if len(data) >= len(buf):
            raise ValueError(f"model_dir is longer than {len(buf) - 1} bytes")
        buf[:len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    return bytes(broadcast(buf, mesh).cpu().tolist()).rstrip(b"\0").decode()


def main(argv=None):
    """Train; returns the Trainer after its final save. Under the
    ``HD_TPU_*`` contract it is this process's rank of a data-parallel run,
    and it leaves the process group it joined before returning."""
    import torch.distributed as dist

    from human_dynamics_tpu_torch.parallel import initialize_multihost

    args = build_arg_parser().parse_args(argv)
    config = config_from_args(args)
    joined = not dist.is_initialized()
    rank, world = initialize_multihost(device=args.device,
                                       backend=args.backend)
    try:
        return _train(args, config, rank, world)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, config, rank: int, world: int):
    """main's work as rank ``rank`` of ``world`` processes."""
    import dataclasses

    import torch

    from human_dynamics_tpu_torch.core.smpl import load_smpl_model
    from human_dynamics_tpu_torch.data.loader import TrainDataPipeline
    from human_dynamics_tpu_torch.infer.predictor import resolve_device
    from human_dynamics_tpu_torch.parallel import make_mesh
    from human_dynamics_tpu_torch.train.trainer import Batch, Trainer
    from human_dynamics_tpu_torch.utils.logging import MetricLogger

    if config.batch_size % world:
        raise ValueError(f"batch_size {config.batch_size} is not divisible "
                         f"by the {world} processes")
    mesh = make_mesh(world, device=args.device) if world > 1 else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if rank == 0:
        config.prepare_dirs()
        config.save()
        print(f"[*] MODEL dir: {config.model_dir}")
    if mesh is not None:
        config.model_dir = _from_rank0(config.model_dir, mesh)

    smpl = load_smpl_model(config.smpl_model_path, joint_type="cocoplus")
    # This rank's share of the global batch, and of the mocap pool.
    pipeline = TrainDataPipeline(
        dataclasses.replace(config, batch_size=config.batch_size // world),
        host_id=rank, num_hosts=world, device=device)

    def device_batches():
        for batch in pipeline:
            yield Batch(*[torch.as_tensor(x, device=device) for x in batch])

    logger = MetricLogger(config.model_dir) if rank == 0 else None
    try:
        trainer = Trainer(config, smpl, data_iter=device_batches(),
                          logger=logger, device=device, mesh=mesh)
        # Warm start: a fresh run with a pretrained path; in phi mode only
        # with use_hmr_ief_init (the warm start carries the IEF weights).
        if (config.pretrained_model_path and trainer.state.step == 0
                and (not config.precomputed_phi or config.use_hmr_ief_init)):
            trainer.load_pretrained(config.pretrained_model_path)
        num_steps = args.num_steps or config.max_iteration
        profile = range(10, 15) if args.profile else None
        try:
            trainer.train(num_steps, profile_steps=profile)
        finally:
            trainer.save()
    finally:
        if logger is not None:
            logger.close()
        pipeline.close()
    return trainer


if __name__ == "__main__":
    main()
