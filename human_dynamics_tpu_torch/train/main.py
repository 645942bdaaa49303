"""Training entry point.

Counterpart of ``human_dynamics_tpu/train/main.py``: Config -> model_dir
(+ params.json) -> data pipeline -> Trainer with auto-resume (and warm
start) -> train loop -> a final checkpoint. One process on one device. With
``--precomputed_phi false`` it trains on images through the ResNet (the
pipeline augments them on the device).

    python -m human_dynamics_tpu_torch.train.main \\
        --data_dir /path/to/tf_datasets \\
        --smpl_model_path models/smpl_model.npz --log_dir logs

``--device`` picks the torch device: the CUDA device by default (and an
error without one), ``cpu`` to run on the CPU.
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


def main(argv=None):
    """Train; returns the Trainer after its final save."""
    import torch

    from human_dynamics_tpu_torch.core.smpl import load_smpl_model
    from human_dynamics_tpu_torch.data.loader import TrainDataPipeline
    from human_dynamics_tpu_torch.infer.predictor import resolve_device
    from human_dynamics_tpu_torch.train.trainer import Batch, Trainer
    from human_dynamics_tpu_torch.utils.logging import MetricLogger

    args = build_arg_parser().parse_args(argv)
    config = config_from_args(args)
    device = resolve_device(args.device)

    config.prepare_dirs()
    config.save()
    print(f"[*] MODEL dir: {config.model_dir}")

    smpl = load_smpl_model(config.smpl_model_path, joint_type="cocoplus")
    pipeline = TrainDataPipeline(config, device=device)

    def device_batches():
        for batch in pipeline:
            yield Batch(*[torch.as_tensor(x, device=device) for x in batch])

    logger = MetricLogger(config.model_dir)
    try:
        trainer = Trainer(config, smpl, data_iter=device_batches(),
                          logger=logger, device=device)
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
        logger.close()
        pipeline.close()
    return trainer


if __name__ == "__main__":
    main()
