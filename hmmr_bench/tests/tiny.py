"""Tiny sizes of the cells for the CPU tests: the same code paths, the
port's plain kernels on the CPU."""

import torch

from hmmr_bench.harness import core

SEED = 2_147_483_713

SERVE = {"params": {"frames": 24, "clips": 2, "image_size": 64, "warmup_clips": 1,
                    "sample_clips": 1, "trace_clips": 2, "reference_chunk": 12},
         "config": {"num_verts": 300, "encode_chunk": 12, "int8_calibration_frames": 8,
                    "batch_size": 2}}
# The training cell on precomputed phi (image_size 0), the CPU's fastest path
# through train_steps.
TRAIN = {"params": {"batch_size_per_card": 2, "pool_batches": 4, "trace_steps": 2,
                    "image_size": 0},
         "config": {"num_verts": 300, "seq_length": 8, "feature_dim": 64}}


def run(cell: str, overrides, seconds: float = 0.5, seed: int = SEED):
    r = core.Run(cell, seed, seconds, False, overrides=overrides)
    r.device = torch.device("cpu")
    return r
