"""human_dynamics_tpu_torch: the PyTorch/CUDA port of human_dynamics_tpu.

The JAX package ``human_dynamics_tpu`` is the reference; each subpackage
and module here keeps the name of its JAX counterpart.

- core/    SMPL body model, rotations, camera projection.
- ops/     Hand-written CUDA kernels (fused SMPL blend + skin) and their
           plain PyTorch versions; ``_build`` compiles them with nvcc.
- models/  ResNet-50 v2 encoder, temporal encoder, IEF heads (dropout in
           train mode), hallucinator, the full HMMR model, the pose
           discriminator.
- infer/   Sliding-window schedule, the windowed and streaming
           predictors, the prediction service.
- eval/    The evaluation harness and its metrics (numpy and on-device).
- data/    tfrecord codec, record schema, the phi-mode training pipeline.
- train/   Losses, the two-optimizer GAN step, the Trainer, the CLI.
- utils/   Config, npz checkpoints, logging, precision, and the bridge
           that moves variable trees between the JAX layout and the port.

This package imports torch and numpy, never jax or flax.
"""

__version__ = "0.1.0"
