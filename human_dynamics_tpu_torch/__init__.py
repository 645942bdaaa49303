"""human_dynamics_tpu_torch: the PyTorch/CUDA port of human_dynamics_tpu.

The JAX package ``human_dynamics_tpu`` is the reference; each subpackage
and module here keeps the name of its JAX counterpart.

- core/    SMPL body model, rotations, camera projection.
- ops/     Hand-written CUDA kernels (fused SMPL blend + skin) and their
           plain PyTorch versions; ``_build`` compiles them with nvcc.
- models/  ResNet-50 v2 encoder, temporal encoder, IEF heads,
           hallucinator, the full HMMR model.
- infer/   Sliding-window schedule and the windowed predictor.
- utils/   The bridge that loads JAX checkpoints and variable trees.

This package imports torch and numpy, never jax or flax.
"""

__version__ = "0.1.0"
