"""K1, the fused SMPL blend shapes + skinning kernel: a copy of
``chip_smoke.py``'s ``k1_bound``.

Per vertex and frame: the blend products (217 coefficients x 3
coordinates) and the skinning products (12 transform channels x 24
joints), 2 FLOP a multiply-add, each run as three TF32 products (3xTF32);
the template add and the 3x4 transform on the FP32 pipe. Bytes of the
unpadded operands read once and the 3 planes written once.
"""

from __future__ import annotations

from hmmr_bench.roofline import peaks

COEF_DIM = 10 + 207      # betas and the pose-blend feature
RT_CH = 12               # 9 rotation + 3 translation channels
NUM_JOINTS = 24


def work(n: int, v: int):
    """(products, flops, bytes) of one call on N frames of V vertices."""
    products = n * v * 2 * (3 * COEF_DIM + RT_CH * NUM_JOINTS)
    flops = products + n * v * (3 + 18)
    moved = 4 * (n * COEF_DIM + RT_CH * NUM_JOINTS * n + 3 * COEF_DIM * v
                 + 3 * v + NUM_JOINTS * v + 3 * n * v)
    return products, flops, moved


def bound_ms(n: int, v: int = 6890):
    """(least ms, by) on the TF32 tensor cores, three products each."""
    products, _, moved = work(n, v)
    return peaks.bound_ms(3 * products, peaks.TF32_OPS, moved)


def fp32_bound_ms(n: int, v: int = 6890):
    """The same work on the FP32 pipe."""
    _, flops, moved = work(n, v)
    return peaks.bound_ms(flops, peaks.FP32_OPS, moved)
