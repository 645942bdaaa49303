"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the least time of a piece of work.

A copy of ``chip_smoke.py``'s peaks and ``bound_ms``, kept here so that
the yardstick does not move with the program's files.
"""

INT8_OPS = 1979e12     # int8 tensor cores, operations/s
BF16_OPS = 989e12      # bf16 tensor cores, FLOP/s
TF32_OPS = 495e12      # TF32 tensor cores, FLOP/s
FP32_OPS = 67e12       # fp32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12    # HBM3, bytes/s


def bound_ms(ops: float, rate: float, nbytes: float):
    """(least ms, "operations" or "bytes"): the larger of ``ops`` at
    ``rate`` and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
