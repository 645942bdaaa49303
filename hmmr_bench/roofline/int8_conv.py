"""The int8 conv kernel's work on the static int8 trunk (the bf16 root, no
int8 stream): a copy of ``chip_smoke.py``'s ``conv_call_bound`` applied to
every int8 conv of a chunk, from shapes alone.

Per call: 2 operations a multiply-add; bytes of the int8 input, the int8
weights, the per-channel f32 multiplier and add, the bf16 residual (conv3)
read once, and the output written once (int8 for conv1 and conv2, bf16
for the shortcut and conv3); conv3 of every unit but the last also writes
the next unit's int8 pre-activation, reading its f32 multiplier, add and
scale.
"""

from __future__ import annotations

from hmmr_bench.roofline import peaks
from hmmr_bench.roofline.resnet50 import convs

UNITS = 16


def chunk_work(frames: int, size: int = 224):
    """(operations, bytes) of one trunk call's int8 convs on ``frames``."""
    ops = nbytes = 0
    for c in convs(size):
        if c.name == "root":
            continue
        m = frames * c.ho * c.ho
        k = c.cin * c.k * c.k
        ops += 2 * m * k * c.cout
        b = frames * c.h * c.h * c.cin + c.cout * k + 2 * 4 * c.cout
        if c.name.endswith(("conv1", "conv2")):
            b += m * c.cout                          # int8 out
        else:
            b += 2 * m * c.cout                      # bf16 out
        if c.last:
            b += 2 * m * c.cout                      # bf16 residual in
            if c.unit < UNITS:
                b += 2 * 4 * c.cout + 4 + m * c.cout  # fused pre-activation
        nbytes += b
    return ops, nbytes


def chunk_bound_ms(frames: int, size: int = 224):
    """(least ms, by) of one trunk call's int8 convs."""
    ops, b = chunk_work(frames, size)
    return peaks.bound_ms(ops, peaks.INT8_OPS, b)


def clip_work(frames: int, chunk: int, size: int = 224):
    """(operations, bytes) of a clip encoded in chunks of ``chunk``."""
    ops = b = 0
    for start in range(0, frames, chunk):
        o, n = chunk_work(min(chunk, frames - start), size)
        ops, b = ops + o, b + n
    return ops, b
