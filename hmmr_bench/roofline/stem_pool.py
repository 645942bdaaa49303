"""The fused int8 root stem + max pool (``int8_root``): a copy of
``chip_smoke.py``'s ``stem_pool_bound``, from shapes.

Operations: the stem's 7x7x3 taps per output, 2 a multiply-add, at the
int8 rate (the folds' zero K slots are not the function's work). Bytes:
the frames (uint8, or f32), the fold's int8 weights, the epilogue's f32
multiplier and add (for "u8" the border map's entries where the tap window
leaves the frame: rows and columns 0, 1 and the last of the stem's map)
and the pre-activation's operands read once; the pooled int8 map written
once.
"""

from __future__ import annotations

from hmmr_bench.roofline import peaks

STEM_TAPS = 7 * 7 * 3
COUT = 64
FOLD_K = {"s2d": 4 * 4 * 12, "wfold": 7 * 4 * 6}


def work(frames: int, size: int = 224, fold: str = "wfold", kind: str = "u8",
         preact: bool = True):
    """(operations, bytes) of one call on ``frames`` frames of size^2."""
    ho = size // 2
    po = -(-ho // 2)
    ops = 2 * frames * ho * ho * COUT * STEM_TAPS
    pixel = 1 if kind == "u8" else 4
    b = frames * size * size * 3 * pixel + COUT * FOLD_K[fold] + 4 * COUT
    if kind == "u8":
        b += (6 * ho - 9) * COUT * 4          # the border map's entries
    else:
        b += 4 * COUT                         # the add
    b += frames * po * po * COUT
    if preact:
        b += 2 * 4 * COUT + 4 + 4
    return ops, b


def bound_ms(frames: int, size: int = 224, fold: str = "wfold", kind: str = "u8",
             preact: bool = True):
    ops, b = work(frames, size, fold, kind, preact)
    return peaks.bound_ms(ops, peaks.INT8_OPS, b)
