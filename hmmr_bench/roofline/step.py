"""The least time of a whole served clip or training step, by precision:
the operations the result needs (2 a multiply-add, matrix products and
convolutions only) over the published peak of the precision they run in.
Padding, recomputation and the hallucinator branch, whose output a served
clip does not use, are not counted.

- Served clip (``hmmr-int8-serve``): the ResNet's convs but the root in
  int8; the root in bf16; the window model in bf16 (the temporal encoder
  on every needed window's T frames, the present IEF and the two delta
  IEFs on the kept frames); K1 on every kept frame of the three heads as
  3xTF32.
- Training step (``hmmr-fp32-train``, fp32 without TF32): the forward of
  the temporal encoder, the hallucinator and the four IEF heads on B*T
  rows, their weight gradients, their input gradients but those into phi;
  the discriminator; K1's forward as 3xTF32 and the composed SMPL's
  backward (one pass of K1's products) in fp32; in image mode the frozen
  ResNet's forward in fp32.
"""

from __future__ import annotations

from typing import Dict

from hmmr_bench.roofline import k1, peaks
from hmmr_bench.roofline.resnet50 import convs

NUM_STAGE = 3


def _ief_macs(feature_dim: int, out: int) -> int:
    """Per row, the three stages of fc(C + out -> 1024) -> fc1024 -> fc(out)."""
    return NUM_STAGE * ((feature_dim + out) * 1024 + 1024 * 1024 + 1024 * out)


def _temporal_macs(feature_dim: int, layers: int) -> int:
    """Per row, 2 convs of width 3 per block."""
    return layers * 2 * 3 * feature_dim * feature_dim


def _least_ms(ops: Dict[str, float]) -> float:
    rate = {"int8": peaks.INT8_OPS, "bf16": peaks.BF16_OPS,
            "tf32": peaks.TF32_OPS, "fp32": peaks.FP32_OPS}
    return sum(v / rate[k] for k, v in ops.items()) * 1e3


def serve_clip(frames: int, config: Dict, size: int = 224):
    """(least ms, ops by precision) of one clip of ``frames`` frames."""
    c, layers = config["feature_dim"], config["num_conv_layers"]
    b, t = config["batch_size"], config["seq_length"]
    g = t - 4 * layers
    trunk = [cv for cv in convs(size)]
    int8 = sum(2 * cv.macs() for cv in trunk if cv.name != "root") * frames
    bf16 = sum(2 * cv.macs() for cv in trunk if cv.name == "root") * frames
    windows = -(-frames // g)
    bf16 += 2 * windows * t * _temporal_macs(c, layers)
    bf16 += 2 * frames * (_ief_macs(c, 85) + 2 * _ief_macs(c, 72))
    tf32 = 3 * k1.work(3 * frames, config["num_verts"])[0]
    ops = {"int8": int8, "bf16": bf16, "tf32": tf32}
    return _least_ms(ops), ops


def train_step(rows: int, config: Dict, image_size: int = 0, disc_rows: int = 0):
    """(least ms, ops by precision) of one step on ``rows`` = B*T frames of
    this card; ``disc_rows`` real poses in the mocap pool (default: as many
    as the fakes)."""
    c, layers = config["feature_dim"], config["num_conv_layers"]
    heads = 4
    ief = 2 * _ief_macs(c, 85) + 2 * _ief_macs(c, 72)
    temporal = _temporal_macs(c, layers)
    hal = 3 * c * c
    fwd = temporal + hal + ief
    # Backward: the weight gradients of every layer, the input gradients of
    # all but the first temporal conv and the hallucinator's fc1 (their
    # inputs lead only to phi).
    bwd = 2 * fwd - 3 * c * c - c * c
    fp32 = 2 * rows * (fwd + bwd)
    fakes = heads * rows
    real = disc_rows or fakes
    d_fc = 23 * 9 * 32 + 23 * 32 * 32 + 23 * 32 * 1024 + 1024 * 1024 + 1024
    fp32 += 2 * d_fc * (fakes + (real + fakes))        # forward: E's and D's
    fp32 += 2 * d_fc * ((real + fakes) + fakes)        # D's weights, E's inputs
    products = k1.work(heads * rows, config["num_verts"])[0]
    tf32 = 3 * products
    fp32 += products                                   # composed SMPL backward
    if image_size:
        fp32 += sum(2 * cv.macs() for cv in convs(image_size)) * rows
    ops = {"fp32": fp32, "tf32": tf32}
    return _least_ms(ops), ops
