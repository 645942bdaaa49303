"""Closed loop, one client, whole clips through ``HmmrPredictor``.

The JAX package's benchmark workload (its serving loop) written for the
port: ``clips`` distinct clips of ``frames`` f32 frames of image_size^2,
uniform in [-1, 1], made on the device; the predictor in the
configuration's precision path (int8 encoder with static scales
calibrated on the first clip's first ``int8_calibration_frames`` frames, bf16
window model, fused SMPL); each call ``predict_all_images(clip,
as_numpy=False)`` with its outputs left on the device, synchronised,
then the next clip, cycling through the clips.

End to end: ``clip_fps``, the frames of every clip completed in the window
over the window's seconds; ``clip_ms_p95``, the 95th percentile of every
clip's latency (submission to synchronised completion). A clip is sent
while the window is open; the window closes when the last one completes.

``correct``: a sample of the window's clips, drawn from the seed (reservoir
sampling over every clip completed), against ``reference.serve``: the
int8 trunk with the scales worked out again from the same calibration
frames, the window model in bf16 as the configuration states, SMPL in fp32. ``omega_gap`` and ``verts_gap``
are the widest gap over the sampled frames of the present and delta heads'
omegas and vertices, over the reference's RMS value.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

from hmmr_bench.harness import core, inputs
from hmmr_bench.harness.trace import Reading, traced
from hmmr_bench.reference import model as M
from hmmr_bench.reference import serve as ref

GAPS = {"omega_gap": ("omegas", "omegas_delta"), "verts_gap": ("verts", "verts_delta")}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def make_inputs(ctx: core.Run, torch):
    cfg, p, dev = ctx.config, ctx.params, ctx.device
    weights = inputs.make_params(
        M.hmmr_specs(cfg["feature_dim"], True, cfg["num_conv_layers"]), ctx.seed, dev)
    smpl = inputs.smpl_arrays(ctx.seed, cfg["num_verts"], cfg["num_kps"], dev)
    clips = inputs.uniform_clips(ctx.seed, p["clips"], p["frames"], p["image_size"], dev)
    return weights, smpl, clips


def build_predictor(ctx: core.Run, weights, smpl, calibration):
    """The program under test, on the weights and SMPL model made here."""
    from human_dynamics_tpu_torch.core.smpl import SmplModel
    from human_dynamics_tpu_torch.infer.predictor import HmmrPredictor
    from human_dynamics_tpu_torch.models.hmmr import HmmrModel

    cfg = ctx.config
    model = HmmrModel(include_resnet=True, feature_dim=cfg["feature_dim"],
                      num_conv_layers=cfg["num_conv_layers"], device="meta")
    model.to_empty(device=ctx.device)
    model.load_state_dict(weights)
    return HmmrPredictor(
        model, None, SmplModel(**smpl), batch_size=cfg["batch_size"],
        seq_length=cfg["seq_length"], use_fused_smpl=cfg["use_fused_smpl"],
        bf16_temporal=cfg["bf16_temporal"], int8_encoder=cfg["int8_encoder"],
        int8_calibration=calibration, encode_chunk=cfg["encode_chunk"],
        device=ctx.device)


def reference_outputs(ctx: core.Run, weights, smpl, clip, calibration, bits=8):
    import torch

    cfg = ctx.config
    with torch.no_grad():
        phi = ref.encode(weights, clip, calibration, bits, ctx.params["reference_chunk"])
        dtype = torch.bfloat16 if cfg["bf16_temporal"] else torch.float32
        return ref.predict(weights, smpl, phi, cfg["batch_size"], cfg["seq_length"],
                           cfg["num_conv_layers"], dtype)


def gaps(got: Dict, want: Dict) -> Dict[str, float]:
    import torch

    out = {}
    for name, keys in GAPS.items():
        widest = max(float((got[k].float() - want[k]).abs().max()) for k in keys)
        rms = float(torch.cat([want[k].reshape(-1) for k in keys]).square().mean().sqrt())
        out[name] = widest / rms
    return out


def _reference_mode(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run(ctx: core.Run) -> None:
    import torch

    p = ctx.params
    ctx.mark("imports")
    weights, smpl, clips = make_inputs(ctx, torch)
    ctx.mark("inputs made")
    calibration = clips[0][:ctx.config["int8_calibration_frames"]]
    predictor = build_predictor(ctx, weights, smpl, calibration)
    ctx.mark("predictor built, int8 weights and scales")
    for i in range(p["warmup_clips"]):
        predictor.predict_all_images(clips[i % len(clips)], as_numpy=False)
    core.sync(torch, ctx.device)

    rng = random.Random(ctx.seed)
    kept: List = []           # (clip index, outputs) of the sampled clips
    latencies: List[float] = []

    def one(i):
        t = time.perf_counter()
        out = predictor.predict_all_images(clips[i % len(clips)], as_numpy=False)
        core.sync(torch, ctx.device)
        latencies.append(time.perf_counter() - t)
        k = p["sample_clips"]
        if len(kept) < k:
            kept.append((i % len(clips), out))
        else:
            j = rng.randrange(i + 1)
            if j < k:
                kept[j] = (i % len(clips), out)

    ctx.setup_done()
    if ctx.trace:
        n = p["trace_clips"]
        t0 = time.perf_counter()
        for i in range(n):          # the same clips untraced, for the wall per clip
            one(i)
        untraced = (time.perf_counter() - t0) / n

        def window():
            for i in range(n, 2 * n):
                with torch.profiler.record_function("hmmr_bench.clip"):
                    one(i)
        _, wall, events = traced(torch, window)
        ctx.reading = Reading(events, n, ctx.params, ctx.config, wall,
                              extra={"untraced_unit_s": untraced})
    else:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < ctx.seconds:
            one(i)
            i += 1
        elapsed = time.perf_counter() - t0
        ctx.e2e["clip_fps"] = i * p["frames"] / elapsed
        ctx.e2e["clip_ms_p95"] = percentile(latencies, 95) * 1e3
    ctx.attempted, ctx.failed = len(latencies), 0
    ctx.info = core.device_info(torch, ctx.device, 1)

    del predictor
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    _reference_mode(torch)
    worst: Dict[str, float] = {}
    for ci, out in kept:
        want = reference_outputs(ctx, weights, smpl, clips[ci], calibration)
        for k, v in gaps(out, want).items():
            worst[k] = max(worst.get(k, 0.0), v) if v == v else float("nan")
    ctx.compared = worst


def control(ctx: core.Run) -> Dict[str, float]:
    """The control's readings: the reference with its encoder in int4 put in
    the program's place, on as many clips as a run samples."""
    import torch

    weights, smpl, clips = make_inputs(ctx, torch)
    calibration = clips[0][:ctx.config["int8_calibration_frames"]]
    _reference_mode(torch)
    rng = random.Random(ctx.seed)
    worst: Dict[str, float] = {}
    for ci in rng.sample(range(len(clips)), ctx.params["sample_clips"]):
        want = reference_outputs(ctx, weights, smpl, clips[ci], calibration, 8)
        low = reference_outputs(ctx, weights, smpl, clips[ci], calibration, 4)
        for k, v in gaps(low, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
