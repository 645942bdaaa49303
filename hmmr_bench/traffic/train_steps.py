"""``Trainer.step`` back to back on a pool of seeded batches.

The configuration's ``Trainer`` (fp32 without TF32, ``freeze_phi``, two
Adams, fused SMPL) on ``pool_batches`` distinct batches made on the device
from the seed: B = ``batch_size_per_card`` tubes of T frames, phi
(``image_size`` 0) or image_size^2 frames already cropped, with 2-D
keypoints, 3-D joints, SMPL parameters and the mocap pool. The trainer's
k-th step takes batch k mod ``pool_batches``.

Set-up builds the trainer, loads the weights made here, takes its first
three steps through ``Trainer.step`` and ``warmup_steps`` more; the window
continues the same trainer. End to end: ``train_fps``, B*T frames of every
step completed in the window over the window's seconds (the window ends
with a synchronise).

``correct``: ``reference.train`` follows two stretches of three steps of
the same trainer on the same batches and dropout seeds (the trainer's
(seed << 32) + step): its first three, from the weights made here, and
the three it takes through the same call as soon as the window has
closed, from the program's weights and both Adams' moments as the window
left them (that stretch the reference can only follow from the
program's own state). Compared for each stretch (the second's names end
in ``.last``): ``loss_gap``, the widest relative gap of each step's
e_loss and d_loss; ``grad_gap``, the stretch's first gradient as Adam
holds it ((m_after - 0.9 m_before) / 0.1) against the reference's, and
``change_gap``, the parameters' change over the stretch against the
reference's, each by the worst leaf: the gap between the two norms over
the larger of the reference leaf's norm and the median leaf's. Leaves
whose reference gradient is under a thousandth of the median leaf's are
left out (Adam moves them by round-off alone).
"""

from __future__ import annotations

import time
from typing import Dict

from hmmr_bench.harness import core, inputs
from hmmr_bench.harness.trace import Reading, traced
from hmmr_bench.reference import model as M
from hmmr_bench.reference import train as ref

STEPS = 3      # the steps of each checked stretch
_RESNET = "resnet_v2_50."


def _config(ctx: core.Run):
    from human_dynamics_tpu_torch.utils.config import Config

    cfg, p = ctx.config, ctx.params
    return Config(
        batch_size=p["batch_size_per_card"], T=cfg["seq_length"],
        feature_dim=cfg["feature_dim"], num_conv_layers=cfg["num_conv_layers"],
        precomputed_phi=not p["image_size"], img_size=p["image_size"] or 224,
        freeze_phi=cfg["freeze_phi"], use_fused_smpl=cfg["use_fused_smpl"],
        e_lr=cfg["e_lr"], d_lr=cfg["d_lr"], seed=ctx.seed & 0x7FFFFFFF,
        smpl_mean_path="", model_dir=None)


def make_inputs(ctx: core.Run, config):
    from human_dynamics_tpu_torch.train.trainer import fake_pool_size

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    image = bool(p["image_size"])
    h_specs = M.hmmr_specs(cfg["feature_dim"], image, cfg["num_conv_layers"])
    weights = inputs.make_params(h_specs, ctx.seed, dev)
    disc = inputs.make_params(M.disc_specs(), ctx.seed, dev,
                              offset=inputs.count_normal(h_specs))
    smpl = inputs.smpl_arrays(ctx.seed, cfg["num_verts"], cfg["num_kps"], dev)
    batches = inputs.train_batches(
        ctx.seed, p["pool_batches"], config.batch_size, config.T, cfg["feature_dim"],
        p["image_size"], cfg["num_kps"], fake_pool_size(config), dev)
    return weights, disc, smpl, batches


def _generators(seeds, device):
    import torch

    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def leaf_gap(got: Dict, want: Dict, grads: Dict) -> float:
    """The worst leaf's gap between the norms of ``got`` and ``want``, over
    the larger of the reference leaf's norm and the median leaf's; leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out."""
    g = {k: float(v.norm()) for k, v in grads.items()}
    g_med = sorted(g.values())[len(g) // 2]
    keep = [k for k in want if g[k] >= 1e-3 * g_med]
    w = {k: float(want[k].norm()) for k in keep}
    med = sorted(w.values())[len(w) // 2]
    return max(abs(float(got[k].norm()) - w[k]) / max(w[k], med) for k in keep)


def compare(prog: Dict, want: Dict, p0: Dict, suffix: str = "") -> Dict[str, float]:
    """The three numbers of ``correct`` of one stretch from the program's
    readings (losses, first gradient, params after) and the reference's,
    both from the parameters ``p0``."""
    loss = max(abs(a - b) / abs(b)
               for k in ("e_loss", "d_loss")
               for a, b in zip(prog[k], want[k]))
    grad = leaf_gap(prog["grads"], want["grads"], want["grads"])
    change = leaf_gap({k: prog["params"][k] - p0[k] for k in want["grads"]},
                      {k: want["params"][k] - p0[k] for k in want["grads"]},
                      want["grads"])
    return {"loss_gap" + suffix: loss, "grad_gap" + suffix: grad,
            "change_gap" + suffix: change}


def reference(ctx: core.Run, config, first_step: int, P_e, P_d, frozen, smpl, batches,
              moments=None, tf32=False):
    """The reference's stretch of STEPS steps from the trainer's step
    ``first_step``, from ``P_e``, ``P_d`` and Adam's ``moments``."""
    import torch

    steps = range(first_step, first_step + STEPS)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return ref.run_steps(
            P_e, P_d, frozen, smpl, [batches[k % len(batches)] for k in steps],
            _generators([(config.seed << 32) + k for k in steps], ctx.device),
            config.e_lr, config.d_lr, moments=moments)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def checked_steps(state, named: Dict, step, snapshot: bool) -> Dict:
    """STEPS steps through ``step``, read as the reference reads them: with
    ``snapshot`` the weights and Adam's m and v before them, each step's
    losses, the first step's gradient as Adam holds it, the weights
    after."""
    out = {"e_loss": [], "d_loss": []}
    if snapshot:
        out["before"] = {k: v.detach().clone() for k, v in named.items()}
        out["m"] = {k: _moment(state, v, "exp_avg") for k, v in named.items()}
        out["v"] = {k: _moment(state, v, "exp_avg_sq") for k, v in named.items()}
    for s in range(STEPS):
        metrics = step()
        out["e_loss"].append(float(metrics["e_loss"]))
        out["d_loss"].append(float(metrics["d_loss"]))
        if s == 0:
            out["grads"] = {
                k: ((_moment(state, v, "exp_avg").double()
                     - (0.9 * out["m"][k].double() if snapshot else 0.0)) / 0.1).float()
                for k, v in named.items()}
    out["params"] = {k: v.detach().clone() for k, v in named.items()}
    return out


class _Span:
    """A profiler range opened by a forward pre-hook and closed by the
    forward hook of one module: the benchmark's own span around it."""

    def __init__(self, torch, module, name):
        self.torch, self.name, self.open = torch, name, []
        self.handles = [module.register_forward_pre_hook(self.enter),
                        module.register_forward_hook(self.exit)]

    def enter(self, *_):
        rf = self.torch.profiler.record_function(self.name)
        rf.__enter__()
        self.open.append(rf)

    def exit(self, *_):
        self.open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def run(ctx: core.Run) -> None:
    import torch

    from human_dynamics_tpu_torch.core.smpl import SmplModel
    from human_dynamics_tpu_torch.train.trainer import Batch, Trainer

    p = ctx.params
    ctx.mark("imports")
    config = _config(ctx)
    weights, disc, smpl, batches = make_inputs(ctx, config)
    ctx.mark("inputs made")
    trainer = Trainer(config, SmplModel(**smpl), device=ctx.device)
    st = trainer.state
    st.hmmr.load_state_dict(weights)
    st.disc.load_state_dict(disc)
    blocks = [Batch(**b) for b in batches]
    named = {**{k: v for k, v in st.hmmr.named_parameters() if v.requires_grad},
             **dict(st.disc.named_parameters())}
    done = 0

    def step():
        nonlocal done
        metrics = trainer.step(blocks[done % len(blocks)])
        done += 1
        return metrics

    ctx.mark("trainer built")
    first = checked_steps(st, named, step, snapshot=False)
    for _ in range(p["warmup_steps"]):     # further warm-up, not checked
        step()
    core.sync(torch, ctx.device)

    frames = config.batch_size * config.T
    if ctx.trace:
        span = (_Span(torch, st.hmmr.resnet_v2_50, "hmmr_bench.resnet")
                if p["image_size"] else None)
        ctx.setup_done()
        n = p["trace_steps"]
        t0 = time.perf_counter()
        for _ in range(n):          # as many steps untraced, for the wall per step
            step()
        core.sync(torch, ctx.device)
        untraced = (time.perf_counter() - t0) / n

        def window():
            for _ in range(n):
                with torch.profiler.record_function("hmmr_bench.step"):
                    step()
        _, wall, events = traced(torch, window)
        if span is not None:
            span.remove()
        ctx.reading = Reading(events, n, ctx.params, ctx.config, wall,
                              extra={"rows": frames, "image_size": p["image_size"],
                                     "untraced_unit_s": untraced})
        ctx.attempted = n
    else:
        ctx.setup_done()
        host0 = core.host_usage()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < ctx.seconds:
            step()
            n += 1
        core.sync(torch, ctx.device)
        wall = time.perf_counter() - t0
        ctx.e2e["train_fps"] = n * frames / wall
        ctx.attempted = n
        ctx.mark_host(host0, wall)
    ctx.info = core.device_info(torch, ctx.device, 1)

    at_close = done
    last = checked_steps(st, named, step, snapshot=True)
    del trainer, st, named, blocks
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.compared = judge(ctx, config, weights, disc, smpl, batches, first, last, at_close)


def judge(ctx: core.Run, config, weights, disc, smpl, batches, first, last,
          at_close: int) -> Dict[str, float]:
    """The compared numbers of both stretches: the program's against the
    reference's, or with ``ctx.control`` the control's (the reference with
    TF32 on, put in the program's place from the same starts)."""
    frozen = {k: v for k, v in weights.items()
              if k.startswith(_RESNET) and config.freeze_phi}
    P_e = {k: v for k, v in weights.items() if k not in frozen}
    P_e_last = {k: last["before"].get(k, v) for k, v in P_e.items()}
    P_d_last = {k: last["before"].get(k, v) for k, v in disc.items()}
    moments = (last["m"], last["v"], at_close)
    args = [(0, P_e, disc, None), (at_close, P_e_last, P_d_last, moments)]
    want = [reference(ctx, config, k, e, d, frozen, smpl, batches, m) for k, e, d, m in args]
    if ctx.control:
        first, last = [reference(ctx, config, k, e, d, frozen, smpl, batches, m, tf32=True)
                       for k, e, d, m in args]
    return {**compare(first, want[0], {**P_e, **disc}),
            **compare(last, want[1], {**P_e_last, **P_d_last}, ".last")}


def _moment(state, param, which: str):
    """Adam's ``which`` moment of ``param``, copied; zeros where Adam holds
    none (it never stepped on it)."""
    for opt in (state.opt_e, state.opt_d):
        if param in opt.state:
            return opt.state[param][which].detach().clone()
    return param.detach().new_zeros(param.shape)


def control(ctx: core.Run) -> Dict[str, float]:
    """The control's readings: the reference with TF32 on put in the
    program's place, against the reference without it, over both
    stretches (the program runs for the second's start)."""
    ctx.control = True
    run(ctx)
    return ctx.compared
