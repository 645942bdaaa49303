"""HMMR training: the two-optimizer GAN step and its training loop.

Counterpart of ``human_dynamics_tpu/train/trainer.py``, on precomputed phi
or, with ``precomputed_phi=False``, on images through the ResNet. Every
prediction head is decoded by one stacked SMPL call (the fused blend+skin
kernel with ``use_fused_smpl``; its backward differentiates the composed
SMPL forward, as the JAX custom VJP does), then every loss is computed.

The two optimizers take ONE forward and ONE backward:

    total = e_loss(params_e, detached params_d)
          + d_loss(detached fakes, params_d)

so the gradient of ``total`` in the encoder's parameters is the encoder's
gradient (the discriminator is a frozen critic) and in the discriminator's
parameters the discriminator's (the fakes are detached). Two Adams
(optax's hyperparameters) then step; every parameter's gradient is zeroed,
never set to None, so each gets Adam's step every time, as with optax.

The fp32 step runs without TF32 (``utils.precision.full_fp32``). With
``use_bfloat16`` the HMMR network runs on bf16 casts of the fp32
parameters inside the autograd graph; SMPL, the losses and the
discriminator stay fp32. Dropout draws its masks from a generator seeded
from (``config.seed``, step), the counterpart of JAX's
``fold_in(rng, step)``.

Checkpoints are npz files in the JAX package's flat layout (flax paths
joined with '::'): ``params_e::params::...``, ``params_d::params::...``,
``step`` and, unless ``save_params_only``, the Adam moments under
``opt_state_{e,d}::mu::<flax path>``, ``::nu::`` and ``::count``; the JAX
``load_checkpoint`` and the port's ``eval.harness.load_model_variables``
both read them.

In image mode the step runs the ResNet with train-mode BatchNorm (batch
statistics, unless ``freeze_bn_stats``) and advances its moving averages
once per step, in fp32 under ``use_bfloat16`` too (the bf16 casts cover the
parameters, not the buffers); ``remat_resnet`` checkpoints each bottleneck
unit. ``freeze_phi`` leaves the whole ResNet out of the gradient and of
Adam, ``freeze_resnet_stages`` = n its root and blocks 1..n-1; as the
images take no gradient, no backward runs below the first trainable
stage. The moving averages are ``batch_stats`` in the checkpoints. With
``use_bfloat16`` and ``freeze_bn_stats`` the inference-mode BatchNorm meets
fp32 moving averages, and flax promotes: the trunk after the root conv and
the whole model after it compute in fp32 on the bf16-rounded parameters.

Data parallelism (``Trainer(..., mesh=make_mesh(W))``, one process per
device) computes what GSPMD makes of the JAX step on a replicated state and
a ``shard_batch``ed batch. Each rank steps on its block of the global batch
(``config.batch_size`` stays the global size, so a loss's scale and the
learning rate do not depend on W): its rows through one forward and one
SMPL decode, each loss as its share of the global one (``train.losses``
with the mesh), dropout masks drawn at the global shape, train-mode
BatchNorm on every rank's frames. The one backward is followed by one
``all_reduce`` of every gradient of both models
(``parallel.mesh.sum_gradients``), so both Adams take the global gradient
and every rank ends the step with the same parameters, moments and moving
averages, bit for bit. With one rank the step is the single-process one.

2-D training (``mesh=make_mesh_2d(d, t)``, a ``shard_batch_2d``ed batch)
splits each tube's T frames over ``time`` too; the batch axes are then
(data, time), over which every count, BatchNorm moment, metric and
gradient is summed. The temporal encoder runs on the rank's frames with
1-frame halos and clip-global GroupNorm (``parallel.halo``). The ±dt heads
pair the prediction at frame t with the ground truth at t + dt, which may
lie on another rank: the ground truth (no gradient) is gathered whole over
the rank's time row, and a pair outside the clip carries weight 0 in every
loss and count. ``e_const`` takes the next rank's first betas with their
gradient by a halo. ``shard_batch_2d`` leaves the mocap pool whole, so
each rank takes its 1/(d·t) block of it.

Tensor parallelism (``mesh=make_mesh_tp(d, m)``, then
``trainer.state = parallel.shard_params_tp(trainer.state, mesh)`` and
``shard_batch``ed batches) keeps each wide weight's slice of output
features on each model rank (``parallel.tp``). Every model rank of a data
row holds the same rows and computes the same losses; the batch axis is
``data`` alone. ``save`` gathers the whole tensors first and
``maybe_restore`` shards what it loads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from human_dynamics_tpu_torch.core.projection import orth_proj_idrot
from human_dynamics_tpu_torch.core.rotations import rodrigues
from human_dynamics_tpu_torch.core.smpl import SmplModel
from human_dynamics_tpu_torch.infer.predictor import resolve_device
from human_dynamics_tpu_torch.models.discriminator import PoseDiscriminator
from human_dynamics_tpu_torch.models.hmmr import (
    HmmrModel,
    HmmrOutputs,
    resolve_mean_omega,
)
from human_dynamics_tpu_torch.models.omega import (
    OmegaGt,
    compute_smpl,
    split_omega,
)
from human_dynamics_tpu_torch.models.resnet import updating_batch_stats
from human_dynamics_tpu_torch.ops.smpl_cuda import (
    FusedSmplConstants,
    prepare_fused_constants,
)
from human_dynamics_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    TIME_AXIS,
    Mesh,
    all_sum,
    assemble,
    barrier,
    broadcast_tensors,
    sum_gradients,
)
from human_dynamics_tpu_torch.parallel.tp import gathered, is_sharded
from human_dynamics_tpu_torch.train import losses as L
from human_dynamics_tpu_torch.utils.checkpoint import (
    checkpoint_top_keys,
    flatten_tree,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from human_dynamics_tpu_torch.utils.config import Config
from human_dynamics_tpu_torch.utils.precision import full_fp32, to_bf16
from human_dynamics_tpu_torch.utils.weights import (
    export_jax_variables,
    jax_to_port,
    load_jax_variables,
    variable_map,
)

TrainConfig = Config  # the single Config drives training too

_RESNET = "resnet_v2_50."
_ROOT_CONV = _RESNET + "conv1."


class Batch(NamedTuple):
    """One training minibatch (tensors on the trainer's device; the data
    pipeline yields it as numpy arrays).

    phis (B, T, feature_dim), or images (B, T, S, S, 3) in [-1, 1] in image
    mode; kps (B, T, K, 3) with visibility; poses_gt
    (B, T, 24, 3) axis-angle; shapes_gt (B, 10); joints_gt (B, T, 14, 3);
    has_3d_joints, has_3d_smpl (B,) float flags; poses_real: the mocap pool
    for the adversarial prior, (P, 24, 3) axis-angle or (P, 24, 3, 3)
    rotations, P = fake_pool_size(config).
    """

    phis: torch.Tensor
    kps: torch.Tensor
    poses_gt: torch.Tensor
    shapes_gt: torch.Tensor
    joints_gt: torch.Tensor
    has_3d_joints: torch.Tensor
    has_3d_smpl: torch.Tensor
    poses_real: torch.Tensor


@dataclasses.dataclass
class TrainState:
    """The models, their optimizers and the number of steps taken."""

    hmmr: HmmrModel
    disc: PoseDiscriminator
    opt_e: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0


def fake_pool_size(config: Config) -> int:
    """Fakes fed to the discriminator per step: B*T poses for the present
    head, each delta head and the hallucinator's heads; the real pool has
    the same size."""
    bt = config.batch_size * config.T
    num_heads = 1
    if config.predict_delta:
        num_heads += len([d for d in config.delta_t_values if d != 0])
    if config.do_hallucinate:
        num_heads += 1
        if config.do_hallucinate_preds:
            num_heads += len([d for d in config.delta_t_values if d != 0])
    return bt * num_heads


def build_models(config: Config, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[HmmrModel, PoseDiscriminator]:
    """The HMMR model (with the ResNet unless ``precomputed_phi``) and the
    discriminator on ``device`` (None: the CUDA device, raising without
    one), initialised from ``generator``."""
    device = resolve_device(device)
    hmmr = HmmrModel(
        num_conv_layers=config.num_conv_layers,
        delta_t_values=tuple(config.delta_t_values),
        predict_delta=config.predict_delta,
        do_hallucinate=config.do_hallucinate,
        do_hallucinate_preds=config.do_hallucinate_preds,
        use_hmr_only=config.use_hmr_only,
        num_stage=config.num_stage,
        use_delta_from_pred=config.use_delta_from_pred,
        include_resnet=not config.precomputed_phi,
        remat_resnet=config.remat_resnet,
        freeze_bn_stats=config.freeze_bn_stats,
        feature_dim=config.feature_dim,
        mean_omega_init=resolve_mean_omega(config.smpl_mean_path),
        device=device,
        generator=generator,
    )
    disc = PoseDiscriminator(device=device, generator=generator)
    return hmmr, disc


def create_train_state(config: Config, device=None,
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """Models on ``device`` initialised from ``generator``, and two fresh
    Adams; frozen parameters take no gradient and no optimizer state."""
    hmmr, disc = build_models(config, device, generator)
    trainable, frozen = split_frozen_params(
        config, dict(hmmr.named_parameters()))
    for p in frozen.values():
        p.requires_grad_(False)
    opt_e, opt_d = make_optimizers(config, trainable.values(),
                                   disc.parameters())
    return TrainState(hmmr=hmmr, disc=disc, opt_e=opt_e, opt_d=opt_d)


def split_frozen_params(config: Config, params_e: Dict[str, torch.Tensor]):
    """(trainable, frozen) split of the encoder's named parameters.

    ``freeze_phi`` freezes the whole ResNet; else ``freeze_resnet_stages``
    = n freezes its root conv and blocks 1..n-1. Without a ResNet (phi
    mode) everything is trainable.
    """
    has_resnet = any(k.startswith(_RESNET) for k in params_e)
    if config.freeze_phi and has_resnet:
        is_frozen = lambda k: k.startswith(_RESNET)
    elif config.freeze_resnet_stages and has_resnet:
        prefixes = ("conv1.",) + tuple(
            f"block{bi}." for bi in range(1, config.freeze_resnet_stages))
        is_frozen = lambda k: (k.startswith(_RESNET)
                               and k[len(_RESNET):].startswith(prefixes))
    else:
        return dict(params_e), {}
    trainable = {k: v for k, v in params_e.items() if not is_frozen(k)}
    frozen = {k: v for k, v in params_e.items() if is_frozen(k)}
    return trainable, frozen


def merge_frozen_params(trainable: Dict[str, torch.Tensor],
                        frozen: Dict[str, torch.Tensor]):
    """Inverse of split_frozen_params."""
    return {**trainable, **frozen}


def make_optimizers(config: Config, params_e, params_d):
    """Two Adams with optax's (TF's) hyperparameters."""
    opt_e = torch.optim.Adam(list(params_e), lr=config.e_lr,
                             betas=(0.9, 0.999), eps=1e-8)
    opt_d = torch.optim.Adam(list(params_d), lr=config.d_lr,
                             betas=(0.9, 0.999), eps=1e-8)
    return opt_e, opt_d


# ---------------------------------------------------------------------------
# The objective
# ---------------------------------------------------------------------------


def loss_weight_table(config: Config) -> Dict[str, float]:
    """Loss name -> weight; compute_losses's weighted sums and the
    loss-proportion report both read it."""
    weights = {
        "d_pose": config.d_lw_pose,
        "e_const": config.e_lw_const,
        "e_pose": config.e_lw_pose,
        "e_shape": config.e_lw_shape,
        "e_hallucinate": config.e_lw_hallucinate,
    }
    for suffix in ("", "_static", "_dt_future", "_dt_past", "_hal",
                   "_hal_dt_future", "_hal_dt_past"):
        weights["e_kp" + suffix] = config.e_lw_kp
        weights["e_joints" + suffix] = config.e_lw_joints
        weights["e_smpl" + suffix] = config.e_lw_smpl
    return weights


def _delta_pairs(dt: int, t0: int, t: int, total: int, device):
    """The ground-truth frame of each of the frames t0 .. t0+t-1 of a dt
    head, and whether the pair lies in the clip: the prediction at frame
    f meets the ground truth at f + dt (past heads pred[|dt|:] with
    gt[:dt], future heads pred[:-dt] with gt[dt:]). Out-of-clip frames
    point at the clip's edge frame, so that their (weight 0) terms stay
    finite."""
    frames = torch.arange(t0, t0 + t, device=device) + dt
    valid = ((frames >= 0) & (frames < total)).float()
    return frames.clamp(0, total - 1), valid


def _gt_over_time(batch: "Batch", mesh: Optional[Mesh]):
    """(kps, poses_gt, joints_gt) of this rank's tubes over the whole clip,
    the first frame's index and the clip's length: on a mesh with a
    ``time`` axis gathered over the rank's time row (one ``all_reduce``),
    else the batch's own."""
    t = batch.kps.shape[1]
    if mesh is None or TIME_AXIS not in mesh.shape:
        return batch.kps, batch.poses_gt, batch.joints_gt, 0, t
    parts = {"kps": batch.kps, "poses": batch.poses_gt,
             "joints": batch.joints_gt}
    total = t * mesh.shape[TIME_AXIS]
    t0 = mesh.index(TIME_AXIS) * t
    whole = assemble(parts, (batch.kps.shape[0], total),
                     (slice(None), slice(t0, t0 + t)), mesh, TIME_AXIS)
    return whole["kps"], whole["poses"], whole["joints"], t0, total


def _real_pool(batch: "Batch", mesh: Optional[Mesh]) -> torch.Tensor:
    """The mocap pool this rank's discriminator loss takes: its block of
    the pool on a mesh with a ``time`` axis (``shard_batch_2d`` leaves the
    pool whole on every rank), else the batch's."""
    pool = batch.poses_real
    if mesh is None or TIME_AXIS not in mesh.shape:
        return pool
    parts = mesh.axis_size(mesh.batch_axes)
    if pool.shape[0] % parts:
        raise ValueError(f"the mocap pool of {pool.shape[0]} poses is not "
                         f"divisible by the mesh's {parts} batch ranks")
    k = pool.shape[0] // parts
    return pool[mesh.index(mesh.batch_axes) * k:][:k]


def _outputs_f32(out: HmmrOutputs) -> HmmrOutputs:
    def cast(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: x.float() for k, x in v.items()}
        return v.float()

    return HmmrOutputs(*[cast(v) for v in out])


def _bf16_params(config: Config, hmmr: HmmrModel) -> Dict[str, torch.Tensor]:
    """The parameters a bf16 step applies, cast inside the autograd graph.

    The buffers (BatchNorm's moving averages) stay the module's own fp32
    tensors. Under ``freeze_bn_stats`` the ResNet's BatchNorms normalise
    with them, and flax promotes: the first one's output is fp32, and every
    layer after the root conv computes in fp32 on its bf16 parameters
    upcast. So those parameters come as bf16 roundings in fp32.
    """
    params = to_bf16(dict(hmmr.named_parameters()))
    if config.freeze_bn_stats and hmmr.include_resnet:
        params = {k: v if k.startswith(_ROOT_CONV) else v.float()
                  for k, v in params.items()}
    return params


def compute_losses(
    config: Config,
    hmmr: HmmrModel,
    disc: PoseDiscriminator,
    smpl: SmplModel,
    batch: Batch,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    fused_constants: Optional[FusedSmplConstants] = None,
    mesh: Optional[Mesh] = None,
):
    """Returns (e_loss, d_loss, metrics dict of every loss and both sums).

    ``train`` turns the IEF dropout on (masks from ``generator``) and, in
    image mode, the ResNet's train-mode BatchNorm, whose moving averages
    advance in place. ``fused_constants`` (only with ``use_fused_smpl``) are the fused
    kernel's constants, prepared once by the caller. With a ``mesh``
    ``batch`` is this rank's block of the global batch, and every loss and
    metric is this rank's share of the global batch's (the ranks' shares
    sum to it); its fake pool is its own rows of every head and its real
    pool its block of ``poses_real``. A ``time`` axis splits each tube's
    frames too (the module docstring).
    """
    b, t = batch.phis.shape[:2]
    kwargs = {"train": train, "generator": generator, "mesh": mesh}
    with (updating_batch_stats(hmmr) if train else contextlib.nullcontext()):
        if config.use_bfloat16:
            out = _outputs_f32(functional_call(
                hmmr, _bf16_params(config, hmmr),
                (batch.phis.to(torch.bfloat16),), kwargs,
            ))
        else:
            out = hmmr(batch.phis, **kwargs)

    kps_all, poses_all, joints_all, t0, total = _gt_over_time(batch, mesh)
    gt_all = OmegaGt.create(poses_all, batch.shapes_gt, joints_all, kps_all)
    gt = gt_all.at_frames(slice(t0, t0 + t))

    # Every head in ONE SMPL decode.
    heads = [("pred", 0, out.omega_pred)]
    for dt in sorted(out.omegas_delta):
        heads.append(("dt", dt, out.omegas_delta[dt]))
    if out.omega_hal is not None:
        heads.append(("hal", 0, out.omega_hal))
        for dt in sorted(out.omegas_hal_delta):
            heads.append(("hal_dt", dt, out.omegas_hal_delta[dt]))
    stacked = torch.stack([h[2] for h in heads])          # (H, B, T, 85)
    sm = compute_smpl(
        smpl, stacked, use_optcam=True, want_verts=False,
        fused=config.use_fused_smpl,
        fused_constants=fused_constants if config.use_fused_smpl else None,
    )

    losses: Dict[str, torch.Tensor] = {}
    fake_poses, fake_shapes = [], []
    static_mode = config.use_hmr_only and not config.do_hallucinate

    def acc(key, val):
        losses[key] = losses[key] + val if key in losses else val

    for idx, (kind, dt, raw) in enumerate(heads):
        cams, _, shapes = split_omega(raw)
        fake_poses.append(sm.poses_rot[idx].reshape(-1, 24, 9))
        fake_shapes.append(shapes.reshape(-1, 10))
        if dt == 0:
            pair, valid, rows = gt, None, 1.0
        else:
            frames, valid = _delta_pairs(dt, t0, t, total, raw.device)
            pair = gt_all.at_frames(frames)
            rows = valid.repeat(b)

        if kind in ("pred", "hal"):
            # Own camera: project the joints with the predicted cam.
            kps_pred = orth_proj_idrot(
                sm.joints[idx].reshape(b * t, -1, 3), cams.reshape(b * t, 3)
            ).reshape(b, t, -1, 2)
            loss_kp = L.keypoint_l1_loss(gt.kps, kps_pred, mesh)
        else:
            loss_kp, _ = L.keypoint_l1_loss_optcam(
                pair.kps, sm.kps[idx], mesh, valid)

        if config.use_3d_label:
            lp, ls, lj = L.loss_3d(
                poses_gt=pair.poses_rot,
                poses_pred=sm.poses_rot[idx],
                shapes_gt=gt.shapes_tiled(t),
                shapes_pred=shapes,
                joints_gt=pair.joints,
                joints_pred=sm.joints[idx][..., :14, :],
                has_gt3d_smpl=torch.repeat_interleave(batch.has_3d_smpl,
                                                      t) * rows,
                has_gt3d_joints=torch.repeat_interleave(batch.has_3d_joints,
                                                        t) * rows,
                mesh=mesh,
            )
        else:
            lp = ls = lj = torch.zeros((), device=raw.device)

        suffix = {
            # The HMR-only ablation without hallucination names its keys
            # *_static.
            ("pred", True): "_static" if static_mode else "",
            ("hal", True): "_hal",
        }.get((kind, dt == 0))
        if suffix is None:
            base = "_dt" if kind == "dt" else "_hal_dt"
            suffix = base + ("_future" if dt > 0 else "_past")
        acc("e_kp" + suffix, loss_kp)
        acc("e_joints" + suffix, lj)
        acc("e_smpl" + suffix, lp + ls)

    if not static_mode:
        losses["e_const"] = L.beta_smoothness_loss(
            split_omega(out.omega_pred)[2], mesh)
    if out.hal_strip is not None:
        losses["e_hallucinate"] = L.hallucinator_mse(out.movie_strip,
                                                     out.hal_strip, mesh)

    # Adversarial prior, without the global rotation: E meets a frozen
    # critic, D meets detached fakes.
    poses_fake = torch.cat(fake_poses)                    # (F, 24, 9)
    shapes_fake = torch.cat(fake_shapes)
    pool = _real_pool(batch, mesh)
    if pool.dim() == 3 and pool.shape[-1] == 3:
        poses_real = rodrigues(pool).reshape(-1, 24, 9)
    else:
        poses_real = pool.reshape(-1, 24, 9)
    fake_in, real_in = poses_fake[:, 1:], poses_real[:, 1:]
    critic = {k: v.detach() for k, v in disc.named_parameters()}
    out_fake_for_e = functional_call(disc, critic, (fake_in,))
    disc_out = disc(torch.cat([real_in, fake_in.detach()]))
    out_real, out_fake_for_d = disc_out.split([len(real_in), len(fake_in)])

    losses["e_pose"] = L.lsgan_encoder_loss(out_fake_for_e, mesh)
    losses["d_pose"] = (L.lsgan_disc_fake_loss(out_fake_for_d, mesh)
                        + L.lsgan_disc_real_loss(out_real, mesh))
    losses["e_shape"] = L.shape_prior_loss(shapes_fake, mesh)

    weights = loss_weight_table(config)
    e_loss = torch.zeros((), device=poses_fake.device)
    d_loss = torch.zeros((), device=poses_fake.device)
    for key, val in losses.items():
        if key.startswith("e"):
            e_loss = e_loss + weights[key] * val
        else:
            d_loss = d_loss + weights[key] * val
    metrics = dict(losses, e_loss=e_loss, d_loss=d_loss)
    return e_loss, d_loss, metrics


def _zero_grads(opt: torch.optim.Optimizer) -> None:
    """Every parameter's gradient to a zero tensor (not None)."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()


def _global_metrics(metrics: Dict[str, torch.Tensor],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every rank's shares of the metrics summed over the batch axes, in
    one ``all_reduce``."""
    names = list(metrics)
    flat = all_sum(torch.stack([metrics[k].detach().float() for k in names]),
                   mesh, mesh.batch_axes)
    return dict(zip(names, flat.unbind()))


def train_step(
    config: Config,
    state: TrainState,
    smpl: SmplModel,
    batch: Batch,
    generator: torch.Generator,
    fused_constants: Optional[FusedSmplConstants] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, torch.Tensor]:
    """One simultaneous E/D update of ``state`` in place; returns the
    metrics as detached device scalars (no host sync). With a ``mesh``,
    ``batch`` is this rank's block; the gradients (sharded ones too) are
    summed over the ranks of the mesh's batch axes before the Adams step,
    and the metrics are the global losses."""
    with full_fp32():
        e_loss, d_loss, metrics = compute_losses(
            config, state.hmmr, state.disc, smpl, batch, train=True,
            generator=generator, fused_constants=fused_constants, mesh=mesh,
        )
        _zero_grads(state.opt_e)
        _zero_grads(state.opt_d)
        (e_loss + d_loss).backward()
    if mesh is not None:
        sum_gradients((state.hmmr, state.disc), mesh, mesh.batch_axes)
        metrics = _global_metrics(metrics, mesh)
    state.opt_e.step()
    state.opt_d.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Checkpoint layout of the optimizer state
# ---------------------------------------------------------------------------


def _opt_params(module: torch.nn.Module, opt: torch.optim.Optimizer):
    """(name, parameter) of ``module`` that ``opt`` steps."""
    stepped = {id(p) for g in opt.param_groups for p in g["params"]}
    return [(n, p) for n, p in module.named_parameters() if id(p) in stepped]


def _export_adam(module, opt) -> dict:
    """optax's ScaleByAdamState as a tree: mu and nu in flax paths, count."""
    mu, nu, count = {}, {}, 0
    for name, p in _opt_params(module, opt):
        s = opt.state.get(p)
        mu[name] = s["exp_avg"] if s else torch.zeros_like(p)
        nu[name] = s["exp_avg_sq"] if s else torch.zeros_like(p)
        count = int(s["step"]) if s else 0
    return {"mu": export_jax_variables(module, mu).get("params", {}),
            "nu": export_jax_variables(module, nu).get("params", {}),
            "count": np.int32(count)}


def _import_adam(module, opt, tree) -> None:
    named = _opt_params(module, opt)
    names = [n for n, _ in named]
    mu = jax_to_port(module, {"params": tree["mu"]}, names)
    nu = jax_to_port(module, {"params": tree["nu"]}, names)
    step = torch.tensor(float(np.asarray(tree["count"])), dtype=torch.float32)
    opt.state.clear()
    for name, p in named:
        opt.state[p] = {"step": step.clone(),
                        "exp_avg": mu[name].to(p.device),
                        "exp_avg_sq": nu[name].to(p.device)}


def _step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed at ``step``."""
    return (seed << 32) + step


class Trainer:
    """Owns the state, the step, logging and checkpoints.

    ``device`` None means the CUDA device (and raises without one), or the
    mesh's; the CPU runs only when asked for. With ``config.model_dir`` set,
    the newest checkpoint there is restored.

    With a ``mesh`` (one process per device, every one making the same
    calls) the Trainer is this rank's part of a sharded one: rank 0's
    state is broadcast at construction, ``step`` takes this rank's block of
    the global batch (``parallel.shard_batch``, or a pipeline of
    ``batch_size // W`` with ``host_id=rank``; ``shard_batch_2d`` on a
    (data, time) mesh), only rank 0 writes checkpoints and logs while the
    others wait, and every rank restores the same checkpoint.
    ``config.batch_size`` is the global batch, which the mesh's data axis
    must divide, as its time axis must divide ``config.T``. On a (data,
    model) mesh, ``parallel.shard_params_tp(trainer.state, mesh)`` shards
    the wide weights; every rank then also runs the summaries' forwards.
    """

    # SMPL joint names of the 23 per-joint discriminator heads.
    SMPL_JOINT_NAMES = (
        "Left_Hip", "Right_Hip", "Waist", "Left_Knee", "Right_Knee",
        "Upper_Waist", "Left_Ankle", "Right_Ankle", "Chest", "Left_Toe",
        "Right_Toe", "Base_Neck", "Left_Shoulder", "Right_Shoulder",
        "Upper_Neck", "Left_Arm", "Right_Arm", "Left_Elbow",
        "Right_Elbow", "Left_Wrist", "Right_Wrist", "Left_Finger",
        "Right_Finger",
    )

    def __init__(self, config: Config, smpl: SmplModel, data_iter=None,
                 logger=None, device=None, mesh: Optional[Mesh] = None):
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            for axis, size in ((DATA_AXIS, config.batch_size),
                               (TIME_AXIS, config.T)):
                parts = mesh.shape.get(axis, 1)
                if size % parts:
                    raise ValueError(
                        f"{'batch_size' if axis == DATA_AXIS else 'T'} "
                        f"{size} is not divisible by the mesh's {axis!r} "
                        f"axis of {parts} ranks")
            device = mesh.device if device is None else device
        self.device = resolve_device(device)
        self.smpl = smpl.to(self.device)
        self.data_iter = data_iter
        self.logger = logger
        self.state = create_train_state(
            config, self.device,
            torch.Generator(device=self.device).manual_seed(config.seed),
        )
        if mesh is not None:
            broadcast_tensors(self.state_tensors(), mesh)
        self.fused_constants = (
            prepare_fused_constants(self.smpl) if config.use_fused_smpl
            else None
        )
        self.dropout_generator = torch.Generator(device=self.device)
        self.loss_weights = loss_weight_table(config)
        if config.model_dir:
            self.maybe_restore(config.model_dir)

    @property
    def is_lead(self) -> bool:
        """Whether this process writes checkpoints and logs: rank 0, or
        the only process."""
        return self.mesh is None or self.mesh.rank == 0

    def state_tensors(self):
        """Every parameter, buffer and Adam moment, in one order on every
        rank."""
        st = self.state
        out = [t for m in (st.hmmr, st.disc)
               for t in list(m.parameters()) + list(m.buffers())]
        for opt in (st.opt_e, st.opt_d):
            for p in opt.param_groups[0]["params"]:
                out += [v for v in opt.state.get(p, {}).values()
                        if torch.is_tensor(v) and v.dim()]
        return out

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def save(self) -> Optional[str]:
        """model_dir/ckpt-<step>.npz (its path), or None without a
        model_dir. Under a mesh rank 0 writes it (the whole tensors of a
        TP-sharded state) and every rank returns once it is written."""
        if not self.config.model_dir:
            return None
        st = self.state
        path = os.path.join(self.config.model_dir, f"ckpt-{st.step}.npz")
        with gathered(st):
            if self.is_lead:
                tree = {"params_e": export_jax_variables(st.hmmr),
                        "params_d": export_jax_variables(st.disc),
                        "step": np.int32(st.step)}
                if not self.config.save_params_only:
                    tree["opt_state_e"] = _export_adam(st.hmmr, st.opt_e)
                    tree["opt_state_d"] = _export_adam(st.disc, st.opt_d)
                path = save_checkpoint(path, tree)
        if self.mesh is not None:
            barrier(self.mesh)
        return path

    def maybe_restore(self, model_dir: str) -> bool:
        """Restore the newest checkpoint of ``model_dir``; a params-only
        one resets the Adam moments. A TP-sharded state keeps its slices of
        what it loads. False when there is none."""
        ckpt = latest_checkpoint(model_dir)
        if ckpt is None:
            return False
        full = "opt_state_e" in (checkpoint_top_keys(ckpt) or ())
        tree = load_checkpoint(ckpt)
        st = self.state
        with gathered(st):
            load_jax_variables(st.hmmr, tree["params_e"])
            load_jax_variables(st.disc, tree["params_d"])
            if full:
                _import_adam(st.hmmr, st.opt_e, tree["opt_state_e"])
                _import_adam(st.disc, st.opt_d, tree["opt_state_d"])
            else:
                st.opt_e.state.clear()
                st.opt_d.state.clear()
                print("Params-only checkpoint: optimizer moments reset")
        st.step = int(np.asarray(tree["step"]))
        print(f"Restored checkpoint {ckpt} (step {st.step})")
        return True

    def load_pretrained(self, path: str) -> None:
        """Warm start the encoder from an npz of HMMR variables (or a
        trainer checkpoint's params_e); variables the model lacks are
        skipped, as the reference restores by an explicit list."""
        tree = load_checkpoint(path)
        tree = tree.get("params_e", tree)
        names = {"::".join(key): name for name, (key, _)
                 in variable_map(self.state.hmmr).items()}
        leaves = flatten_tree(tree)
        skipped = sorted(set(leaves) - set(names))
        with gathered(self.state), torch.no_grad():
            values = jax_to_port(
                self.state.hmmr, tree,
                [names[k] for k in leaves if k in names], strict=False,
            )
            tensors = dict(self.state.hmmr.named_parameters())
            tensors.update(self.state.hmmr.named_buffers())
            for name, v in values.items():
                tensors[name].copy_(v)
        if skipped:
            print(f"load_pretrained: ignored {len(skipped)} vars absent "
                  f"from the model (e.g. {skipped[0]})")

    # ------------------------------------------------------------------
    # Summaries
    # ------------------------------------------------------------------

    @torch.no_grad()
    def render_summary(self, batch: Batch, max_frames: int = None):
        """The current predictions for the batch's first tube, rendered as
        a horizontal strip (img_size, img_size * k, 3) uint8 of the
        ``max_frames`` (``log_img_count``) middle frames: each panel the
        mesh on white (the SMPL faces, when the model has them) with the
        predicted keypoints' skeleton and the visible labelled keypoints
        over it. The present head is decoded by the fused SMPL kernel with
        ``use_fused_smpl``. The mesh is rasterized on the host."""
        from human_dynamics_tpu_torch.viz.renderer import VisRenderer
        from human_dynamics_tpu_torch.viz.skeleton import (
            draw_skeleton,
            normalized_kp_to_image,
        )

        max_frames = max_frames or self.config.log_img_count
        with full_fp32():
            out = self.state.hmmr(batch.phis[:1].to(self.device))
            sm = compute_smpl(
                self.smpl, out.omega_pred[:1], use_optcam=False,
                fused=self.config.use_fused_smpl,
                fused_constants=self.fused_constants,
            )
        t = out.omega_pred.shape[1]
        mid = t // 2
        idx = range(
            max(0, mid - max_frames // 2),
            min(t, mid + (max_frames + 1) // 2),
        )

        faces = self.smpl.faces
        img_size = self.config.img_size
        renderer = (
            VisRenderer(img_size=img_size, faces=faces)
            if faces is not None else None
        )
        panels = []
        verts = sm.verts[0].cpu().numpy()
        kps = sm.kps[0].cpu().numpy()
        cams = out.omega_pred[0, :, :3].cpu().numpy()
        gt_kps = batch.kps[0].cpu().numpy()
        for ti in idx:
            if renderer is not None:
                panel = renderer(verts[ti], cam=cams[ti])
            else:
                panel = np.full((img_size, img_size, 3), 255, np.uint8)
            panel = draw_skeleton(
                panel, normalized_kp_to_image(kps[ti], img_size)
            )
            panel = draw_skeleton(
                panel,
                normalized_kp_to_image(gt_kps[ti, :, :2], img_size),
                draw_edges=False,
                vis=gt_kps[ti, :, 2] > 0,
            )
            panels.append(panel)
        return np.concatenate(panels, axis=1)

    @torch.no_grad()
    def histogram_summary(self, batch: Batch) -> None:
        """Log beta and per-joint discriminator-output histograms; one
        extra forward at summary cadence. Under a mesh only rank 0 logs,
        so the histograms are of rank 0's rows of the global batch (every
        rank runs the forward of a TP-sharded state)."""
        if self.logger is None and not is_sharded(self.state):
            return
        step_no = self.state.step
        with full_fp32():
            out = self.state.hmmr(batch.phis)
            betas = split_omega(out.omega_pred)[2]
            poses_rot = rodrigues(
                split_omega(out.omega_pred)[1].reshape(-1, 24, 3)
            ).reshape(-1, 24, 9)
            d_out = self.state.disc(poses_rot[:, 1:]).cpu().numpy()
        if self.logger is None or not self.is_lead:
            return
        self.logger.log_histogram(step_no, "betas", betas.cpu().numpy())
        if out.omega_hal is not None:
            self.logger.log_histogram(
                step_no, "betas_hal",
                split_omega(out.omega_hal)[2].cpu().numpy())
        self.logger.log_histogram(step_no, "poses_out/all", d_out[:, 23])
        for i, name in enumerate(self.SMPL_JOINT_NAMES):
            self.logger.log_histogram(step_no, f"poses_out/{name}",
                                      d_out[:, i])

    # ------------------------------------------------------------------

    def step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One training step on a batch of tensors on the trainer's
        device (under a mesh, this rank's block of the global batch);
        returns device scalars, the global batch's losses."""
        self.dropout_generator.manual_seed(
            _step_seed(self.config.seed, self.state.step))
        return train_step(self.config, self.state, self.smpl, batch,
                          self.dropout_generator, self.fused_constants,
                          self.mesh)

    def train(self, num_steps: int,
              profile_steps: Optional[range] = None) -> Dict[str, float]:
        """``num_steps`` steps from ``data_iter`` with logging, summaries,
        loss proportions every 500 steps and checkpoints every
        ``save_step``; a ``torch.profiler`` trace of ``profile_steps``
        goes to model_dir/profile. Under a mesh only rank 0 logs, profiles
        and writes the loss proportions."""
        from human_dynamics_tpu_torch.utils.logging import (
            StepTimer,
            profile_trace,
            write_loss_proportions,
        )

        if self.data_iter is None:
            raise ValueError("Trainer.train needs a data_iter")
        metrics = {}
        timer = StepTimer()
        profiling = False
        # A TP-sharded forward is collective: every rank makes it.
        summarise = is_sharded(self.state) or (self.is_lead
                                               and self.logger is not None)
        with contextlib.ExitStack() as trace:
            for _ in range(num_steps):
                step_no = self.state.step
                if profile_steps is not None and self.is_lead:
                    if step_no == profile_steps.start and not profiling:
                        trace.enter_context(profile_trace(os.path.join(
                            self.config.model_dir or ".", "profile")))
                        profiling = True
                    if profiling and step_no >= profile_steps.stop:
                        trace.close()
                        profiling = False

                batch = next(self.data_iter)
                metrics = self.step(batch)
                timer.tick()
                step_no = self.state.step

                if self.is_lead and step_no % self.config.log_step == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    if self.logger is not None:
                        self.logger.log_scalars(step_no, m)
                    print(f"step {step_no}: e_loss={m['e_loss']:.4f} "
                          f"d_loss={m['d_loss']:.4f} "
                          f"({timer.mean_ms:.0f} ms/step)")
                if (summarise and self.config.log_img_step
                        and step_no % self.config.log_img_step == 0):
                    try:
                        strip = self.render_summary(batch)
                        if self.is_lead and self.logger is not None:
                            self.logger.log_image(step_no, "pred/strip",
                                                  strip)
                    except Exception as exc:  # vis must never kill training
                        print(f"render_summary failed: {exc}")
                    try:
                        self.histogram_summary(batch)
                    except Exception as exc:
                        print(f"histogram_summary failed: {exc}")
                if (self.is_lead and step_no % 500 == 0
                        and self.config.model_dir):
                    write_loss_proportions(
                        self.config.model_dir, step_no,
                        {k: float(v) for k, v in metrics.items()},
                        self.loss_weights,
                    )
                if (self.config.save_step
                        and step_no % self.config.save_step == 0):
                    self.save()
        return {k: float(v) for k, v in metrics.items()}

