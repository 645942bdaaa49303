#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is non-zero:

0. Device: a CUDA device must be present; print the card's name and power
   limit (nvidia-smi) and the torch and CUDA versions.
1. Build: compile the kernels of human_dynamics_tpu_torch/ops/csrc with
   nvcc (one process per source, all started together), or load them from
   the cache.
2. K1 (fused SMPL blend+skin, 3xTF32 on the tensor cores) against its
   plain PyTorch version on the card, at V=6890 and N = 1440, 37, 21, 1,
   24, 192, a training step's 640 and the predictor's own N, with matmul
   TF32 off: vertex planes (1e-5, fp32 class), verts, joints, j_posed, and
   one gradient; timed in turns with the plain version at the predictor's
   N (beside the blend GEMM alone through torch.matmul) and at N = 640.
3. The fp32 predictor end to end: full-width HmmrModel(include_resnet=True)
   with seeded random weights, a 480-frame clip of 224x224 uint8 frames,
   use_fused_smpl=True against use_fused_smpl=False; shapes, finiteness,
   agreement and K1's launch count.
4. The int8 trunk at 120 frames of 224x224, static scales calibrated on
   32 frames: apply_int8_static(use_pallas=True), K2's path, with its
   launch counts (one K2 launch per unit: 11 per chunk; the conv and
   standalone pre-activation launches of the units K2 does not take and
   none more), against use_pallas=False and both against the fp32 trunk.
   Every int8 conv and standalone pre-activation call of the
   use_pallas=False run (52 convs, 15 of them with the next unit's
   pre-activation fused in, and 1 standalone pre-activation) and every K2
   chain of the use_pallas=True run is recorded and replayed: the kernel
   against its plain version (int32 accumulators, outputs and fused
   pre-activations equal; K2 within 0.1% differing elements and rel L2
   1e-3, printed equal or not), and timed with CUDA events, kernel and
   plain version in turns (K2 also in turns with the same units run as
   the int8 conv's composition, conv_s8 calls built here, per geometry
   beside its chain bound and its per-unit byte floor)
   (per call with the wrapper's host time, as the trunk meets it), the conv
   also on the device alone (its launches queued behind a spin kernel: the
   conv's "ms"); a per-geometry table with each conv's path and tile;
   torch._int_mm is timed beside the 1x1 stride-1 convs.
5. The predictor in the JAX bench configuration (int8_encoder + 32
   calibration frames + bf16_temporal + use_fused_smpl) and with
   bf16_encoder, on the 480-frame clip: shapes, finiteness, omegas within
   0.5 of the fp32 predictor, launch counts per clip of K1, the int8 conv
   (52 per 120-frame chunk, 36 of them on the TMA path) and the standalone
   pre-activation (1 per chunk).
6. Smoke timing of the fp32, bf16_encoder and int8 bench predictors, in
   turns. With --profile, a torch.profiler breakdown of one int8 clip
   (and, in phase 8, of one B=1 emission of each configuration).
7. Streaming, bench config (B=8): the 480-frame clip fed to a
   StreamingPredictor in pieces of 1, 7, 37 and 64 frames, then flushed;
   the emissions against predict_all_images (keys, shapes, omegas within
   the bound below), K1 once per emission, 52 int8 convs and 1 standalone
   pre-activation per encoder call; every int8 conv and pre-activation
   call of the stream's encoder (70, 64 and 26 frames) against its plain
   version.
8. Streaming latency at B=1 (quantum 8, latency_frames 14), bench config
   and fp32: one frame per feed, each feed synchronised; the first
   emission's wall time and the median and quartiles of the next
   emissions'; the bench config's int8 calls at 14 and 8 frames against
   their plain versions.
9. Service: 4 threads each submit a 480-frame clip to a
   PredictionService(bench) while an open_stream session feeds a fifth;
   every result equal to a direct call, the stream's within the streaming
   bound, the stats and launch counts add up; frames/s through the service
   and by direct calls.
10. Evaluation: an h36m and a 3dpw test record of 200 frames each, written
   with the port's data/schema and data/tfrecord, phis from the port's
   bf16 encoder; Evaluator.run in the --fast configuration with
   device_metrics on and off on h36m (agreeing at the CPU test's
   tolerance) and on, mesh errors included, on 3dpw (every metric
   finite); ms per tube for both modes.
11. TF32: a full-width model built on the CPU from a seeded generator, the
   fp32 predictor on 40 frames on the CPU against the card, with cuDNN's
   allow_tf32 on and off, and on without the predictor's guard that runs
   its fp32 modules without TF32 (as it ran before the guard): max abs
   error of omegas, joints and verts; the guarded runs within 1e-4 on
   omegas.
12. Training, phi mode, at full width: Config(batch_size=8, T=20,
   feature_dim=2048, num_kps=25, use_fused_smpl=True), random weights from
   config.seed, a batch made on the card from a seeded generator.
   compute_losses(train=False) and the gradients of e_loss + d_loss fused
   against unfused (every loss and every parameter's gradient within
   GRAD_ATOL/GRAD_RTOL) and the card against the same state on the CPU
   (losses within 1e-5 relative, gradients within 1e-3 relative in L2, and
   the Linear outputs whose sign differs counted); K1 once per fused
   step and never per unfused step; 20 Trainer.steps on the batch with
   every loss finite and e_loss falling; train.main for 3 steps on phi
   and mocap records written with the port's data/schema, then a fresh
   Trainer restores ckpt-3.npz with equal parameters and moments, and the
   checkpoint drives HmmrPredictor on the card; smoke timing of fp32
   fused, fp32 unfused and use_bfloat16 fused steps in turns, each step's
   device-memory increment. With --profile, a torch.profiler breakdown of
   one fused step with K1's share.
13. Training, image mode, at full width: Config(batch_size=8, T=20,
   img_size=224, precomputed_phi=False, feature_dim=2048, num_kps=25,
   use_fused_smpl=True), ResNet-50 v2 and the HMMR model with random
   weights from config.seed, one batch of 256x256 uint8 frames made on the
   card and put through data.augment.augment_batch there (which is held to
   its CPU run on the same parameters). One step each of (a) freeze_phi
   fp32 (TF32 off), (b) freeze_phi=False bf16, (c) (b) with remat_resnet,
   (d) freeze_resnet_stages=3 bf16: every loss finite, K1 once per step,
   every moving average advanced, the frozen tensors (all of the ResNet
   under (a), its root and blocks 1-2 under (d)) unchanged and without
   Adam moments, every other one stepped; (c) against (b): the same
   losses and moving averages. Then (a), (b), (c) timed in turns, each
   step's device memory above the resident state, K1 launches over the
   timed steps, e_loss falling over (b)'s steps; the card against the
   same state on the CPU at B=1, T=8, 224x224, every head, fp32 (losses,
   moving averages, gradients, ReLU sign flips counted); train.main on
   raw_u8 records for 2 bf16 steps. With --profile, a breakdown of one
   (a) and one (b) step.
14. Multi-GPU inference, at full width (HmmrModel(include_resnet=True),
   synthetic_smpl_model(6890, 25), B=8, T=20, the bench config of phase 5
   and an fp32 predictor): first world 1 on NCCL in this process, then two
   ranks sharing the card over gloo (and NCCL over every card where two or
   more are visible) as subprocesses of this script (--mesh-worker), each
   rank failing the phase. On every world: predict_all_images_sharded on
   the 480-frame clip's features (fp32 tail within 2e-5 of
   predict_all_images, bf16 tail within the streaming bound) and on its
   uint8 frames (rank 0 encodes), with every rank's launch counts and K1
   held to its plain version on the operands it got; predict_clip_sharded
   on a 1000-frame clip and predict_clips_sharded_2d on a (1, W) mesh
   against the unsharded full-clip forward (HALO_TOL); PredictionService
   (mesh, both modes, rank 0 serving, the others following) equal to the
   direct sharded calls. World 1 also times sharded against direct, the
   halo clip against the unsharded forward, and the service with a mesh
   against direct calls.
15. Data-parallel training, at full width (feature_dim 2048, every head,
   synthetic_smpl_model(6890, 25), global B=8, T=20): first world 1 on
   NCCL in this process, phi fp32 fused, image (b) the whole trunk in bf16
   and (a) freeze_phi fp32 on 160 frames of 224x224: Trainer(mesh=) against
   the plain Trainer.step from the same state and batch for 3 steps with
   deterministic algorithms (the first step's losses equal and gradients
   within 1e-4 of each parameter's largest; the losses within 1e-6 and
   every parameter, moving average and Adam moment within 1e-5 relative
   L2; a second plain Trainer with the default algorithms beside it), K1
   once per DP step, and both timed in turns; K1 at a rank's
   N = 320 against its plain version. Then two ranks sharing the card over
   gloo as subprocesses (--dp-worker): 2 phi steps and 1 image (b) step on
   each rank's block, the ranks' states equal after each step (an
   all_reduce of their differences from rank 0's), rank 0 against the
   world-1 step on the global batch (bounds at DP_LOSS_RTOL and below),
   K1 once per rank per step at N = 320 held to its plain version; then
   python -m human_dynamics_tpu_torch.train.main as two processes sharing
   the card (the HD_TPU_* variables, --backend gloo) for 3 steps on phi
   records written here (2 shards per dataset), rank 0 writing the one
   checkpoint, which a single-process Trainer restores.
16. The video demo (infer.demo) on in-memory uint8 frames, at full width
   (the phase-2 model, synthetic_smpl_model(6890, 25), B=8, T=20): a
   PoseFlow JSON of one person walking through 240 frames of 720x1280,
   missing in 3 of them. preprocess_track on the card against the CPU
   (float32 crops within 2^-23, the float64 resize of 3 frames within
   1e-9, start points and shapes equal);
   predict_on_tracks with the demo's fp32 predictor and its --fast one
   (bf16 encoder, fused SMPL), in turns: K1 once per --fast track and
   never for fp32, the pkl's keys, shapes and dtypes those of the JAX
   demo, a rerun reusing the pkl; the fp32 omegas of a 40-frame track
   within 1e-5 of the same call on the CPU; the native rasterizer against
   its numpy plain version on a crop, an original-frame and a rotated
   panel of a UV sphere of 6890 vertices and 13776 faces (masks equal, RGB
   within 1e-5), each timed on the host; where cv2 is importable,
   render_preds and make_video on the 40-frame track (the sphere in place
   of the synthetic SMPL's vertices); K1 at the track's N against its
   plain version and timed.
17. The dataset tools (datasets/, at full width: the phase-2 model's
   ResNet-50 v2, synthetic_smpl_model(6890, 25)): 150 JPEG frames of
   720x1280 with demo_person's keypoints. FeatureExtractor (batch 64) on the
   card against the same extractor on the CPU on 24 augmented crops (phis
   within 1e-4 relative L2 per frame); TubeConverter.write_tubes on the
   card for the 150-frame tube and a 24-frame one into one shard, the short
   tube's record held to the same converter on the CPU (the same draws,
   labels within 1e-4, phis as above, every other field equal), a rerun
   skipping the shard; ms per 150-frame tube split into host crops,
   augmentation on the card, phis and the record's encoding and write,
   with the frames read and cropped by 1 thread and by the converter's
   workers in turns, and the phis' frames/s at batch 64; the shard (and
   mocap records from datasets.mocap) through the phi-mode
   TrainDataPipeline into one full-width Trainer.step (losses finite, K1
   once); fit_neutral_shape against a known beta on the card (the first
   100 Adam steps within 1e-4 of the CPU's; the fit within 0.05 of the
   beta with loss < 1e-4, its iterations and ms per iteration); a test
   record of the 150 frames read back (224 crops, N = 150).
18. 2-D (data x time) and tensor-parallel training, at full width (phase
   15's phi fp32 fused configuration and image (b)): first world 1 on NCCL
   in this process, a Trainer on make_mesh_2d(1, 1) with shard_batch_2d
   and one on make_mesh_tp(1, 1) after shard_params_tp, each against the
   plain Trainer.step from the same state and batch for 2 steps, in turns
   (losses within DP_LOSS_RTOL, the first step's gradients within
   TRAIN_GRAD_REL per parameter; K1 once per step on each path, its count
   set to 0 just before each path's step and read just after), and the
   three timed in turns. Then two ranks sharing the card over gloo as
   subprocesses (--sharded-worker): 2 phi steps on a 1x2 2-D mesh (K1 at
   N = 320 on each rank) and 2 on a 1x2 TP mesh (N = 640), the ranks'
   states (a TP state gathered whole) equal after each step, rank 0
   against the world-1 step on the global batch, K1 held to its plain
   version on each rank's operands; one image (b) 1x2 2-D step by phase
   15's bf16 rules. K1 at the 2-D and TP ranks' N against its plain
   version, timed in turns, with its bound.

19. The closed loop (human_dynamics_tpu_torch.scripts.synthetic_gauntlet,
   phi mode) at full width: the generator's records written on the card
   against the same call on the CPU at a small size (numpy-made fields
   equal, SMPL-derived ones within 1e-5 of their scale, image mode where
   cv2 is there), then run_gauntlet with feature 2048, 64 train and 8 test
   tubes of 120 frames, B=8, T=20, --fused, 500 steps checkpointed every
   250: every metric finite, kp and joints at the last checkpoint below the
   untrained baseline's, the demo pkl's keys and frame_range, the results
   JSON and the report; K1's launches over the whole run equal to one per
   fused step, one per tube the evaluator predicts and one for the demo
   (and no int8 kernel launched); K1 against its plain version on the
   operands the run gave it at a training step's N and a tube's, timed in
   turns with its bound; the loop's wall time, ms per training step, and
   the phi loader alone on the loop's records (ms per batch).

20. The int8 root stems and the int8 residual stream, at full width: the
   static int8 trunk on 120 frames of 224x224 with int8_root True, "wfold"
   and "u8" (on the uint8 frames), int8_stream=True, int8_root=True with
   int8_stream=(1,), and use_pallas=True with int8_stream=(1,) (a streamed
   block 1 handing over to K2), each run's launches of the stem, the int8
   pool, K2, the standalone pre-activation, the convs by epilogue and every
   pre-activation by mode held to models.resnet_int8.plan_launches, its phi
   finite and near fp32 and the base trunk; every recorded call of the
   stem, the pool, the stream epilogue (int32 accumulators, the int8
   stream, the fused mode-2 / mode-3 pre-activation) and the int8-input
   pre-activation replayed against its plain version (equal); the stems,
   the pool, the stream epilogue and the mode-2 pre-activation timed in
   turns with their plain versions, beside the bf16 stem (permute, cuDNN
   7x7/2 conv and bias; max_pool_same and the permute back); the bench
   predictor with int8_root="u8" on the 480-frame uint8 clip (launches per
   clip as its plan predicts, omegas within 0.5 of the bench config's,
   both clips timed in turns), a uint8 stream through it against its
   offline output, and one profiled clip of each (device kernel time and
   idle share) with the threads alive in the process.

21. The reference's TF-slim checkpoints without TensorFlow: the committed
   fixture (tests/data/tf_slim_ckpt, a phi-mode model at feature 32 in one
   data shard and most of it again in two) read by utils.tf_bundle, every
   variable CRC-checked, the reader's ms per MB; the two bundles' shared
   variables equal; convert_tf_checkpoint (strict) into the port's
   phi-mode HmmrModel, built on the card and on the CPU, one group of B=8
   phi windows of T=20 through the fused-SMPL predictor on each: omegas
   within phase 11's bound, K1 launched on the card. Then
   MocapTemporalStream over the temporal records of the port's
   datasets.mocap writer: every window of the source sequences yielded
   once per pass, its deltas equal to poses[1:] - poses[:-1].

The last lines are a JSON line of per-kernel results, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_FRAMES = 480
IMG = 224
CHUNK = 120
N_CALIB = 32
SMPL_VERTS = 6890
SMPL_KPS = 25
TOL = {"verts": 2e-4, "joints": 2e-4, "j_posed": 1e-4}  # tests/test_ops_pallas.py
# K1's planes against the plain fp32 version: 3xTF32 is fp32-class (a
# single TF32 product would be off by ~4e-4).
K1_PLANES_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 5e-3, 1e-3
# K2 against its plain version: expected equal; at most 0.1% of the
# elements may differ, with rel L2 at most 1e-3.
K2_MAX_FRAC, K2_MAX_REL = 1e-3, 1e-3
# The int8 trunk: use_pallas against the XLA path (the JAX test's bounds,
# tests/test_resnet_int8.py:238-240), both against fp32.
TRUNK_COS, TRUNK_REL, TRUNK_FP32_COS = 0.995, 0.05, 0.98
OMEGA_TOL = 0.5  # tests/test_resnet_int8.py:113
# Streaming against offline, omegas: tests/test_streaming.py's bound with
# an fp32 window tail. A bf16 tail (bf16_temporal) meets other GEMM batch
# sizes in a stream (B windows, not the clip's) and rounds its outputs to
# bf16, so an omega may flip by a bf16 ulp of its value (2^-6 for |x| in
# [2, 4)): |stream - offline| <= atol + rtol * |offline|, with atol the
# bound of tests/test_torch_predictor.py for bf16 roundings of the window
# tail in another order and rtol one bf16 ulp.
STREAM_OMEGA_TOL = 1e-3
STREAM_BF16_OMEGA_TOL = 1.2e-2
STREAM_BF16_OMEGA_RTOL = 2.0 ** -7
STREAM_PIECES = (1, 7, 37, 64)
N_LATENCY = 270          # 33 emissions at B=1
N_TUBE = 200             # frames per test record
EVAL_RTOL, EVAL_ATOL = 2e-3, 2e-4  # tests/test_eval_device_metrics.py:82
N_TF32 = 40
# Phase 12: the training step's shapes (K1 sees 4 heads x B*T = 640 rows).
TRAIN_B, TRAIN_T, TRAIN_C = 8, 20, 2048
TRAIN_N = 4 * TRAIN_B * TRAIN_T
N_LEARN = 20
N_TIMED_STEPS = 5
# The card's step against the same state on the CPU: each loss within
# 1e-5 relative; each parameter's gradient within 1e-3 relative in L2
# norm, not the 1e-4 the CPU test holds the port to JAX at tiny width:
# at full width a forward difference of ~1e-7 flips the sign of one of the
# ~1.2e7 Linear outputs that feed a ReLU, and that one flip adds or drops
# one frame's share of a weight's gradient (measured: 1 flip, 2.06e-4 in
# L2 on single_view_ief.fc1.weight; ROADMAP Queue 3).
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL = 1e-5, 1e-3
# Phase 13: image-mode training, B=8 tubes of T=20 frames of FRAME x FRAME
# uint8 cropped to IMG; the card against the CPU at B=1, T=8. BatchNorm's
# moving averages take the batch statistics at 0.003, so 1e-5 on them is a
# batch statistic within 3.3e-3 of the CPU's.
IMG_B, IMG_T, IMG_CPU_T, FRAME = 8, 20, 8, 256
N_IMG_LEARN = 10
N_IMG_TIMED = 3
IMG_STATS_ATOL = 1e-5
# augment_batch on the card against the CPU (tests/test_torch_augment.py):
# the card's sin, cos and pow differ from the CPU's by ulps, so a sampling
# coordinate (up to ~400 px, float32 ulp 3e-5) may move by ~1e-4 px, and a
# crop of noise frames (neighbours up to 2 apart in [-1, 1]) by 2e-4.
AUG_PIXEL_ATOL, AUG_LABEL_ATOL = 5e-4, 1e-4
# remat against no remat, one bf16 step from the same state: the forward is
# the same kernels on the same inputs, so equal is expected.
REMAT_LOSS_RTOL, REMAT_STATS_ATOL = 1e-6, 1e-7
# Phase 14: multi-GPU inference. The halo path's long clip, and the 1 x W
# mesh's clips (cut from the long clip's features).
N_HALO = 1000
CLIPS_2D = (2, 240)
# predict_all_images_sharded against predict_all_images with an fp32 window
# tail: tests/test_service.py's bound for the JAX sharded path. A bf16 tail
# is held to the streaming bound above (other GEMM batch sizes per rank).
SHARDED_FP32_TOL = 2e-5
# The halo path (one-pass variance, each conv as three matmuls) against the
# unsharded TemporalEncoderFC2GN (F.group_norm, nn.Conv1d) on the 1000-frame
# clip at C = 2048, fp32 without TF32: measured on an H100 at world 1,
# omegas 9.537e-07 and 1.639e-06 over every key (verts); held at about 6x.
HALO_TOL = {"omegas": 1e-5, "all": 1e-5}
N_MESH_TURNS = 3
MESH_WORKER_TIMEOUT = 600
# Phase 15: data-parallel training. World 1 on NCCL against the plain step,
# with deterministic algorithms: every collective of one rank is the
# identity, and the first step's losses come out equal bit for bit; its
# gradients are held to the phi-mode target (1e-4 of each parameter's
# largest element), the losses of 3 steps within 1e-6 relative and every
# state tensor after them within 1e-5 relative L2. An H100 run put 3 of 61
# first-step gradients one float32 ulp apart (1.49e-8, cuDNN's reduction
# of the temporal encoder's conv biases: the ops and inputs are the
# same), and Adam, which divides each element by its own gradient, turned
# that into 1.1e-6 after 3 steps, where a second plain Trainer with the
# default algorithms is 1.2e-6 to 2.5e-4 from the first. Two gloo ranks
# sharing the card against the world-1 step on the
# global batch: phi losses within 1e-5 and the first step's summed
# gradients within TRAIN_GRAD_REL (phase 12's bound) per parameter; the bf16
# image step by the bf16 rules of tests/test_torch_train_image_step.py,
# over the whole step: a bf16 step is rounded at other places when each
# rank holds half the frames (its BatchNorm statistics are combined from
# the ranks' own), so the two-rank step is held no further from the
# world-1 fp32 step than twice the world-1 bf16 step is: each model's
# gradient as one vector (relative L2, plus 1e-3) and the largest relative
# loss difference (plus 2e-3). A CPU rehearsal at 8 frames of 64x64 per
# rank put the two-rank bf16 losses up to 3.3% from world 1's bf16 ones,
# which were up to 9.6% from its fp32 ones.
DP_STEPS = 3
DP_TIMED = 3
DP_RANK_STEPS = 2
DP_MAIN_STEPS = 3
DP_WORLD1_RTOL, DP_WORLD1_STATE_REL, DP_WORLD1_GRAD_REL = 1e-6, 1e-5, 1e-4
DP_LOSS_RTOL = 1e-5
DP_BF16_LOSS_RTOL = 2e-3
DP_BF16_GRAD_FACTOR, DP_BF16_GRAD_FLOOR = 2.0, 1e-3
# Phase 18: 2-D and TP training, phase 15's phi and image (b)
# configurations. World 1 on NCCL against the plain step: the 2-D path's
# convs are three matmuls and its GroupNorm's variance one pass, and a TP
# layer adds its bias after the matmul, so the bounds are DP_LOSS_RTOL
# and TRAIN_GRAD_REL, not bit equality; two gloo ranks by phase 15's rules.
SHARDED_STEPS = 2
SHARDED_TIMED = 3
# Phase 16: the demo. One person walking through DEMO_FRAMES frames of
# DEMO_H x DEMO_W, not detected in DEMO_MISSING (interpolated bboxes). The
# card's float32 crops against the CPU's within a float32 ulp at 1 (the
# float64 arithmetic, summed in other orders on the two devices, may round
# to either neighbour), and the float64 resize within DEMO_CROP_TOL
# (cv2.resize is matched to a few float64 ulps by F.interpolate); the
# fp32 omegas of a DEMO_SHORT-frame track against the same call on the CPU
# (phase 11 measured 7.2e-7 for the predictor). The renders use a UV sphere
# of RENDER_SPHERE (latitude rings + 1, longitudes): 6890 vertices and 13776
# faces, SMPL's counts, each face local to the surface.
DEMO_FRAMES, DEMO_H, DEMO_W = 240, 720, 1280
DEMO_MISSING = (31, 32, 150)
DEMO_SHORT = 40
DEMO_CROP_TOL, DEMO_OMEGA_TOL = 1e-9, 1e-5
DEMO_CROP32_TOL = 2.0 ** -23
RENDER_SPHERE = (85, 82)
RENDER_RGB_TOL = 1e-5
N_RENDER_TIMED = 3
# Phase 17: the dataset tools. A DS_FRAMES- and a DS_SHORT-frame tube of
# DEMO_H x DEMO_W JPEG frames; DS_PHI_N augmented crops for the extractor.
# The card's phis against the CPU's: fp32 without TF32, convolutions summed
# in other orders (relative L2 per frame); labels by the augment's keypoint
# bound (tests/test_torch_augment.py). The neutral-shape fit: the recovery
# bounds of tests/test_datasets.py, and the card's first FIT_CPU_ITERS Adam
# steps against the CPU's.
DS_FRAMES, DS_SHORT, DS_PHI_N, DS_PHI_BATCH, DS_TIMED = 150, 24, 24, 64, 2
DS_PHI_REL, DS_LABEL_ATOL = 1e-4, 1e-4
FIT_ITERS, FIT_BETA_TOL, FIT_LOSS_MAX = 3000, 0.05, 1e-4
FIT_CPU_ITERS, FIT_CPU_TOL = 100, 1e-4
# Phase 19: the closed loop (scripts.synthetic_gauntlet, phi mode) at full
# width: feature 2048, GAUNTLET_TUBES train and GAUNTLET_TEST test tubes of
# GAUNTLET_FRAMES frames, B=8, T=20, --fused, the generator's default
# synthetic SMPL of 512 vertices; GAUNTLET_STEPS steps checkpointed every
# GAUNTLET_SAVE. The generator on the card against the CPU at GEN_SMALL:
# numpy-made fields equal, SMPL-derived ones (gt3ds, keypoint labels)
# within GEN_TOL of their scale, max(1, max |x|) (tests/test_torch_gauntlet
# measured 1.2e-7 between the two packages on the CPU), rendered frames
# byte-equal where the joints round to the same pixels and at most
# GEN_PIXEL_SHARE of the pixels different.
GAUNTLET_TUBES, GAUNTLET_TEST, GAUNTLET_FRAMES = 64, 8, 120
GAUNTLET_STEPS, GAUNTLET_SAVE = 500, 250
GEN_SMALL = dict(num_tubes=4, frames_per_tube=24, feature_dim=64,
                 num_verts=512, seed=0, num_test_tubes=2, crop_size=64)
GEN_TOL, GEN_PIXEL_SHARE = 1e-5, 1e-2
N_LOADER_BATCHES = 40
# Phase 20: the int8 trunk's int8_root / int8_stream variants at CHUNK
# frames, (name, apply_int8_static options, uint8 frames); each held to the
# base static trunk and to fp32 by the JAX test's bounds
# (tests/test_resnet_int8.py:441-444); the clip timed in N_ROOT_TURNS
# rounds of bench, bench + u8, bench + u8, bench.
ROOT_RUNS = (
    ("s2d", dict(int8_root=True), False),
    ("wfold", dict(int8_root="wfold"), False),
    ("u8", dict(int8_root="u8"), True),
    ("stream", dict(int8_stream=True), False),
    ("s2d_stream_1", dict(int8_root=True, int8_stream=(1,)), False),
    ("k2_stream_1", dict(use_pallas=True, int8_stream=(1,)), False),
)
ROOT_FP32_COS, ROOT_REL = 0.97, 0.15
N_ROOT_TURNS = 2
STEM_TAPS = 7 * 7 * 3    # the root conv's taps: the bound's work per output
PROFILE = "--profile" in sys.argv[1:]
TF32_OMEGA_TOL = 1e-4    # the fp32 predictor's parity bound against JAX
# Phase 21: the fixture's model (tests/data/tf_slim_ckpt/make_fixture.py)
# and one group of B=8 windows of T=20 (8 good frames each) of its phi.
TF_FIXTURE = os.path.join(HERE, "tests", "data", "tf_slim_ckpt")
TF_SLIM_KW = dict(include_resnet=False, num_conv_layers=3,
                  delta_t_values=(), do_hallucinate=True)
TF_FEATURE, TF_PHI_FRAMES = 32, 64
# Phase 21's mocap sequences: 1000 frames at 100 fps, 250 at the writer's
# 25 fps, four 50-frame windows each.
MOCAP_SEQS, MOCAP_FRAMES, MOCAP_WINDOW = 2, 1000, 50

# Published peaks of one H100 SXM (dense): int8 and TF32 tensor cores, FP32
# pipe, HBM.
INT8_OPS, TF32_OPS, FP32_OPS, HBM_BYTES = 1979e12, 495e12, 67e12, 3.35e12
# ~2.8 ms of spinning at 1.755 GHz: longer than the host takes to queue the
# 10 conv calls that device_ms times behind it.
SPIN_CYCLES = 5_000_000


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, iters=20):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10):
    """Device time of fn() over `iters` calls: the calls are queued behind a
    spin kernel, so the host's time between launches does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, k_iters=10, p_iters=2):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, p_iters)
    k1 = cuda_ms(kernel, k_iters)
    k2 = cuda_ms(kernel, k_iters)
    p2 = cuda_ms(plain, p_iters)
    return min(k1, k2), min(p1, p2)


def bound_ms(ops, rate, nbytes):
    """The least time for `ops` at `rate` and `nbytes` at the HBM rate."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Recorder:
    """Wraps functions of a module so that each call's arguments are kept."""

    def __init__(self, module, names):
        self.module, self.names, self.calls = module, names, []

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def wrapper(*args, _n=n, _fn=fn, **kwargs):
                self.calls.append((_n, args, kwargs))
                return _fn(*args, **kwargs)
            setattr(self.module, n, wrapper)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def reset_counts(K):
    """Zero the int8 kernels' launch counters: by wrapper, by path, by
    epilogue, pre-activations by mode, and the int8 stem and pool's."""
    from human_dynamics_tpu_torch.ops import int8_root_cuda as R

    for counts in (K.LAUNCHES, K.PATH_LAUNCHES, K.EPILOGUE_LAUNCHES,
                   K.PREACT_MODE_LAUNCHES, R.LAUNCHES):
        for k in counts:
            counts[k] = 0


def build_all(load_kernel_libraries, names):
    """Build every kernel library at once, one nvcc per source."""
    t0 = time.perf_counter()
    for name, loaded in zip(names, load_kernel_libraries(names)):
        info = loaded.info
        print(f"build {name}: {'built' if info.built else 'cache hit'}, "
              f"ready {info.seconds:.2f} s after the start -> "
              f"{os.path.relpath(info.path, HERE)}")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s")


def phase_k1(torch, np, dev, smpl, consts, main_n):
    from human_dynamics_tpu_torch.core import smpl_forward
    from human_dynamics_tpu_torch.ops import smpl_cuda

    rng = np.random.RandomState(0)

    def inputs(n):
        beta = rng.randn(n, 10).astype(np.float32) * 0.3
        theta = rng.randn(n, 72).astype(np.float32) * 0.3
        return (torch.from_numpy(beta).to(dev),
                torch.from_numpy(theta).to(dev))

    plane_err = 0.0
    # 24 and 192: one streaming emission's three heads at B=1 and B=8;
    # TRAIN_N: a training step's four heads.
    for n in (1440, 37, 21, 1, 24, 192, TRAIN_N, main_n):
        beta, theta = inputs(n)
        fused = smpl_cuda.smpl_forward_fused(smpl, beta, theta, consts)
        plain = smpl_forward(smpl, beta, theta)
        errs = {k: max_abs(getattr(fused, k), getattr(plain, k)) for k in TOL}
        coeffs, rt_t, _, _ = smpl_cuda.blend_skin_operands(
            smpl, consts, beta, theta)
        ops = (coeffs, rt_t, consts.dirs, consts.v_template, consts.weights_t)
        planes = max(
            max_abs(k, p) for k, p in zip(
                smpl_cuda.blend_skin(*ops),
                smpl_cuda.blend_skin_reference(*ops))
        )
        torch.cuda.synchronize()
        print(f"K1 N={n} V={SMPL_VERTS}: max|kernel-plain| planes "
              f"{planes:.3e} (tol {K1_PLANES_TOL:g}), " + ", ".join(
                  f"{k} {v:.3e} (tol {TOL[k]:g})" for k, v in errs.items()))
        for k, v in errs.items():
            check(v <= TOL[k], f"K1 {k} error {v} > {TOL[k]} at N={n}")
        check(planes <= K1_PLANES_TOL,
              f"K1 planes error {planes} > {K1_PLANES_TOL} at N={n}")
        plane_err = max(plane_err, planes)

    # One gradient through the autograd.Function against the plain path.
    beta, theta = inputs(21)
    grads = []
    for fn in (smpl_cuda.smpl_forward_fused, smpl_forward):
        b = beta.clone().requires_grad_(True)
        t = theta.clone().requires_grad_(True)
        loss = torch.sum(fn(smpl, b, t).joints ** 2)
        grads.append(torch.autograd.grad(loss, [b, t]))
    for name, g, w in zip(("beta", "theta"), *grads):
        err = max_abs(g, w)
        print(f"K1 grad d(sum joints^2)/d{name}: max abs diff {err:.3e}")
        check(torch.allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL),
              f"K1 gradient in {name} differs by {err}")

    # Kernel and plain version at the main path's shape, in turns.
    ops = k1_operands(smpl, consts, *inputs(main_n))
    k_ms, p_ms = k1_in_turns(torch, ops)
    blend_gemm = cuda_ms(lambda: torch.matmul(ops[0], consts.dirs))
    print(f"K1 N={main_n} V={SMPL_VERTS}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms (CUDA events, 20 launches each, best of two "
          f"turns)")
    b_ms, b_by, fp32_ms, products, flops, moved = k1_bound(smpl_cuda, main_n)
    print(f"K1 yardsticks: 3xTF32 tensor-core bound {b_ms:.4f} ms ({b_by}: "
          f"{3 * products / 1e9:.2f} GFLOP TF32; bytes "
          f"{moved / HBM_BYTES * 1e3:.4f} ms for {moved / 1e6:.1f} MB); "
          f"FP32-pipe bound {fp32_ms:.4f} ms ({flops / 1e9:.2f} GFLOP); "
          f"partial yardstick, not library_ms: the blend GEMM alone, "
          f"torch.matmul(coeffs, dirs) in fp32, {blend_gemm:.4f} ms")
    # And at a training step's N.
    t_ms, tp_ms = k1_in_turns(torch, k1_operands(smpl, consts,
                                                 *inputs(TRAIN_N)))
    t_bound, t_by = k1_bound(smpl_cuda, TRAIN_N)[:2]
    print(f"K1 N={TRAIN_N} V={SMPL_VERTS} (a training step): kernel "
          f"{t_ms:.4f} ms, plain {tp_ms:.4f} ms, bound {t_bound:.4f} ms "
          f"({t_by})")
    return {"max_abs_err": plane_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "train_n": TRAIN_N, "train_ms": t_ms, "train_plain_ms": tp_ms,
            "train_bound_ms": t_bound}


def k1_operands(smpl, consts, beta, theta):
    from human_dynamics_tpu_torch.ops import smpl_cuda

    coeffs, rt_t, _, _ = smpl_cuda.blend_skin_operands(smpl, consts, beta,
                                                       theta)
    return (coeffs, rt_t, consts.dirs, consts.v_template, consts.weights_t)


def k1_in_turns(torch, ops):
    """(kernel ms, plain ms) of K1 on `ops`, timed plain, kernel, kernel,
    plain, 20 launches each; the best of each pair."""
    from human_dynamics_tpu_torch.ops import smpl_cuda

    kernel = lambda: smpl_cuda.blend_skin(*ops)
    plain = lambda: smpl_cuda.blend_skin_reference(*ops)
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    return min(k1, k2), min(p1, p2)


def k1_bound(smpl_cuda, n, v=SMPL_VERTS):
    """K1's bound at N = n: the function's own work, without the kernel's
    zero padding (coefficients 217 -> 224, joints 24 -> 32): per vertex and
    frame, the blend and skinning products (2 flop per multiply-add), the
    template add and the 3x4 transform; bytes of the unpadded operands and
    the 3 planes. On the tensor cores each product is three TF32 products.
    Returns (bound ms, by, FP32-pipe bound ms, products, flops, bytes)."""
    cd, rc, nj = smpl_cuda.COEF_DIM, smpl_cuda.RT_CH, smpl_cuda.NUM_JOINTS
    products = n * v * 2 * (3 * cd + rc * nj)
    flops = products + n * v * (3 + 18)
    moved = 4 * (n * cd + rc * nj * n + 3 * cd * v + 3 * v + nj * v
                 + 3 * n * v)
    b_ms, b_by = bound_ms(3 * products, TF32_OPS, moved)
    fp32_ms, _ = bound_ms(flops, FP32_OPS, moved)
    return b_ms, b_by, fp32_ms, products, flops, moved


def check_predictor_outputs(torch, out, what):
    want_shapes = {
        "verts": (N_FRAMES, SMPL_VERTS, 3),
        "verts_delta": (N_FRAMES, 2, SMPL_VERTS, 3),
        "kps": (N_FRAMES, SMPL_KPS, 2),
        "omegas": (N_FRAMES, 85),
    }
    for k, shape in want_shapes.items():
        check(tuple(out[k].shape) == shape,
              f"{what}: {k} has shape {tuple(out[k].shape)}, want {shape}")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{what}: {k} is not finite")


def conv_call_bound(torch, x, wt, stride, kw):
    """(operations, bytes) of one conv call: each input read once, each
    output written once, the fused pre-activation's int8 output and its
    per-channel operands included."""
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K

    ks, ho, wo = K.conv_geometry(x, wt, stride)
    m, cout = x.shape[0] * ho * wo, wt.shape[0]
    out_size = torch.empty((), dtype=K._OUT_DTYPE[kw["epilogue"]]).element_size()
    ops = 2 * m * wt.shape[1] * cout
    b = (nbytes(x, wt, kw.get("mul"), kw.get("add"), kw.get("residual"))
         + m * cout * out_size)
    pre = kw.get("preact")
    if pre is not None:
        b += nbytes(pre.pa, pre.pb, pre.s) + m * cout
    return ops, b


def int_mm_ms(torch, xq, wt, acc, total):
    """Add torch._int_mm's time for a 1x1 stride-1 conv to `total`; the
    library call is a yardstick only, so a refusal is printed, not raised."""
    a2 = xq.reshape(-1, xq.shape[3])
    try:
        lib = cuda_ms(lambda: torch._int_mm(a2, wt.t()), 10)
        same = torch.equal(torch._int_mm(a2, wt.t()).reshape(acc.shape), acc)
    except RuntimeError as e:
        print(f"  torch._int_mm refused {tuple(a2.shape)} x "
              f"{tuple(wt.t().shape)}: {str(e).splitlines()[0]}")
        return total
    check(same, "torch._int_mm disagrees with the int32 accumulators")
    return (total or 0.0) + lib


def replay_conv(torch, K, n, xq, wt, stride, kw):
    """One recorded conv call, kernel against plain: the int32 accumulators,
    the epilogue output and any fused pre-activation must be equal.
    Returns (int32 accumulators, max abs error, kernel ms per call with the
    wrapper, plain ms, kernel device ms)."""
    acc = K.conv_s8(xq, wt, stride)
    acc_ref = K.conv_s8_reference(xq, wt, stride)
    check(torch.equal(acc, acc_ref),
          f"conv call {n}: int32 accumulators differ")
    got = K.conv_s8(xq, wt, stride, **kw)
    want = K.epilogue_reference(acc_ref, **kw)
    if kw.get("preact") is None:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"conv call {n} ({kw['epilogue']}"
              f"{', fused preact' if len(got) == 2 else ''}) differs")
    err = max([max_abs(acc, acc_ref)]
              + [max_abs(g, w) for g, w in zip(got, want)])
    k_ms, p_ms = in_turns(
        lambda: K.conv_s8(xq, wt, stride, **kw),
        lambda: K.epilogue_reference(K.conv_s8_reference(xq, wt, stride),
                                     **kw))
    d_ms = min(device_ms(lambda: K.conv_s8(xq, wt, stride, **kw))
               for _ in range(2))
    return acc, err, k_ms, p_ms, d_ms


def conv_chain(K, x, units, specs, pq, nxt):
    """A K2 chain as the int8 conv's composition (K2's route before it had
    a kernel of its own), a yardstick only: per unit three or four conv_s8
    launches with the intermediates through device memory, the last conv
    quantising the next unit's pre-activation; a standalone preact_quant
    where no conv handed one in. Returns (out, the next unit's pq or
    None)."""
    last = len(units) - 1
    for i, (p, sc) in enumerate(zip(units, specs)):
        if pq is None:
            pq = K.preact_quant(x, p["pA"], p["pB"], mode=0)
        shortcut = (K.conv_s8(pq, p["wsc"], epilogue="dequant_f32",
                              mul=p["dscm"], add=p["dsca"]) if sc else x)
        h1 = K.conv_s8(pq, p["w1"], epilogue="requant", mul=p["q1m"],
                       add=p["q1a"], relu=True, fma=True)
        h2 = K.conv_s8(h1, p["w2"], epilogue="requant", mul=p["q2m"],
                       add=p["q2a"], relu=True, fma=True)
        after = K.unit_preact(units[i + 1]) if i < last else nxt
        out = K.conv_s8(h2, p["w3"], epilogue="residual", mul=p["d3m"],
                        add=p["d3a"], residual=shortcut, preact=after)
        x, pq = out if after is not None else (out, None)
    return x, pq


def phase_int8_kernels(torch, model, frames):
    """Phase 4: the int8 trunk, its recorded conv / preact / K2 calls."""
    from human_dynamics_tpu_torch.infer import HmmrPredictor
    from human_dynamics_tpu_torch.models import resnet_int8 as R
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K

    x = HmmrPredictor._normalise(frames[:CHUNK])
    calib = frames[-N_CALIB:].float() * (2.0 / 255.0) - 1.0
    with torch.no_grad():
        qp = R.prepare_int8_params(model.resnet_v2_50)
        scales = R.calibrate_int8_scales(qp, calib)
        plan_xla = R.prepare_int8_static(qp, scales)
        plan_k2 = R.prepare_int8_static(qp, scales, use_pallas=True)

        # K2's path, counted.
        reset_counts(K)
        with Recorder(R, ["fused_block_pq"]) as rec_k2:
            phi_k2 = R.apply_int8_static(qp, scales, x, use_pallas=True)
        torch.cuda.synchronize()
        k2_launches = K.LAUNCHES[K.BLOCK]
        print(f"int8 trunk use_pallas=True, {CHUNK} frames: kernel launches "
              f"{dict(K.LAUNCHES)}, conv by path {dict(K.PATH_LAUNCHES)}; "
              f"K2's {k2_launches} in {len(rec_k2.calls)} chains")
        n_units = sum(len(u["params"]) for u in plan_k2["steps"]
                      if u["kind"] == "k2")
        other_convs = sum(3 + ("wsc" in u) for u in plan_k2["steps"]
                          if u["kind"] != "k2")
        check(k2_launches == n_units == 11 and len(rec_k2.calls) == 3,
              f"the use_pallas=True trunk should launch K2 once per unit, "
              f"11 in 3 chains; got {k2_launches} for {n_units} units")
        check(K.LAUNCHES[K.CONV] == other_convs and K.LAUNCHES[K.PREACT] == 1,
              f"K2's steps made conv or preact launches: {dict(K.LAUNCHES)}, "
              f"want {other_convs} convs (the other units') and 1 preact")
        reset_counts(K)
        with Recorder(R, ["conv_s8", "preact_quant"]) as rec_xla:
            phi_xla = R.apply_int8_static(qp, scales, x)
        torch.cuda.synchronize()
        print(f"int8 trunk use_pallas=False, {CHUNK} frames: kernel launches "
              f"{dict(K.LAUNCHES)}, conv by path {dict(K.PATH_LAUNCHES)}")
        check(K.LAUNCHES[K.PREACT] == 1 and K.PATH_LAUNCHES["tma"] == 36
              and K.PATH_LAUNCHES["gather"] == 16,
              "the static trunk should make 1 standalone pre-activation and "
              "36 TMA + 16 gather conv launches per chunk")
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            phi_fp32 = model.resnet_v2_50(x)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
        torch.cuda.synchronize()

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())

    rel = float((phi_k2 - phi_xla).norm() / phi_xla.norm())
    c_k2, c_x, c_k2f = cos(phi_k2, phi_xla), cos(phi_xla, phi_fp32), cos(
        phi_k2, phi_fp32)
    print(f"int8 trunk: K2 vs XLA path min cos {c_k2:.6f} (>= {TRUNK_COS}), "
          f"rel {rel:.3e} (<= {TRUNK_REL}); against fp32 (TF32 off): XLA "
          f"path min cos {c_x:.6f}, K2 path {c_k2f:.6f} (>= {TRUNK_FP32_COS})")
    check(c_k2 >= TRUNK_COS and rel <= TRUNK_REL, "K2 trunk vs XLA trunk")
    check(c_x >= TRUNK_FP32_COS and c_k2f >= TRUNK_FP32_COS,
          "int8 trunk vs fp32 trunk")

    # Every conv and standalone preact call of the XLA path, kernel against
    # plain.
    conv = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "ops": 0,
            "bytes": 0, "err": 0.0}
    pre = {"ms": 0.0, "plain_ms": 0.0, "ops": 0, "bytes": 0, "err": 0.0}
    geoms = {}
    n_conv = n_pre = n_fused = 0
    with torch.no_grad():
        for name, args, kw in rec_xla.calls:
            if name == "preact_quant":
                n_pre += 1
                xin, pa, pb, s = args
                got = K.preact_quant(xin, pa, pb, s, **kw)
                want = K.preact_quant_reference(xin, pa, pb, s, **kw)
                check(torch.equal(got, want), f"preact call {n_pre} differs")
                pre["err"] = max(pre["err"], max_abs(got, want))
                k_ms, p_ms = in_turns(
                    lambda: K.preact_quant(xin, pa, pb, s, **kw),
                    lambda: K.preact_quant_reference(xin, pa, pb, s, **kw))
                pre["ms"] += k_ms
                pre["plain_ms"] += p_ms
                pre["ops"] += 5 * xin.numel()
                pre["bytes"] += nbytes(xin, pa, pb, s) + xin.numel()
                continue
            n_conv += 1
            xq, wt, stride = args
            n_fused += kw.get("preact") is not None
            acc, err, k_ms, p_ms, d_ms = replay_conv(torch, K, n_conv, xq,
                                                     wt, stride, kw)
            conv["err"] = max(conv["err"], err)
            ops, b = conv_call_bound(torch, xq, wt, stride, kw)
            conv["ms"] += d_ms
            conv["call_ms"] += k_ms
            conv["plain_ms"] += p_ms
            conv["ops"] += ops
            conv["bytes"] += b
            ks = K.conv_geometry(xq, wt, stride)[0]
            plan = K.conv_plan(ks, stride, xq.shape[3], wt.shape[0])
            key = (xq.shape[1], xq.shape[3], wt.shape[0], ks, stride,
                   kw["epilogue"], kw.get("preact") is not None)
            g = geoms.setdefault(key, {"n": 0, "ms": 0.0, "call_ms": 0.0,
                                       "plain_ms": 0.0, "ops": 0, "bytes": 0,
                                       "lib_ms": None, "plan": plan})
            g["n"] += 1
            g["ms"] += d_ms
            g["call_ms"] += k_ms
            g["plain_ms"] += p_ms
            g["ops"] += ops
            g["bytes"] += b
            if ks == 1 and stride == 1:
                g["lib_ms"] = int_mm_ms(torch, xq, wt, acc, g["lib_ms"])
    check(n_conv == 52 and n_pre == 1 and n_fused == 15,
          f"recorded {n_conv} convs ({n_fused} with a fused pre-activation) "
          f"and {n_pre} standalone pre-activations; want 52 (15) and 1")
    print(f"int8 conv: {n_conv} calls of the XLA path replayed; int32 "
          f"accumulators, epilogue outputs and the {n_fused} fused "
          f"pre-activations equal to the plain version (max abs "
          f"{conv['err']:.3e})")
    # 1x1 stride 2 (a strided projection shortcut) is not on this trunk;
    # checked on each block's input map all the same.
    gen = torch.Generator(device=frames.device).manual_seed(2)
    with torch.no_grad():
        for h, cin in ((IMG // 4, 256), (IMG // 8, 512), (IMG // 16, 1024)):
            xq = torch.randint(-127, 128, (CHUNK, h, h, cin), generator=gen,
                               device=frames.device, dtype=torch.int8)
            wt = torch.randint(-127, 128, (2 * cin, cin), generator=gen,
                               device=frames.device, dtype=torch.int8)
            check(torch.equal(K.conv_s8(xq, wt, 2),
                              K.conv_s8_reference(xq, wt, 2)),
                  f"int8 conv 1x1/s2 {h}x{h} {cin}: accumulators differ")
    print("int8 conv 1x1/s2 on the block1-3 input maps: accumulators equal")
    print("  conv geometry (map, Cin->Cout, epilogue[+preact]), path/BNxBK: "
          "calls, kernel device ms, TOP/s, % of its bound, ms per call with "
          "the wrapper, plain ms, torch._int_mm ms (int32 out, no epilogue)")
    s11 = {"n": 0, "ms": 0.0, "call_ms": 0.0, "lib_ms": 0.0}
    for (h, cin, cout, ks, s, epi, fused), g in sorted(geoms.items()):
        g_bound, g_by = bound_ms(g["ops"], INT8_OPS, g["bytes"])
        lib = "-" if g["lib_ms"] is None else f"{g['lib_ms']:.4f}"
        plan = g["plan"]
        print(f"  {ks}x{ks}/s{s} {h}x{h} {cin}->{cout} {epi}"
              f"{'+preact' if fused else ''}, {plan.path}/{plan.bn}x"
              f"{plan.bk}: x{g['n']}, {g['ms']:.4f} ms, "
              f"{g['ops'] / g['ms'] / 1e9:.1f} TOP/s, "
              f"{g_bound / g['ms'] * 100:.1f}% of {g_bound:.4f} ms ({g_by}), "
              f"call {g['call_ms']:.4f}, plain {g['plain_ms']:.4f}, "
              f"library {lib}")
        if ks == 1 and s == 1:
            s11["n"] += g["n"]
            s11["ms"] += g["ms"]
            s11["call_ms"] += g["call_ms"]
            s11["lib_ms"] = (None if g["lib_ms"] is None or s11["lib_ms"]
                             is None else s11["lib_ms"] + g["lib_ms"])
    print(f"int8 conv, the {s11['n']} 1x1/s1 calls (TMA path): kernel "
          f"device {s11['ms']:.4f} ms, per call with the wrapper "
          f"{s11['call_ms']:.4f} ms; torch._int_mm {s11['lib_ms']} ms on the "
          f"same GEMMs (int32 out, no epilogue)")
    c_bound, c_by = bound_ms(conv["ops"], INT8_OPS, conv["bytes"])
    print(f"int8 conv, all {n_conv} calls of one {CHUNK}-frame chunk: "
          f"kernel device {conv['ms']:.4f} ms, per call with the wrapper "
          f"{conv['call_ms']:.4f} ms, plain {conv['plain_ms']:.4f} ms, "
          f"{conv['ops'] / 1e12:.3f} TOP, {conv['bytes'] / 1e9:.3f} GB, "
          f"bound {c_bound:.4f} ms ({c_by})")
    p_bound, p_by = bound_ms(pre["ops"], FP32_OPS, pre["bytes"])
    print(f"preact: {n_pre} standalone call(s): kernel {pre['ms']:.4f} ms, "
          f"plain {pre['plain_ms']:.4f} ms, equal; bound {p_bound:.4f} ms "
          f"({p_by})")

    # Every K2 chain of the use_pallas=True path: the chain against
    # fused_block_reference, and the pre-activation it hands on against
    # a standalone pass over its own output; timed in turns with the plain
    # version and with the same units as int8 conv launches.
    k2 = {"ms": 0.0, "plain_ms": 0.0, "conv_ms": 0.0, "ops": 0, "bytes": 0,
          "floor": 0, "err": 0.0}
    print("  K2 chain (map, units, Cin -> Cout, Cb): kernel ms, TOP/s, % of "
          "its chain bound (operations) and of its per-unit byte floor; "
          "plain ms; the units as int8 conv launches, ms in turns")
    with torch.no_grad():
        for _, args, kw in rec_k2.calls:
            xin, units = args
            spec = {k: kw[k] for k in ("h", "w", "unit_specs")}
            nxt = kw.get("next_preact")
            pq_in = kw.get("pq")
            if pq_in is not None:
                check(torch.equal(pq_in, K.preact_quant_reference(
                    xin, units[0]["pA"], units[0]["pB"])),
                      "the pre-activation handed to a K2 chain differs")
            reset_counts(K)
            got, got_pq = K.fused_block_pq(xin, units, **kw)
            check(K.LAUNCHES == {K.CONV: 0, K.PREACT: 0, K.BLOCK: len(units)},
                  f"a K2 chain of {len(units)} units launched "
                  f"{dict(K.LAUNCHES)}")
            want = K.fused_block_reference(xin, units, **spec)
            if nxt is not None:
                check(torch.equal(got_pq, K.preact_quant_reference(
                    got, *nxt[:3], mode=nxt.mode)),
                      "the pre-activation a K2 chain hands on differs")
            chained, chained_pq = conv_chain(K, xin, units, spec["unit_specs"],
                                             pq_in, nxt)
            check(torch.equal(chained, want) and (nxt is None or torch.equal(
                chained_pq, got_pq)), "the conv-chain yardstick differs from "
                "the plain version")
            frac = float((got != want).float().mean())
            rel = float((got.float() - want.float()).norm()
                        / want.float().norm())
            err = max_abs(got, want)
            k2["err"] = max(k2["err"], err)
            run = lambda: K.fused_block_pq(xin, units, **kw)
            k_ms, p_ms = in_turns(
                run, lambda: K.fused_block_reference(xin, units, **spec))
            k_ms2, c_ms = in_turns(
                run, lambda: conv_chain(K, xin, units, spec["unit_specs"],
                                        pq_in, nxt), 10, 10)
            k_ms = min(k_ms, k_ms2)
            m = xin.shape[0] * kw["h"] * kw["w"]
            ops = sum(2 * m * (u["w1"].numel() + u["w2"].numel()
                               + u["w3"].numel()
                               + (u["wsc"].numel() if "wsc" in u else 0))
                      for u in units)
            weights = nbytes(*[t for u in units for t in u.values()])
            out_b = m * units[-1]["w3"].shape[0] * (2 + (nxt is not None))
            b = nbytes(xin, pq_in) + weights + out_b
            if nxt is not None:
                b += nbytes(nxt.pa, nxt.pb, nxt.s)
            # Per unit: its bf16 x read once and its bf16 out written once.
            floor = (weights + out_b + nbytes(nxt.pa, nxt.pb, nxt.s)
                     if nxt is not None else weights + out_b)
            floor += sum(2 * m * (u["w1"].shape[1]
                                  + u["w3"].shape[0] * (i < len(units) - 1))
                         for i, u in enumerate(units))
            u_ms, u_by = bound_ms(ops, INT8_OPS, b)
            f_ms = floor / HBM_BYTES * 1e3
            print(f"  K2 {kw['h']}x{kw['w']} x{len(units)} units, "
                  f"{xin.shape[-1]} -> {units[-1]['w3'].shape[0]}, Cb "
                  f"{units[0]['w1'].shape[0]}: equal "
                  f"{torch.equal(got, want)}, differing {frac:.2e} (<= "
                  f"{K2_MAX_FRAC}), rel {rel:.2e} (<= {K2_MAX_REL}), max abs "
                  f"{err:.3e}; kernel {k_ms:.4f} ms = "
                  f"{ops / k_ms / 1e9:.1f} TOP/s, {u_ms / k_ms * 100:.1f}% "
                  f"of {u_ms:.4f} ms ({u_by}, {ops / 1e12:.3f} TOP), "
                  f"{f_ms / k_ms * 100:.1f}% of the byte floor {f_ms:.4f} ms "
                  f"({floor / 1e9:.3f} GB); plain {p_ms:.4f} ms; conv chain "
                  f"{c_ms:.4f} ms ({k_ms2:.4f} in turns with it)")
            check(frac <= K2_MAX_FRAC and rel <= K2_MAX_REL,
                  f"K2 at {kw['h']}x{kw['w']} differs from its plain version")
            k2["ms"] += k_ms
            k2["plain_ms"] += p_ms
            k2["conv_ms"] += c_ms
            k2["ops"] += ops
            k2["bytes"] += b
            k2["floor"] += floor
    k2_bound, k2_by = bound_ms(k2["ops"], INT8_OPS, k2["bytes"])
    k2_floor = k2["floor"] / HBM_BYTES * 1e3
    print(f"K2, all {len(rec_k2.calls)} chains ({k2_launches} units) of one "
          f"chunk: kernel {k2['ms']:.4f} ms = "
          f"{k2['ops'] / k2['ms'] / 1e9:.1f} TOP/s, plain "
          f"{k2['plain_ms']:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}, "
          f"{k2_bound / k2['ms'] * 100:.1f}%), per-unit byte floor "
          f"{k2_floor:.4f} ms ({k2['floor'] / 1e9:.3f} GB, "
          f"{k2_floor / k2['ms'] * 100:.1f}%); the units as int8 conv "
          f"launches {k2['conv_ms']:.4f} ms")

    # The trunks, one chunk each.
    with torch.no_grad():
        t_xla = cuda_ms(lambda: R.run_int8_static(plan_xla, x), 5)
        t_k2 = cuda_ms(lambda: R.run_int8_static(plan_k2, x), 5)
        t_fp32 = cuda_ms(lambda: model.resnet_v2_50(x), 5)
    print(f"trunk, {CHUNK} frames of {IMG}x{IMG} (CUDA events, 5 runs): int8 "
          f"XLA path {t_xla:.3f} ms, int8 K2 path {t_k2:.3f} ms, fp32 "
          f"(cuDNN TF32 {torch.backends.cudnn.allow_tf32}) {t_fp32:.3f} ms; "
          f"int8 trunk bound {c_bound:.3f} ms ({c_by}, its convs)")
    return {
        # library_ms: torch._int_mm on the 36 1x1 stride-1 calls only (int32
        # out, no epilogue); no one call computes the conv with its epilogue.
        "conv": {"max_abs_err": conv["err"], "ms": conv["ms"],
                 "plain_ms": conv["plain_ms"], "bound_ms": c_bound,
                 "bound_by": c_by, "library_ms": s11["lib_ms"]},
        "preact": {"max_abs_err": pre["err"], "ms": pre["ms"],
                   "plain_ms": pre["plain_ms"], "bound_ms": p_bound,
                   "bound_by": p_by, "library_ms": None},
        "k2": {"launches": k2_launches, "max_abs_err": k2["err"],
               "ms": k2["ms"], "plain_ms": k2["plain_ms"],
               "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
               "byte_floor_ms": k2_floor, "conv_chain_ms": k2["conv_ms"]},
    }


def profile_run(torch, what, run):
    """A torch.profiler breakdown of one (warm) call of run()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device kernels only: the operator rows, and the device ranges of user
    # annotations such as Optimizer.step, repeat their kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events) / 1e3
    check(total <= wall * 1e3, f"profile: kernel time {total:.2f} ms exceeds "
          f"the traced wall {wall * 1e3:.2f} ms; events are counted twice")
    print(f"profile, {what}: wall {wall * 1e3:.2f} ms (traced), kernel time "
          f"{total:.2f} ms in {sum(e.count for e in events)} device events, "
          f"device idle {(1 - total / (wall * 1e3)) * 100:.1f}% of the wall")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    return events, total


def reset_all(K, smpl_cuda):
    """Zero every kernel's launch counter."""
    reset_counts(K)
    smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] = 0


def read_counts(K, smpl_cuda):
    return dict(K.LAUNCHES, **smpl_cuda.LAUNCHES), dict(K.PATH_LAUNCHES)


def feed_pieces(sp, frames, pieces):
    """Feed `frames` in pieces cycling through `pieces`, then flush."""
    emissions, i, j = [], 0, 0
    while i < len(frames):
        n = pieces[j % len(pieces)]
        emissions += sp.feed(frames[i:i + n])
        i, j = i + n, j + 1
    return emissions + sp.flush()


def stream_encoder_calls(sp, n):
    """(encoder calls, emissions) of an n-frame stream: a first step of
    quantum + margin frames, then one per quantum; the flush encodes the
    rest in one call and emits what is left, margin included."""
    q, m = sp.quantum, sp.margin
    steps = 0 if n < q + m else 1 + (n - q - m) // q
    rest = n - (steps * q + m if steps else 0)
    left = rest + (m if steps else 0)
    return steps + (rest > 0), steps + -(-left // q)


def check_stream(torch, what, pred, emissions, want):
    """Concatenated emissions against an offline result: same keys and
    shapes, omegas within the streaming bound of the predictor's window
    tail. Returns the max errors."""
    got = {k: torch.cat([e[k] for e in emissions]) for k in emissions[0]}
    check(set(got) == set(want), f"{what}: keys {sorted(got)}")
    for k in want:
        check(got[k].shape == want[k].shape,
              f"{what}: {k} {tuple(got[k].shape)} != {tuple(want[k].shape)}")
    errs = {k: max_abs(got[k], want[k]) for k in sorted(want)}
    atol, rtol = ((STREAM_BF16_OMEGA_TOL, STREAM_BF16_OMEGA_RTOL)
                  if pred.bf16_temporal else (STREAM_OMEGA_TOL, 0.0))
    # The largest error as a share of its element's bound (<= 1 passes).
    share = float(((got["omegas"] - want["omegas"]).abs()
                   / (atol + rtol * want["omegas"].abs())).max())
    print(f"{what}: max|stream - offline| " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f"; omegas bound atol "
        f"{atol:g} + rtol {rtol:g} * |offline|, largest share of it "
        f"{share:.3f}")
    check(share <= 1.0, f"{what}: omegas differ by up to {errs['omegas']}, "
          f"{share:.3f} times the bound")
    return errs


def replay_int8_calls(torch, K, calls, what):
    """Every recorded conv and standalone pre-activation call, the kernel
    against its plain version: equal outputs (not counted, not timed)."""
    sizes = set()
    with torch.no_grad():
        for name, args, kw in calls:
            sizes.add(args[0].shape[0])
            if name == "preact_quant":
                got = K.preact_quant(*args, **kw)
                want = K.preact_quant_reference(*args, **kw)
                check(torch.equal(got, want), f"{what}: preact differs")
                continue
            xq, wt, stride = args
            got = K.conv_s8(xq, wt, stride, **kw)
            want = K.epilogue_reference(K.conv_s8_reference(xq, wt, stride),
                                        **kw)
            for g, w in zip(*(((got,), (want,)) if kw.get("preact") is None
                              else (got, want))):
                check(torch.equal(g, w), f"{what}: conv {tuple(xq.shape)} "
                      f"{kw['epilogue']} differs from its plain version")
    print(f"{what}: {len(calls)} int8 conv/preact calls at M = "
          f"{sorted(sizes)} frames equal to their plain versions")


def phase_streaming(torch, bench, frames, want, K, smpl_cuda, R):
    """Phase 7: the bench config streamed at B=8 against offline."""
    from human_dynamics_tpu_torch.infer import StreamingPredictor

    sp = StreamingPredictor(bench)
    calls, emits = stream_encoder_calls(sp, len(frames))
    with Recorder(R, ["conv_s8", "preact_quant"]) as rec:
        reset_all(K, smpl_cuda)
        emissions = feed_pieces(sp, frames, STREAM_PIECES)
        torch.cuda.synchronize()
        counts, paths = read_counts(K, smpl_cuda)
    print(f"streaming bench config B={bench.batch_size} (quantum "
          f"{sp.quantum}, latency_frames {sp.latency_frames}), {len(frames)} "
          f"frames in pieces of {STREAM_PIECES}: {len(emissions)} emissions "
          f"of {[len(e['omegas']) for e in emissions]} frames, {calls} "
          f"encoder calls; launches {counts}, conv by path {paths}")
    want_counts = {smpl_cuda.KERNEL_NAME: emits, K.CONV: 52 * calls,
                   K.PREACT: calls, K.BLOCK: 0}
    check(len(emissions) == emits and counts == want_counts,
          f"streaming launches: want {want_counts}")
    errs = check_stream(torch, "streaming bench config", bench, emissions,
                        want)
    replay_int8_calls(torch, K, rec.calls, "streaming bench config")
    return {"emissions": len(emissions), "k1": counts[smpl_cuda.KERNEL_NAME],
            "omegas_err": errs["omegas"]}


def phase_latency(torch, np, name, pred, frames, K, smpl_cuda, R, card):
    """Phase 8: one frame per feed at B=1; wall time of each emitting feed,
    synchronised."""
    from human_dynamics_tpu_torch.infer import StreamingPredictor

    sp = StreamingPredictor(pred)
    # A warm-up stream (its int8 calls are checked against plain), then
    # a new stream on the warm predictor.
    with Recorder(R, ["conv_s8", "preact_quant"]) as rec:
        for i in range(sp.latency_frames + sp.quantum):
            sp.feed(frames[i:i + 1])
        sp.flush()
        torch.cuda.synchronize()
    if rec.calls:
        replay_int8_calls(torch, K, rec.calls, f"streaming B=1 {name}")
    sp.reset()
    walls, at, emissions = [], [], []
    reset_all(K, smpl_cuda)
    for i in range(N_LATENCY):
        t0 = time.perf_counter()
        out = sp.feed(frames[i:i + 1])
        torch.cuda.synchronize()
        if out:
            walls.append((time.perf_counter() - t0) * 1e3)
            at.append(i + 1)
            emissions += out
    counts, _ = read_counts(K, smpl_cuda)
    emissions += sp.flush()
    check_stream(torch, f"streaming B=1 {name}", pred, emissions,
                 pred.predict_all_images(frames[:N_LATENCY], as_numpy=False))
    if PROFILE:
        sp.reset()
        n = sp.latency_frames + sp.quantum - 1
        sp.feed(frames[:n])
        profile_run(torch, f"streaming B=1 {name}, one emission",
                    lambda: check(len(sp.feed(frames[n:n + 1])) == 1,
                                  "the profiled feed did not emit"))
    check(at[0] == sp.latency_frames
          and len(walls) == (N_LATENCY - at[0]) // sp.quantum + 1
          and all(b - a == sp.quantum for a, b in zip(at, at[1:])),
          f"B=1 {name}: emissions after frames {at[:4]}...")
    calls = len(walls) if pred.int8_encoder else 0
    check(counts[smpl_cuda.KERNEL_NAME] == len(walls)
          and counts[K.CONV] == 52 * calls and counts[K.PREACT] == calls,
          f"B=1 {name}: launches {counts} for {len(walls)} emissions")
    q1, med, q3 = np.percentile(walls[1:], [25, 50, 75])
    print(f"streaming latency [{card}] B=1 {name}: first emission (the "
          f"feed of frame {at[0]}: {at[0]} frames encoded + one window "
          f"group) {walls[0]:.3f} ms; the next {len(walls) - 1} emissions "
          f"(8 frames encoded + one window group each, synchronised) median "
          f"{med:.3f} ms, quartiles {q1:.3f}-{q3:.3f} ms; launches {counts}")
    return {"first_ms": walls[0], "median_ms": float(med), "q1_ms": float(q1),
            "q3_ms": float(q3), "n": len(walls) - 1}


def phase_service(torch, bench, clips, stream_clip, stream_want, K,
                  smpl_cuda, card):
    """Phase 9: 4 submitting threads and a live stream on one service, run
    twice, in turns with the same work done by direct calls."""
    import threading

    from human_dynamics_tpu_torch.infer import (
        PredictionService,
        StreamingPredictor,
    )

    direct = [bench.predict_all_images(c, as_numpy=False) for c in clips]
    n_frames = len(clips) * len(clips[0]) + len(stream_clip)
    chunks = -(-len(clips[0]) // bench.encode_chunk)
    calls, emits = stream_encoder_calls(StreamingPredictor(bench),
                                        len(stream_clip))
    enc = len(clips) * chunks + calls
    want_counts = {smpl_cuda.KERNEL_NAME: len(clips) + emits,
                   K.CONV: 52 * enc, K.PREACT: enc, K.BLOCK: 0}

    def by_direct_calls():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in clips:
            bench.predict_all_images(c, as_numpy=False)
        feed_pieces(StreamingPredictor(bench), stream_clip, STREAM_PIECES)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def through_service():
        results, errors = [None] * len(clips), []

        def worker(i):
            try:
                results[i] = service.submit(clips[i]).result(timeout=600)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(clips))]
        torch.cuda.synchronize()
        reset_all(K, smpl_cuda)
        t0 = time.perf_counter()
        with PredictionService(bench) as service:
            session = service.open_stream()
            for t in threads:
                t.start()
            futs, i, j = [], 0, 0
            while i < len(stream_clip):
                n = STREAM_PIECES[j % len(STREAM_PIECES)]
                futs.append(session.feed(stream_clip[i:i + n]))
                i, j = i + n, j + 1
            futs.append(session.flush())
            emissions = [e for f in futs for e in f.result(timeout=600)]
            for t in threads:
                t.join(timeout=600)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            stats = service.stats()
        counts, _ = read_counts(K, smpl_cuda)
        check(not errors and not any(t.is_alive() for t in threads),
              f"service: submitters failed: {errors}")
        for i, (got, want) in enumerate(zip(results, direct)):
            check(set(got) == set(want), f"service clip {i}: keys differ")
            for k in want:
                check(torch.equal(got[k], want[k]),
                      f"service clip {i}: {k} differs from a direct call")
        check_stream(torch, "service stream", bench, emissions, stream_want)
        want_stats = {"submitted": len(clips) + len(futs),
                      "completed": len(clips) + len(futs), "failed": 0,
                      "frames": n_frames}
        check(stats == want_stats, f"service stats {stats}, want "
              f"{want_stats}")
        check(counts == want_counts, f"service launches {counts}, want "
              f"{want_counts}")
        print(f"service: {len(clips)} submitting threads of "
              f"{len(clips[0])}-frame clips + one open_stream of "
              f"{len(stream_clip)} frames ({len(futs)} requests): results "
              f"equal to direct calls, stats {stats}, launches {counts}")
        return seconds

    walls = {"direct": [], "service": []}
    for how in ("direct", "service", "service", "direct"):
        walls[how].append(by_direct_calls() if how == "direct"
                          else through_service())
    print(f"service [{card}], {n_frames} frames, in turns direct, service, "
          f"service, direct: through the service " + ", ".join(
              f"{s * 1e3:.2f} ms = {n_frames / s:.1f} frames/s"
              for s in walls["service"]) + "; by direct calls " + ", ".join(
              f"{s * 1e3:.2f} ms = {n_frames / s:.1f} frames/s"
              for s in walls["direct"]))
    return walls


def write_test_records(np, root, phis_by_dataset):
    """One test record of one tube per dataset, phis from the encoder."""
    from human_dynamics_tpu_torch.data import (
        TFRecordWriter,
        convert_to_example_temporal,
    )

    names = {"h36m": "S9_Walking_cam03", "3dpw": "downtown_walking_00"}
    rng = np.random.RandomState(6)
    for dataset, phis in phis_by_dataset.items():
        n = len(phis)
        labels = rng.rand(n, 3, SMPL_KPS).astype(np.float32) * IMG
        labels[:, 2] = rng.rand(n, SMPL_KPS) > 0.2
        d = os.path.join(root, dataset, "test")
        os.makedirs(d)
        path = os.path.join(d, names[dataset] + ".tfrecord")
        with TFRecordWriter(path) as w:
            w.write(convert_to_example_temporal(
                image_datas=None,
                image_paths=[f"{i:06d}.jpg" for i in range(n)],
                image_shapes=np.full((n, 2), IMG),
                labels=labels,
                centers=rng.randint(0, IMG, (n, 2)),
                gt3ds=rng.randn(n, 14, 3).astype(np.float32) * 0.3,
                scale_factors=rng.rand(n, 2).astype(np.float32),
                start_pts=rng.randint(0, 50, (n, 2)),
                cams=rng.rand(n, 3).astype(np.float32),
                poses=rng.randn(n, 72).astype(np.float32) * 0.2,
                shape=rng.randn(10).astype(np.float32) * 0.3,
                phis=phis,
                time_pts=np.array([0, n]),
            ))


def phase_eval(torch, np, fast, frames, K, smpl_cuda, card):
    """Phase 10: the Evaluator on h36m and 3dpw phi records."""
    import tempfile

    from human_dynamics_tpu_torch.eval.harness import Evaluator

    phis = fast.encode_frames(frames[:2 * N_TUBE]).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        records = os.path.join(tmp, "records")
        write_test_records(np, records, {"h36m": phis[:N_TUBE],
                                         "3dpw": phis[N_TUBE:]})
        results, walls = {}, {True: [], False: []}
        for rep, device_metrics in enumerate((True, False, True, False)):
            ev = Evaluator(fast, os.path.join(tmp, f"out{rep}"),
                           device_metrics=device_metrics)
            reset_all(K, smpl_cuda)
            t0 = time.perf_counter()
            results[device_metrics] = ev.run(records, ["h36m"])["h36m"]
            walls[device_metrics].append((time.perf_counter() - t0) * 1e3)
            counts, _ = read_counts(K, smpl_cuda)
            check(counts == {smpl_cuda.KERNEL_NAME: 1, K.CONV: 0,
                             K.PREACT: 0, K.BLOCK: 0},
                  f"eval h36m launches {counts}: want K1 once per tube")
        dev, host = results[True], results[False]
        check(set(dev) == set(host) and len(dev) == 7,
              f"eval h36m keys {sorted(dev)} vs {sorted(host)}")
        for k in sorted(host):
            check(abs(dev[k] - host[k])
                  <= EVAL_ATOL + EVAL_RTOL * abs(host[k]),
                  f"eval h36m {k}: device {dev[k]} vs numpy {host[k]}")
        print(f"eval h36m, device_metrics on vs off (rtol {EVAL_RTOL}, atol "
              f"{EVAL_ATOL}): " + ", ".join(
                  f"{k} {dev[k]:.5f}/{host[k]:.5f}" for k in sorted(host)))
        ev = Evaluator(fast, os.path.join(tmp, "out_3dpw"),
                       device_metrics=True)
        reset_all(K, smpl_cuda)
        tdpw = ev.run(records, ["3dpw"])["3dpw"]
        counts, _ = read_counts(K, smpl_cuda)
        check(counts[smpl_cuda.KERNEL_NAME] == 1,
              f"eval 3dpw launches {counts}")
        check(len(tdpw) == 9 and all(np.isfinite(v) for v in tdpw.values()),
              f"eval 3dpw (mesh included): {tdpw}")
        print("eval 3dpw, device_metrics, mesh included: " + ", ".join(
            f"{k} {v:.5f}" for k, v in sorted(tdpw.items())))
    print(f"eval [{card}] one {N_TUBE}-frame h36m tube (--fast: fused SMPL + "
          f"bf16 encoder, phi records; record read, prediction, metrics), "
          f"in turns device, numpy, device, numpy: device_metrics "
          f"{', '.join(f'{w:.2f}' for w in walls[True])} ms, numpy metrics "
          f"{', '.join(f'{w:.2f}' for w in walls[False])} ms per tube (the "
          f"first device run pays one-time setup)")
    return {"device_ms": walls[True][-1], "numpy_ms": walls[False][-1]}


def phase_tf32(torch, np, dev):
    """Phase 11: the fp32 predictor on the card against the CPU, cuDNN's
    TF32 on and off."""
    import contextlib

    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.infer import HmmrPredictor
    from human_dynamics_tpu_torch.infer import predictor as P
    from human_dynamics_tpu_torch.models import HmmrModel

    model = HmmrModel(include_resnet=True, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS)
    clip = torch.randint(0, 256, (N_TF32, IMG, IMG, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(4))
    t0 = time.perf_counter()
    ref = HmmrPredictor(model, None, smpl, device="cpu").predict_all_images(
        clip, as_numpy=False)
    cpu_s = time.perf_counter() - t0
    pred = HmmrPredictor(model, None, smpl, use_fused_smpl=True, device=dev)
    guard = P.full_fp32
    runs = {"cudnn.allow_tf32=True, unguarded": (True, contextlib.nullcontext),
            "cudnn.allow_tf32=True": (True, guard),
            "cudnn.allow_tf32=False": (False, guard)}
    prev = torch.backends.cudnn.allow_tf32
    errs = {}
    try:
        for name, (tf32, ctx) in runs.items():
            torch.backends.cudnn.allow_tf32 = tf32
            P.full_fp32 = ctx
            out = pred.predict_all_images(clip.to(dev), as_numpy=False)
            errs[name] = {k: max_abs(out[k].cpu(), ref[k])
                          for k in ("omegas", "joints", "verts")}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        P.full_fp32 = guard
    for name, e in errs.items():
        print(f"TF32 check, fp32 predictor, {N_TF32} frames, card vs CPU "
              f"({cpu_s:.1f} s on the CPU), {name}: " +
              ", ".join(f"{k} {v:.3e}" for k, v in e.items()) +
              f" (omegas bound {TF32_OMEGA_TOL:g} when guarded)")
    for name in list(runs)[1:]:
        check(errs[name]["omegas"] <= TF32_OMEGA_TOL,
              f"fp32 predictor, {name}: omegas {errs[name]['omegas']}")
    return errs


def train_batch(torch, config, dev, seed):
    """A training batch made on `dev` from a seeded generator, as
    scripts/bench_train.py's synthetic_batch makes it (all labels present,
    the mocap pool as rotations)."""
    from human_dynamics_tpu_torch.core import rodrigues
    from human_dynamics_tpu_torch.train.trainer import Batch, fake_pool_size

    g = torch.Generator(device=dev).manual_seed(seed)
    b, t = config.batch_size, config.T
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    kps = randn(b, t, config.num_kps, 3)
    kps[..., 2] = 1.0
    return Batch(
        phis=randn(b, t, config.feature_dim), kps=kps,
        poses_gt=randn(b, t, 24, 3) * 0.2, shapes_gt=randn(b, 10) * 0.3,
        joints_gt=randn(b, t, 14, 3), has_3d_joints=torch.ones(b, device=dev),
        has_3d_smpl=torch.ones(b, device=dev),
        poses_real=rodrigues(randn(fake_pool_size(config), 24, 3) * 0.2),
    )


def losses_and_grads(torch, config, state, smpl, batch, consts):
    """compute_losses(train=False) and d(e_loss + d_loss)/d(parameter),
    fp32 without TF32: ({loss: value}, {"e."/"d." + name: gradient})."""
    from human_dynamics_tpu_torch.train.trainer import compute_losses
    from human_dynamics_tpu_torch.utils.precision import full_fp32

    named = ([("e." + n, p) for n, p in state.hmmr.named_parameters()]
             + [("d." + n, p) for n, p in state.disc.named_parameters()])
    with full_fp32():
        e, d, m = compute_losses(config, state.hmmr, state.disc, smpl, batch,
                                 train=False, fused_constants=consts)
        grads = torch.autograd.grad(e + d, [p for _, p in named])
    return ({k: v.detach() for k, v in m.items()},
            {n: g for (n, _), g in zip(named, grads)})


@contextlib.contextmanager
def relu_inputs(torch, state):
    """Collects the output of every Linear layer and every ResNet
    BatchNorm of the HMMR model and the discriminator while inside, in call
    order (all but the last layer of each MLP, and every BatchNorm, feed a
    ReLU)."""
    from human_dynamics_tpu_torch.models.resnet import SlimBatchNorm

    acts, hooks = [], []
    for m in (state.hmmr, state.disc):
        for mod in m.modules():
            if isinstance(mod, (torch.nn.Linear, SlimBatchNorm)):
                hooks.append(mod.register_forward_hook(
                    lambda _m, _i, out: acts.append(out.detach())))
    try:
        yield acts
    finally:
        for h in hooks:
            h.remove()


def _write_phi_shard(np, rng, path, phi_dim):
    """One shard of 3 phi tubes of 30 frames each."""
    from human_dynamics_tpu_torch.data import (
        TFRecordWriter,
        convert_to_example_temporal,
    )

    with TFRecordWriter(path) as w:
        for _ in range(3):
            n = 30
            labels = rng.rand(n, 3, SMPL_KPS).astype(np.float32)
            labels[:, 2] = rng.rand(n, SMPL_KPS) > 0.2
            w.write(convert_to_example_temporal(
                image_datas=None,
                image_paths=[f"{i:06d}.jpg" for i in range(n)],
                image_shapes=np.full((n, 2), IMG), labels=labels,
                centers=rng.randint(0, IMG, (n, 2)),
                gt3ds=rng.randn(n, 14, 3).astype(np.float32) * 0.3,
                scale_factors=rng.rand(n, 2).astype(np.float32),
                start_pts=rng.randint(0, 50, (n, 2)),
                cams=rng.rand(n, 3).astype(np.float32),
                poses=rng.randn(n, 72).astype(np.float32) * 0.2,
                shape=rng.randn(10).astype(np.float32) * 0.3,
                phis=rng.randn(n, phi_dim).astype(np.float32),
            ))


def write_train_records(np, root, phi_dim, shards=1):
    """Phi training records (h36m and insta_variety, `shards` shards of 3
    tubes of 30 frames each), mocap records, and the SMPL model as an npz;
    returns the npz's path."""
    from human_dynamics_tpu_torch.data import TFRecordWriter, encode_example

    rng = np.random.RandomState(12)
    for dataset in ("h36m", "insta_variety"):
        d = os.path.join(root, dataset, "train")
        os.makedirs(d)
        for shard in range(shards):
            _write_phi_shard(np, rng, os.path.join(
                d, f"shard_{shard}.tfrecord"), phi_dim)
    d = os.path.join(root, "mocap_neutrMosh")
    os.makedirs(d)
    with TFRecordWriter(os.path.join(d, "neutrSMPL_CMU_0.tfrecord")) as w:
        for _ in range(1000):
            w.write(encode_example({
                "pose": rng.randn(72).astype(np.float32) * 0.2,
                "shape": rng.randn(10).astype(np.float32) * 0.3}))
    return write_smpl_npz(np, root)


def write_smpl_npz(np, root):
    """The synthetic SMPL model as an npz in `root`; returns its path."""
    from human_dynamics_tpu_torch.core import synthetic_smpl_model

    smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS)
    path = os.path.join(root, "smpl.npz")
    np.savez(path, parents=np.array(smpl.parents),
             cocoplus_regressor=smpl.joint_regressor.numpy(),
             **{k: getattr(smpl, k).numpy() for k in (
                 "v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights")})
    return path


def phase_train(torch, np, dev, smpl, K, smpl_cuda, card):
    """Phase 12: phi-mode training at full width."""
    import dataclasses
    import tempfile

    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.eval.harness import load_model_variables
    from human_dynamics_tpu_torch.infer import HmmrPredictor
    from human_dynamics_tpu_torch.models import HmmrModel
    from human_dynamics_tpu_torch.ops.smpl_cuda import prepare_fused_constants
    from human_dynamics_tpu_torch.train import main as train_main
    from human_dynamics_tpu_torch.train.trainer import (
        Trainer,
        create_train_state,
    )
    from human_dynamics_tpu_torch.utils.config import Config
    from human_dynamics_tpu_torch.utils.weights import load_jax_variables

    t_phase = time.perf_counter()
    config = Config(batch_size=TRAIN_B, T=TRAIN_T, feature_dim=TRAIN_C,
                    num_kps=SMPL_KPS, use_fused_smpl=True)
    unfused = dataclasses.replace(config, use_fused_smpl=False)
    fused_tr = Trainer(config, smpl, device=dev)
    batch = train_batch(torch, config, dev, seed=7)
    st = fused_tr.state
    n_params = sum(p.numel() for m in (st.hmmr, st.disc)
                   for p in m.parameters())
    print(f"train: Config(batch_size={TRAIN_B}, T={TRAIN_T}, feature_dim="
          f"{TRAIN_C}, num_kps={SMPL_KPS}), {n_params / 1e6:.2f} M "
          f"parameters (HMMR phi model + discriminator)")

    # Fused against unfused: every loss and every gradient.
    reset_all(K, smpl_cuda)
    with relu_inputs(torch, st) as card_acts:
        lf, gf = losses_and_grads(torch, config, st, fused_tr.smpl, batch,
                                  fused_tr.fused_constants)
    torch.cuda.synchronize()
    check(read_counts(K, smpl_cuda)[0][smpl_cuda.KERNEL_NAME] == 1,
          "the fused loss evaluation did not launch K1 once")
    lu, gu = losses_and_grads(torch, unfused, st, fused_tr.smpl, batch, None)
    loss_err = {k: abs(float(lf[k]) - float(lu[k])) for k in lf}
    for k in lf:
        check(torch.allclose(lf[k], lu[k], atol=GRAD_ATOL, rtol=GRAD_RTOL),
              f"train loss {k}: fused {float(lf[k])} unfused {float(lu[k])}")
    for n in gf:
        check(torch.allclose(gf[n], gu[n], atol=GRAD_ATOL, rtol=GRAD_RTOL),
              f"train gradient {n}: fused vs unfused differ by "
              f"{max_abs(gf[n], gu[n])}")
    print(f"train fused vs unfused (atol {GRAD_ATOL}, rtol {GRAD_RTOL}): "
          f"e_loss {float(lf['e_loss']):.6f}/{float(lu['e_loss']):.6f}, "
          f"d_loss {float(lf['d_loss']):.6f}/{float(lu['d_loss']):.6f}; "
          f"max loss diff {max(loss_err.values()):.3e}, max gradient diff "
          f"{max(max_abs(gf[n], gu[n]) for n in gf):.3e} over {len(gf)} "
          f"parameters")

    # The card against the same state on the CPU.
    cpu_state = create_train_state(config, "cpu",
                                   torch.Generator().manual_seed(0))
    cpu_state.hmmr.load_state_dict(st.hmmr.state_dict())
    cpu_state.disc.load_state_dict(st.disc.state_dict())
    cpu_smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS)
    cpu_batch = type(batch)(*[x.cpu() for x in batch])
    t0 = time.perf_counter()
    with relu_inputs(torch, cpu_state) as cpu_acts:
        lc, gc = losses_and_grads(torch, config, cpu_state, cpu_smpl,
                                  cpu_batch, prepare_fused_constants(cpu_smpl))
    cpu_s = time.perf_counter() - t0
    flips = sum(int(((a > 0) != (b.cpu() > 0)).sum())
                for a, b in zip(cpu_acts, card_acts))
    n_acts = sum(a.numel() for a in cpu_acts)
    loss_rel = {k: abs(float(lf[k]) - float(lc[k])) / abs(float(lc[k]))
                for k in lc}
    grad_l2 = {n: float((gf[n].cpu() - gc[n]).norm() / gc[n].norm())
               for n in gc}
    grad_max = {n: max_abs(gf[n].cpu(), gc[n]) / float(gc[n].abs().max())
                for n in gc}
    worst_l = max(loss_rel, key=loss_rel.get)
    worst_g = max(grad_l2, key=grad_l2.get)
    worst_m = max(grad_max, key=grad_max.get)
    print(f"train card vs CPU (the same state; {cpu_s:.1f} s on the CPU): "
          f"largest relative loss error {loss_rel[worst_l]:.3e} ({worst_l}; "
          f"bound {TRAIN_LOSS_RTOL:g}); largest relative L2 gradient error "
          f"{grad_l2[worst_g]:.3e} ({worst_g}; bound {TRAIN_GRAD_REL:g}); "
          f"largest gradient element error relative to its parameter's "
          f"largest element {grad_max[worst_m]:.3e} ({worst_m}); Linear "
          f"outputs of opposite sign on the card and the CPU: {flips} of "
          f"{n_acts}")
    for k, v in loss_rel.items():
        check(v <= TRAIN_LOSS_RTOL, f"train card vs CPU: {k} off by {v}")
    for n, v in grad_l2.items():
        check(v <= TRAIN_GRAD_REL, f"train card vs CPU: d/d{n} off by {v}")
    del cpu_state, gc, gu, cpu_acts, card_acts

    # K1 once per fused step, never per unfused step.
    unfused_tr = Trainer(unfused, smpl, device=dev)
    for tr, want in ((fused_tr, 1), (unfused_tr, 0)):
        reset_all(K, smpl_cuda)
        tr.step(batch)
        torch.cuda.synchronize()
        got = read_counts(K, smpl_cuda)[0][smpl_cuda.KERNEL_NAME]
        check(got == want, f"train step launched K1 {got} times, want {want}")

    # The main path: N_LEARN steps on the fixed batch.
    reset_all(K, smpl_cuda)
    hist = [fused_tr.step(batch) for _ in range(N_LEARN)]
    torch.cuda.synchronize()
    counts, _ = read_counts(K, smpl_cuda)
    e_losses = [float(m["e_loss"]) for m in hist]
    check(all(np.isfinite(float(v)) for m in hist for v in m.values()),
          "train: a loss is not finite")
    check(counts == {smpl_cuda.KERNEL_NAME: N_LEARN, K.CONV: 0, K.PREACT: 0,
                     K.BLOCK: 0},
          f"train: launches {counts} over {N_LEARN} fused steps")
    check(e_losses[-1] < e_losses[0], f"train: e_loss did not fall: "
          f"{e_losses}")
    print(f"train {N_LEARN} fused steps on one batch: e_loss "
          f"{e_losses[0]:.4f} -> {e_losses[-1]:.4f}, d_loss "
          f"{float(hist[0]['d_loss']):.4f} -> {float(hist[-1]['d_loss']):.4f}"
          f"; launches {counts}")

    # End to end: records -> train.main -> checkpoint -> restore, predict.
    with tempfile.TemporaryDirectory() as tmp:
        smpl_path = write_train_records(np, os.path.join(tmp, "data"),
                                        TRAIN_C)
        model_dir = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        run = train_main.main([
            "--data_dir", os.path.join(tmp, "data"), "--model_dir",
            model_dir, "--smpl_model_path", smpl_path, "--datasets", "h36m",
            "insta_variety", "--batch_size", str(TRAIN_B), "--T",
            str(TRAIN_T), "--feature_dim", str(TRAIN_C), "--num_kps",
            str(SMPL_KPS), "--use_fused_smpl", "--log_step", "1",
            "--num_steps", "3",
        ])
        main_s = time.perf_counter() - t0
        ckpt = os.path.join(model_dir, "ckpt-3.npz")
        check(os.path.exists(ckpt) and run.state.step == 3,
              f"train.main wrote {sorted(os.listdir(model_dir))}")
        restored = Trainer(dataclasses.replace(config, model_dir=model_dir),
                           smpl, device=dev)
        check(restored.state.step == 3, "the restored Trainer is not at 3")
        for a, b in ((run.state.hmmr, restored.state.hmmr),
                     (run.state.disc, restored.state.disc)):
            for (n, p), (_, q) in zip(a.named_parameters(),
                                      b.named_parameters()):
                check(torch.equal(p, q), f"restored parameter {n} differs")
        for opt_a, opt_b in ((run.state.opt_e, restored.state.opt_e),
                             (run.state.opt_d, restored.state.opt_d)):
            for p, q in zip(opt_a.param_groups[0]["params"],
                            opt_b.param_groups[0]["params"]):
                for key in ("exp_avg", "exp_avg_sq"):
                    check(torch.equal(opt_a.state[p][key],
                                      opt_b.state[q][key]),
                          f"restored Adam {key} differs")
        model = HmmrModel(feature_dim=TRAIN_C, device="meta")
        model = load_jax_variables(model.to_empty(device="cpu"),
                                   load_model_variables(ckpt))
        pred = HmmrPredictor(model, None, smpl, batch_size=TRAIN_B,
                             seq_length=TRAIN_T, use_fused_smpl=True,
                             device=dev)
        phis = torch.randn(100, TRAIN_C, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(9))
        reset_all(K, smpl_cuda)
        out = pred.predict_all_images(phis, as_numpy=False)
        torch.cuda.synchronize()
        check(read_counts(K, smpl_cuda)[0][smpl_cuda.KERNEL_NAME] == 1,
              "the predictor on the trained checkpoint did not launch K1")
        check(tuple(out["verts"].shape) == (100, SMPL_VERTS, 3)
              and all(bool(torch.isfinite(v).all()) for v in out.values()),
              "the predictor on the trained checkpoint: bad outputs")
        print(f"train.main: 3 steps on phi records in {main_s:.2f} s "
              f"(pipeline, model init, steps, a {os.path.getsize(ckpt) / 2**20:.0f}"
              f" MiB checkpoint); a fresh Trainer restored step 3 with equal "
              f"parameters and moments; HmmrPredictor on the checkpoint: "
              f"100 frames, finite, K1 once")
        del run, restored, model, pred, out

    # Smoke timing, in turns, after a warm-up.
    bf16_tr = Trainer(dataclasses.replace(config, use_bfloat16=True), smpl,
                      device=dev)
    trainers = {"fp32 fused": fused_tr, "fp32 unfused": unfused_tr,
                "bf16 fused": bf16_tr}
    step_mem = {}
    for name, tr in trainers.items():
        tr.step(batch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tr.step(batch)
        torch.cuda.synchronize()
        step_mem[name] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    times = {name: [] for name in trainers}
    order = list(trainers)
    for name in order + order[::-1] + order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_TIMED_STEPS):
            trainers[name].step(batch)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / N_TIMED_STEPS)
    for name, ts in times.items():
        print(f"smoke timing (not a benchmark) [{card}]: train step {name}, "
              f"B={TRAIN_B} T={TRAIN_T} feature_dim={TRAIN_C}: "
              f"{float(np.median(ts)):.2f} ms/step (median of {len(ts)} "
              f"turns of {N_TIMED_STEPS} synchronised steps; all "
              f"{[round(x, 2) for x in ts]}); the step's device memory "
              f"above the resident state {step_mem[name]:.2f} GiB")
    print(f"train: device memory allocated at the end of phase 12 (the "
          f"three trainers and earlier phases' models and inputs) "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    k1_share = None
    if PROFILE:
        events, total = profile_run(torch, "train step, fp32 fused",
                                    lambda: fused_tr.step(batch))
        k1_ms = sum(e.self_device_time_total for e in events
                    if "blend_skin_kernel" in e.key) / 1e3
        k1_share = k1_ms / total
        print(f"profile, train step: K1 {k1_ms:.3f} ms of {total:.2f} ms "
              f"kernel time ({k1_share * 100:.1f}%)")
    print(f"phase 12 (training) took {time.perf_counter() - t_phase:.1f} s")
    return {"train_launches": counts[smpl_cuda.KERNEL_NAME],
            "train_steps": N_LEARN,
            "ms_per_step": {k: float(np.median(v)) for k, v in times.items()},
            "k1_share": k1_share}


def image_inputs(torch, config, dev, seed, rotate_max):
    """B tubes of uint8 frames (FRAME x FRAME) with keypoints, centres,
    poses and joints, made on `dev` from a seeded generator, and augment
    parameters sampled there."""
    from human_dynamics_tpu_torch.data.augment import sample_tube_params

    g = torch.Generator(device=dev).manual_seed(seed)
    b, t, k = config.batch_size, config.T, config.num_kps
    labels = torch.rand(b, t, 3, k, generator=g, device=dev) * FRAME * 0.5
    labels[:, :, :2] += FRAME * 0.25
    labels[:, :, 2] = (labels[:, :, 2] > FRAME * 0.05).float()
    tubes = dict(
        images=torch.randint(0, 256, (b, t, FRAME, FRAME, 3), generator=g,
                             device=dev, dtype=torch.uint8),
        labels=labels,
        centers=torch.full((b, t, 2), FRAME / 2, device=dev),
        poses=torch.randn(b, t, 72, generator=g, device=dev) * 0.2,
        gt3ds=torch.randn(b, t, 14, 3, generator=g, device=dev) * 0.3,
    )
    params = sample_tube_params(
        g, b, t, trans_max=config.trans_max,
        delta_trans_max=config.delta_trans_max, scale_max=config.scale_max,
        delta_scale_max=config.delta_scale_max, rotate_max=rotate_max,
        delta_rotate_max=config.delta_rotate_max)
    return tubes, params, g


def image_batch(torch, config, dev, seed):
    """A training batch as TrainDataPipeline makes one in image mode: the
    tubes through data.augment.augment_batch on `dev`."""
    from human_dynamics_tpu_torch.core import rodrigues
    from human_dynamics_tpu_torch.data.augment import augment_batch
    from human_dynamics_tpu_torch.train.trainer import Batch, fake_pool_size

    tubes, params, g = image_inputs(torch, config, dev, seed,
                                    config.rotate_max)
    crops, kps, poses, gt3ds = augment_batch(
        *tubes.values(), params, output_size=config.img_size,
        apply_rotation=config.rotate_max != 0)
    b, t = config.batch_size, config.T
    return Batch(
        phis=crops, kps=kps, poses_gt=poses.reshape(b, t, 24, 3),
        shapes_gt=torch.randn(b, 10, generator=g, device=dev) * 0.3,
        joints_gt=gt3ds, has_3d_joints=torch.ones(b, device=dev),
        has_3d_smpl=torch.ones(b, device=dev),
        poses_real=rodrigues(torch.randn(fake_pool_size(config), 24, 3,
                                         generator=g, device=dev) * 0.2))


def check_augment_card_vs_cpu(torch, config, dev):
    """augment_batch on the card against the CPU on the same tubes and
    parameters (rotation on); returns the largest errors."""
    from human_dynamics_tpu_torch.data.augment import (
        TubeAugmentParams,
        augment_batch,
    )

    tubes, params, _ = image_inputs(torch, config, dev, 21, rotate_max=0.2)
    card = augment_batch(*tubes.values(), params,
                         output_size=config.img_size, apply_rotation=True)
    cpu = augment_batch(*[x.cpu() for x in tubes.values()],
                        TubeAugmentParams(*[x.cpu() for x in params]),
                        output_size=config.img_size, apply_rotation=True)
    errs = {n: max_abs(c.cpu(), w) for n, c, w in
            zip(("crops", "kps", "poses", "gt3ds"), card, cpu)}
    print("augment_batch card vs CPU, the same parameters (rotation on): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bounds {AUG_PIXEL_ATOL:g} crops, {AUG_LABEL_ATOL:g} labels)")
    for n, e in errs.items():
        bound = AUG_PIXEL_ATOL if n == "crops" else AUG_LABEL_ATOL
        check(e <= bound, f"augment card vs CPU: {n} off by {e}")
    return errs


def resnet_state(torch, hmmr):
    """Copies of the ResNet's parameters and BatchNorm buffers."""
    rn = hmmr.resnet_v2_50
    return ({n: p.detach().clone() for n, p in rn.named_parameters()},
            {n: b.clone() for n, b in rn.named_buffers()})


def write_image_records(np, root):
    """raw_u8 image records (h36m and insta_variety, 2 tubes of 24 frames
    of FRAME x FRAME each) and mocap records; the card's machine has no
    cv2, so no JPEG."""
    from human_dynamics_tpu_torch.data import (
        TFRecordWriter,
        convert_to_example_temporal,
        encode_example,
    )

    rng = np.random.RandomState(13)
    for dataset in ("h36m", "insta_variety"):
        d = os.path.join(root, dataset, "train")
        os.makedirs(d)
        with TFRecordWriter(os.path.join(d, "shard_0.tfrecord")) as w:
            for _ in range(2):
                n = 24
                labels = np.zeros((n, 3, SMPL_KPS), np.float32)
                labels[:, :2] = rng.uniform(FRAME * 0.25, FRAME * 0.75,
                                            (n, 2, SMPL_KPS))
                labels[:, 2] = rng.rand(n, SMPL_KPS) > 0.2
                w.write(convert_to_example_temporal(
                    image_datas=[rng.randint(0, 256, (FRAME, FRAME, 3))
                                 .astype(np.uint8).tobytes()
                                 for _ in range(n)],
                    image_paths=[f"{i:06d}.jpg" for i in range(n)],
                    image_shapes=np.full((n, 2), FRAME), labels=labels,
                    centers=np.full((n, 2), FRAME // 2),
                    gt3ds=rng.randn(n, 14, 3).astype(np.float32) * 0.3,
                    scale_factors=np.ones((n, 2), np.float32),
                    start_pts=np.zeros((n, 2), np.int64),
                    cams=np.ones((n, 3), np.float32),
                    poses=rng.randn(n, 72).astype(np.float32) * 0.2,
                    shape=rng.randn(10).astype(np.float32) * 0.3,
                    image_format="raw_u8",
                ))
    d = os.path.join(root, "mocap_neutrMosh")
    os.makedirs(d)
    with TFRecordWriter(os.path.join(d, "neutrSMPL_CMU_0.tfrecord")) as w:
        for _ in range(1000):
            w.write(encode_example({
                "pose": rng.randn(72).astype(np.float32) * 0.2,
                "shape": rng.randn(10).astype(np.float32) * 0.3}))


def image_card_vs_cpu(torch, np, dev, smpl, config):
    """compute_losses(train=True) and its gradients at B=1, T=IMG_CPU_T,
    full width, every head, the whole trunk trained, fp32 without TF32: the
    card against the same state on the CPU, and both against a float64 run
    on the CPU (unfused SMPL, K1 being fp32). Dropout is off (rate 0) so
    that every run is the same network; train-mode BatchNorm advances the
    moving averages.

    The gradients are held to the float64 run, not to the CPU's fp32 ones:
    each of the ~58 M ReLU inputs (Linear and BatchNorm outputs) within a
    rounding error of 0 takes its side by the rounding. A flip in a 7x7
    block-4 map moves every earlier layer's gradient through the BatchNorm
    backward's channel means, and at B*T = 8 rows one flip in a head's MLP
    is 1/8 of a column of its weight's gradient, so on this input the CPU's
    fp32 gradients are themselves up to ~2e-2 (relative L2) from float64
    (phase 12's 160 rows keep a flip at 2e-4); with every ReLU made a
    smooth softplus that error goes. The card's largest distance from
    float64 is held to at most twice the CPU's, plus TRAIN_GRAD_REL."""
    import dataclasses

    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.models.ief import IefRegressor
    from human_dynamics_tpu_torch.ops.smpl_cuda import prepare_fused_constants
    from human_dynamics_tpu_torch.train.trainer import (
        compute_losses,
        create_train_state,
    )
    from human_dynamics_tpu_torch.utils.precision import full_fp32

    def run(state, cfg, smpl_, batch, consts, gen):
        for m in state.hmmr.modules():
            if isinstance(m, IefRegressor):
                m.dropout_rate = 0.0
        named = ([("e." + n, p) for n, p in state.hmmr.named_parameters()]
                 + [("d." + n, p) for n, p in state.disc.named_parameters()])
        with relu_inputs(torch, state) as acts, full_fp32():
            e, d, m = compute_losses(cfg, state.hmmr, state.disc, smpl_,
                                     batch, train=True, generator=gen,
                                     fused_constants=consts)
            grads = torch.autograd.grad(e + d, [p for _, p in named])
        stats = {n: b.clone() for n, b in state.hmmr.named_buffers()}
        return ({k: float(v.detach()) for k, v in m.items()},
                {n: g for (n, _), g in zip(named, grads)}, stats, acts)

    card_state = create_train_state(
        config, dev, torch.Generator(device=dev).manual_seed(config.seed))
    cpu_state = create_train_state(config, "cpu",
                                   torch.Generator().manual_seed(0))
    cpu_state.hmmr.load_state_dict(card_state.hmmr.state_dict())
    cpu_state.disc.load_state_dict(card_state.disc.state_dict())
    start = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in (cpu_state.hmmr, cpu_state.disc)]
    batch = image_batch(torch, config, dev, seed=23)
    cpu_batch = type(batch)(*[x.cpu() for x in batch])
    cpu_smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS)
    lc_, gc_, sc_, ac_ = run(card_state, config, smpl, batch,
                             prepare_fused_constants(smpl),
                             torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    lp_, gp_, sp_, ap_ = run(cpu_state, config, cpu_smpl, cpu_batch,
                             prepare_fused_constants(cpu_smpl),
                             torch.Generator().manual_seed(0))
    cpu_s = time.perf_counter() - t0
    for m, sd in zip((cpu_state.hmmr, cpu_state.disc), start):
        m.load_state_dict(sd)
        m.double()
    _, g64, _, _ = run(cpu_state, dataclasses.replace(
        config, use_fused_smpl=False), cpu_smpl.to(torch.float64),
        type(batch)(*[x.double() for x in cpu_batch]), None,
        torch.Generator().manual_seed(0))
    flips = sum(int(((a > 0) != (b.cpu() > 0)).sum())
                for a, b in zip(ap_, ac_))
    n_acts = sum(a.numel() for a in ap_)
    loss_rel = {k: abs(lc_[k] - lp_[k]) / max(abs(lp_[k]), 1e-30)
                for k in lp_}
    stats_err = {n: max_abs(sc_[n].cpu(), sp_[n]) for n in sp_}
    # The ResNet's root, conv3 and shortcut biases reach the loss only
    # through train-mode BatchNorms, which remove any per-channel constant:
    # their gradients are zero in exact arithmetic (float64 gives ~1e-14),
    # rounding noise on both devices. They are held to be noise (below
    # 1e-3 of their convolution weight's gradient, in L2).
    resnet = {n for n in gp_ if n.startswith("e.resnet_v2_50.")}
    shadowed = {n for n in resnet if n == "e.resnet_v2_50.conv1.bias"
                or n.endswith((".conv3.bias", ".shortcut.bias"))}
    noise = {n: max(float(g[n].norm()) for g in (gp_, gc_))
             / float(gp_[n[:-len("bias")] + "weight"].norm())
             for n in shadowed}

    def rel_l2(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    held = sorted(set(gp_) - shadowed)
    card64 = {n: rel_l2(gc_[n], g64[n]) for n in held}
    cpu64 = {n: rel_l2(gp_[n], g64[n]) for n in held}
    card32 = {n: rel_l2(gc_[n], gp_[n]) for n in held}
    head = {n: card32[n] for n in held if n not in resnet}
    worst = {k: max(d, key=d.get) for k, d in (
        ("loss", loss_rel), ("stats", stats_err), ("head", head),
        ("card64", card64), ("cpu64", cpu64), ("card32", card32))}
    grad_bound = 2 * cpu64[worst["cpu64"]] + TRAIN_GRAD_REL
    print(f"train image card vs CPU (B=1, T={IMG_CPU_T}, {config.img_size}"
          f"x{config.img_size}, the same state; {cpu_s:.1f} s on the CPU): "
          f"largest relative loss error {loss_rel[worst['loss']]:.3e} "
          f"({worst['loss']}; bound {TRAIN_LOSS_RTOL:g}); moving averages "
          f"{stats_err[worst['stats']]:.3e} ({worst['stats']}; bound "
          f"{IMG_STATS_ATOL:g}); gradients (relative L2) against float64: "
          f"card {card64[worst['card64']]:.3e} ({worst['card64']}), CPU "
          f"{cpu64[worst['cpu64']]:.3e} ({worst['cpu64']}; the card's bound "
          f"twice that + {TRAIN_GRAD_REL:g} = {grad_bound:.3e}); card "
          f"against CPU {card32[worst['card32']]:.3e} ({worst['card32']}), "
          f"outside the ResNet {head[worst['head']]:.3e} ({worst['head']}); "
          f"the "
          f"{len(shadowed)} biases before BatchNorm: gradient norms at most "
          f"{max(noise.values()):.3e} of their weight's (bound 1e-3); ReLU "
          f"inputs (Linear and BatchNorm outputs) of opposite sign on the "
          f"card and the CPU: {flips} of {n_acts}")
    for k, v in loss_rel.items():
        check(v <= TRAIN_LOSS_RTOL, f"image card vs CPU: {k} off by {v}")
    for n, v in stats_err.items():
        check(v <= IMG_STATS_ATOL, f"image card vs CPU: {n} off by {v}")
    check(card64[worst["card64"]] <= grad_bound,
          f"image card vs float64: d/d{worst['card64']} off by "
          f"{card64[worst['card64']]}, bound {grad_bound}")
    for n, v in noise.items():
        check(v <= 1e-3, f"image card vs CPU: d/d{n} is not noise ({v})")
    return {"loss_rel": loss_rel[worst["loss"]],
            "stats": stats_err[worst["stats"]], "head": head[worst["head"]],
            "card64": card64[worst["card64"]], "cpu64": cpu64[worst["cpu64"]],
            "card32": card32[worst["card32"]], "flips": flips,
            "n_acts": n_acts}


def phase_train_image(torch, np, dev, smpl, K, smpl_cuda, card):
    """Phase 13: image-mode training at full width."""
    import dataclasses
    import tempfile

    from human_dynamics_tpu_torch.train import main as train_main
    from human_dynamics_tpu_torch.train.trainer import Trainer
    from human_dynamics_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    config = Config(batch_size=IMG_B, T=IMG_T, img_size=IMG,
                    precomputed_phi=False, feature_dim=2048,
                    num_kps=SMPL_KPS, use_fused_smpl=True)
    variants = {
        "(a) freeze_phi fp32": dict(),
        "(b) unfrozen bf16": dict(freeze_phi=False, use_bfloat16=True),
        "(c) unfrozen bf16 remat": dict(freeze_phi=False, use_bfloat16=True,
                                        remat_resnet=True),
        "(d) freeze_resnet_stages=3 bf16": dict(
            freeze_phi=False, freeze_resnet_stages=3, use_bfloat16=True),
    }
    trainers = {k: Trainer(dataclasses.replace(config, **kw), smpl,
                           device=dev) for k, kw in variants.items()}
    ta, tb, tc, td = trainers.values()
    batch = image_batch(torch, config, dev, seed=17)
    n_params = sum(p.numel() for p in ta.state.hmmr.parameters())
    print(f"train image: Config(batch_size={IMG_B}, T={IMG_T}, img_size="
          f"{IMG}, precomputed_phi=False, feature_dim=2048, num_kps="
          f"{SMPL_KPS}, use_fused_smpl=True), {n_params / 1e6:.2f} M HMMR "
          f"parameters ({sum(p.numel() for p in ta.state.hmmr.resnet_v2_50.parameters()) / 1e6:.2f}"
          f" M in the ResNet); frames {FRAME}x{FRAME} uint8 made on the card,"
          f" augmented there (data.augment.augment_batch)")
    aug = check_augment_card_vs_cpu(torch, config, dev)

    # One step of each variant from the same state, checked.
    first, mem = {}, {}
    for name, tr in trainers.items():
        params0, stats0 = resnet_state(torch, tr.state.hmmr)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all(K, smpl_cuda)
        first[name] = tr.step(batch)
        torch.cuda.synchronize()
        mem[name] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        got = read_counts(K, smpl_cuda)[0][smpl_cuda.KERNEL_NAME]
        check(got == 1, f"{name}: a step launched K1 {got} times")
        check(all(np.isfinite(float(v)) for v in first[name].values()),
              f"{name}: a loss is not finite")
        params1, stats1 = resnet_state(torch, tr.state.hmmr)
        check(all(not torch.equal(stats0[n], stats1[n]) for n in stats0),
              f"{name}: a moving average did not advance")
        stepped = {id(p) for p in tr.state.opt_e.state}
        rn = dict(tr.state.hmmr.resnet_v2_50.named_parameters())
        frozen = {n for n in params0
                  if name.startswith("(a)") or (name.startswith("(d)") and (
                      n.startswith(("conv1.", "block1.", "block2."))))}
        for n in params0:
            if n in frozen:
                check(torch.equal(params0[n], params1[n])
                      and id(rn[n]) not in stepped,
                      f"{name}: frozen {n} changed or has Adam moments")
            else:
                check(id(rn[n]) in stepped and (
                    n.endswith("bias") or not torch.equal(params0[n],
                                                          params1[n])),
                      f"{name}: {n} did not train")
        print(f"train image {name}: one step, e_loss "
              f"{float(first[name]['e_loss']):.4f}, d_loss "
              f"{float(first[name]['d_loss']):.4f}; {len(frozen)} of "
              f"{len(params0)} ResNet tensors frozen and unchanged, none of "
              f"them with Adam moments, every other one with moments and "
              f"every trainable weight moved; every moving average "
              f"advanced; K1 once")
    bn, cn = list(trainers)[1:3]
    remat_err = max(abs(float(first[bn][k]) - float(first[cn][k]))
                    / max(abs(float(first[bn][k])), 1e-30) for k in first[bn])
    remat_stats = max(max_abs(a, b) for a, b in zip(
        tb.state.hmmr.buffers(), tc.state.hmmr.buffers()))
    print(f"train image remat against no remat, one bf16 step: largest "
          f"relative loss difference {remat_err:.3e} (bound "
          f"{REMAT_LOSS_RTOL:g}), moving averages {remat_stats:.3e} (bound "
          f"{REMAT_STATS_ATOL:g})")
    check(remat_err <= REMAT_LOSS_RTOL, f"remat: losses off by {remat_err}")
    check(remat_stats <= REMAT_STATS_ATOL,
          f"remat: moving averages off by {remat_stats}")
    del td, trainers["(d) freeze_resnet_stages=3 bf16"]

    # The main path, timed in turns: (a), (b), (c) on the fixed batch.
    timed = dict(list(trainers.items())[:3])
    times = {name: [] for name in timed}
    e_losses = [float(first[bn]["e_loss"])]
    order = list(timed)
    reset_all(K, smpl_cuda)
    n_steps = 0
    for name in order + order[::-1] + order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = [timed[name].step(batch) for _ in range(N_IMG_TIMED)]
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / N_IMG_TIMED)
        n_steps += N_IMG_TIMED
        check(all(np.isfinite(float(v)) for m in hist for v in m.values()),
              f"{name}: a loss is not finite")
        if name == bn:
            e_losses += [float(m["e_loss"]) for m in hist]
    torch.cuda.synchronize()
    counts, _ = read_counts(K, smpl_cuda)
    check(counts == {smpl_cuda.KERNEL_NAME: n_steps, K.CONV: 0, K.PREACT: 0,
                     K.BLOCK: 0},
          f"train image: launches {counts} over {n_steps} fused steps")
    check(len(e_losses) >= N_IMG_LEARN and e_losses[-1] < e_losses[0],
          f"train image: e_loss did not fall: {e_losses}")
    print(f"train image {len(e_losses)} steps of {bn} on one batch: e_loss "
          f"{e_losses[0]:.4f} -> {e_losses[-1]:.4f}; launches over the "
          f"{n_steps} timed steps {counts}")
    for name, ts in times.items():
        print(f"smoke timing (not a benchmark) [{card}]: train image step "
              f"{name}, B={IMG_B} T={IMG_T} {IMG}x{IMG}: "
              f"{float(np.median(ts)):.2f} ms/step (median of {len(ts)} "
              f"turns of {N_IMG_TIMED} synchronised steps; all "
              f"{[round(x, 2) for x in ts]}); the step's device memory "
              f"above the resident state {mem[name]:.2f} GiB")
    d_name = "(d) freeze_resnet_stages=3 bf16"
    print(f"train image {d_name}: the step's device memory above the "
          f"resident state {mem[d_name]:.2f} GiB (one step, not timed)")
    print(f"train image: remat saves {mem[bn] - mem[cn]:.2f} GiB of the "
          f"step's device memory ({mem[bn]:.2f} -> {mem[cn]:.2f} GiB)")
    if PROFILE:
        for name in (order[0], bn):
            profile_run(torch, f"train image step {name}",
                        lambda: timed[name].step(batch))
    del timed, trainers, ta, tb, tc, batch

    # The card against the CPU on the same state.
    cmp = image_card_vs_cpu(torch, np, dev, smpl, dataclasses.replace(
        config, batch_size=1, T=IMG_CPU_T, freeze_phi=False))

    # End to end: raw_u8 records -> train.main (the pipeline's augment on
    # the card) -> a checkpoint with the moving averages.
    with tempfile.TemporaryDirectory() as tmp:
        write_image_records(np, os.path.join(tmp, "data"))
        smpl_path = write_smpl_npz(np, tmp)
        t0 = time.perf_counter()
        run = train_main.main([
            "--data_dir", os.path.join(tmp, "data"), "--model_dir",
            os.path.join(tmp, "run"), "--smpl_model_path", smpl_path,
            "--datasets", "h36m", "insta_variety", "--batch_size",
            str(IMG_B), "--T", str(IMG_T), "--img_size", str(IMG),
            "--precomputed_phi", "false", "--freeze_phi", "false",
            "--use_bfloat16", "--num_kps", str(SMPL_KPS),
            "--use_fused_smpl", "--log_step", "1", "--num_steps", "2"])
        main_s = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "run", "ckpt-2.npz")
        check(run.state.step == 2 and os.path.exists(ckpt),
              "train.main in image mode did not write ckpt-2.npz")
        keys = set(np.load(ckpt).files)
        check(any("::batch_stats::" in k for k in keys),
              "the image-mode checkpoint has no batch_stats")
        print(f"train.main image mode: 2 bf16 steps on raw_u8 records "
              f"({FRAME}x{FRAME} frames, augmented on the card) in "
              f"{main_s:.2f} s (pipeline, model init, steps, a "
              f"{os.path.getsize(ckpt) / 2**20:.0f} MiB checkpoint with "
              f"batch_stats)")
        del run
    print(f"phase 13 (image-mode training) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"image_train_launches": counts[smpl_cuda.KERNEL_NAME],
            "image_train_steps": n_steps,
            "ms_per_step": {k: float(np.median(v)) for k, v in times.items()},
            "mem": mem, "card_vs_cpu": cmp, "augment": aug}


# ---------------------------------------------------------------------------
# Phase 14: multi-GPU inference
# ---------------------------------------------------------------------------


def mesh_case(torch, dev):
    """Phase 14's full-width model, predictors and clips, made from seeds:
    the same in every process that makes them on the same card."""
    from types import SimpleNamespace

    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.infer import HmmrPredictor
    from human_dynamics_tpu_torch.models import HmmrModel

    smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS,
                                device=dev)
    model = HmmrModel(include_resnet=True, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(14)

    def clip(n):
        return torch.randint(0, 256, (n, IMG, IMG, 3), dtype=torch.uint8,
                             device=dev, generator=gen)

    frames, calib, halo_frames = clip(N_FRAMES), clip(N_CALIB), clip(N_HALO)
    kw = dict(batch_size=8, seq_length=20, use_fused_smpl=True, device=dev)
    return SimpleNamespace(
        model=model, smpl=smpl, frames=frames, halo_frames=halo_frames,
        bench=HmmrPredictor(model, None, smpl, int8_encoder=True,
                            int8_calibration=calib, bf16_temporal=True, **kw),
        fp32=HmmrPredictor(model, None, smpl, **kw),
    )


def unsharded_clip(torch, model, smpl, phi):
    """The full-clip forward on one device: the port's TemporalEncoderFC2GN
    (F.group_norm, nn.Conv1d) on the whole clip, then the halo path's own
    heads and composed decode (the same per-frame code)."""
    from human_dynamics_tpu_torch.parallel.halo import _heads_and_decode
    from human_dynamics_tpu_torch.utils.precision import full_fp32

    with torch.inference_mode(), full_fp32():
        strip = model.temporal_encoder(phi[None])
        out = _heads_and_decode(model, smpl, strip, True)
    return {k: v[0] for k, v in out.items()}


def check_sharded(torch, what, pred, got, want):
    """Sharded against direct: the same keys and shapes; with an fp32
    window tail every key within SHARDED_FP32_TOL, with a bf16 tail the
    omegas of every head within the streaming bound. Returns the max
    errors."""
    check(set(got) == set(want), f"{what}: keys {sorted(got)}")
    for k in want:
        check(got[k].shape == want[k].shape,
              f"{what}: {k} {tuple(got[k].shape)} != {tuple(want[k].shape)}")
    errs = {k: max_abs(got[k], want[k]) for k in sorted(want)}
    if pred.bf16_temporal:
        share = max(float(((got[k] - want[k]).abs()
                           / (STREAM_BF16_OMEGA_TOL + STREAM_BF16_OMEGA_RTOL
                              * want[k].abs())).max())
                    for k in ("omegas", "omegas_delta"))
        bound = (f"omegas and omegas_delta bound {STREAM_BF16_OMEGA_TOL:g} + "
                 f"{STREAM_BF16_OMEGA_RTOL:g} * |direct| (bf16 tail), largest "
                 f"share of it {share:.3f}")
        ok = share <= 1.0
    else:
        worst = max(errs.values())
        bound = f"every key within {SHARDED_FP32_TOL:g} (fp32 tail)"
        ok = worst <= SHARDED_FP32_TOL
    print(f"{what}: max|sharded - direct| " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f"; {bound}")
    check(ok, f"{what}: outside the bound ({bound}): {errs}")
    return errs


def check_halo(what, got, want):
    """The halo path against the unsharded encoder, within HALO_TOL."""
    check(set(got) == set(want), f"{what}: keys {sorted(got)}")
    errs = {k: max_abs(got[k], want[k]) for k in sorted(want)}
    print(f"{what}: max|halo - unsharded| " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound: omegas {HALO_TOL['omegas']:g}, every key "
        f"{HALO_TOL['all']:g})")
    for k, v in errs.items():
        tol = HALO_TOL["omegas" if k.startswith("omegas") else "all"]
        check(v <= tol, f"{what}: {k} differs by {v} > {tol}")
    return errs


def mesh_checks(torch, case, mesh, mesh_2d, K, smpl_cuda):
    """Phase 14's checks on one rank of a mesh; every rank runs them, rank
    0 holds the results to its single-device counterparts. Returns rank 0's
    errors and every rank's launch counts."""
    import torch.distributed as dist

    from human_dynamics_tpu_torch.infer import (
        PredictionService,
        WindowSchedule,
    )
    from human_dynamics_tpu_torch.parallel import halo
    from human_dynamics_tpu_torch.parallel.mesh import broadcast

    lead, world, dev = mesh.rank == 0, mesh.size, mesh.device
    bench, fp32 = case.bench, case.fp32
    tag = f"mesh world {world} ({dist.get_backend()})"
    res = {"rank": mesh.rank, "world": world}

    def encoded(frames):
        """Rank 0's features of `frames`, on every rank."""
        phi = (bench.encode_frames(frames) if lead else torch.empty(
            (len(frames), case.model.feature_dim), device=dev))
        return broadcast(phi, mesh)

    # Windowed on features: the fp32 and the bf16 window tails.
    phi = encoded(case.frames)
    for name, pred in (("fp32", fp32), ("bench config", bench)):
        got = pred.predict_all_images_sharded(None, mesh, phi=phi,
                                              as_numpy=False)
        if lead:
            want = pred.predict_all_images(None, phi=phi, as_numpy=False)
            res[f"windowed_phi_{name}"] = check_sharded(
                torch, f"{tag}: predict_all_images_sharded, {name}, "
                f"{N_FRAMES}-frame phi", pred, got, want)

    # Windowed on uint8 frames: rank 0 encodes; K1 on every rank.
    sched = WindowSchedule(N_FRAMES, bench.batch_size, bench.seq_length,
                           bench.model.fov)
    per_rank = -(-sched.count // world)
    steps = -(-per_rank // bench.groups_per_step)
    heads = 1 + len(bench.delta_ts)
    chunks = -(-N_FRAMES // bench.encode_chunk) if lead else 0
    torch.cuda.synchronize()
    reset_all(K, smpl_cuda)
    with Recorder(smpl_cuda, ["blend_skin"]) as rec:
        sharded_u8 = bench.predict_all_images_sharded(case.frames, mesh,
                                                      as_numpy=False)
        torch.cuda.synchronize()
    counts, _ = read_counts(K, smpl_cuda)
    want_counts = {smpl_cuda.KERNEL_NAME: steps, K.CONV: 52 * chunks,
                   K.PREACT: chunks, K.BLOCK: 0}
    check(counts == want_counts, f"{tag} rank {mesh.rank}: launches "
          f"{counts}, want {want_counts}")
    k1_n = [args[0].shape[0] for _, args, _ in rec.calls]
    check(k1_n == [per_rank * bench.batch_size * sched.good_frames * heads]
          * steps, f"{tag}: K1 at N = {k1_n}")
    k1_err = 0.0
    for _, args, _ in rec.calls:
        k1_err = max(k1_err, max(
            max_abs(a, b) for a, b in zip(smpl_cuda.blend_skin(*args),
                                          smpl_cuda.blend_skin_reference(
                                              *args))))
    check(k1_err <= K1_PLANES_TOL, f"{tag}: K1 planes {k1_err}")
    res.update(launches=counts, k1_n=k1_n, k1_err=k1_err)
    if lead:
        print(f"{tag}: one {N_FRAMES}-frame uint8 clip, "
              f"{sched.count} window groups -> {per_rank} per rank; "
              f"launches on rank 0 {counts}; K1 at N = {k1_n}, planes "
              f"within {k1_err:.3e} of its plain version (tol "
              f"{K1_PLANES_TOL:g})")
        want_u8 = bench.predict_all_images(case.frames, as_numpy=False)
        res["windowed_u8"] = check_sharded(
            torch, f"{tag}: predict_all_images_sharded, bench config, "
            f"{N_FRAMES} uint8 frames", bench, sharded_u8, want_u8)

    # The halo path on a long clip, and on a (1, world) mesh.
    phi_halo = encoded(case.halo_frames)
    got = halo.predict_clip_sharded(case.model, case.smpl, phi_halo, mesh,
                                   axis_name="data")
    if lead:
        res["halo"] = check_halo(
            f"{tag}: predict_clip_sharded, {N_HALO}-frame phi",
            got, unsharded_clip(torch, case.model, case.smpl, phi_halo))
    b2, n2 = CLIPS_2D
    phis = phi_halo[:b2 * n2].reshape(b2, n2, -1)
    got = halo.predict_clips_sharded_2d(case.model, case.smpl, phis, mesh_2d)
    if lead:
        res["clips_2d"] = max(
            max(check_halo(f"{tag}: predict_clips_sharded_2d on a "
                           f"{mesh_2d.shape} mesh, clip {i} of {b2}x{n2}",
                           {k: v[i] for k, v in got.items()},
                           unsharded_clip(torch, case.model, case.smpl,
                                          phis[i])).values())
            for i in range(b2))

    # The service, both modes: rank 0 serves, the others follow.
    direct_halo = halo.predict_clip_sharded(case.model, case.smpl, phi, mesh,
                                           axis_name="data")
    for mode, want in (("windowed", sharded_u8), ("halo", direct_halo)):
        if not lead:
            stats = PredictionService.follow(bench, mesh)
            check(stats == {"served": 1, "failed": 0},
                  f"{tag} rank {mesh.rank}: follower {mode} {stats}")
            continue
        with PredictionService(bench, mesh=mesh, mesh_mode=mode) as service:
            got = service.submit(case.frames).result(timeout=600)
        check(service.stats()["completed"] == 1, f"{tag}: service {mode} "
              f"{service.stats()}")
        check(set(got) == set(want) and all(
            torch.equal(got[k], want[k]) for k in want),
            f"{tag}: the {mode} service differs from the direct sharded call")
        print(f"{tag}: PredictionService(mesh, mesh_mode={mode!r}) on one "
              f"{N_FRAMES}-frame uint8 clip equal to the direct sharded "
              f"call, {world - 1} follower(s)")
    return res


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def walls_in_turns(torch, fns, reps=N_MESH_TURNS):
    """{name: [seconds]} of each fn, synchronised, in turns a, b, b, a."""
    names = list(fns)
    walls = {n: [] for n in names}
    for name in names + names[::-1]:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    return walls


def mesh_timings(torch, np, case, mesh, card):
    """World 1: sharded against direct, the halo clip against the unsharded
    forward, the service with a mesh against direct calls; smoke timings
    (medians of 2 x N_MESH_TURNS calls in turns), not a benchmark."""
    from human_dynamics_tpu_torch.infer import PredictionService
    from human_dynamics_tpu_torch.parallel import halo

    bench, frames = case.bench, case.frames
    phi_halo = bench.encode_frames(case.halo_frames)

    def service_clips():
        with PredictionService(bench, mesh=mesh) as service:
            futs = [service.submit(frames) for _ in range(N_MESH_TURNS)]
            for f in futs:
                f.result(timeout=600)

    def direct_clips():
        for _ in range(N_MESH_TURNS):
            bench.predict_all_images(frames, as_numpy=False)

    runs = {
        f"windowed, bench config, {N_FRAMES} uint8 frames": {
            "direct": lambda: bench.predict_all_images(frames,
                                                       as_numpy=False),
            "sharded": lambda: bench.predict_all_images_sharded(
                frames, mesh, as_numpy=False)},
        f"halo, {N_HALO}-frame phi, fp32": {
            "unsharded": lambda: unsharded_clip(torch, case.model, case.smpl,
                                                phi_halo),
            "sharded": lambda: halo.predict_clip_sharded(
                case.model, case.smpl, phi_halo, mesh, axis_name="data")},
    }
    out = {}
    for what, fns in runs.items():
        walls = walls_in_turns(torch, fns)
        med = {n: float(np.median(w)) * 1e3 for n, w in walls.items()}
        out[what] = med
        print(f"smoke timing (not a benchmark) [{card}]: mesh world 1, "
              f"{what}: " + ", ".join(
                  f"{n} {m:.2f} ms (all {[round(x * 1e3, 2) for x in w]})"
                  for (n, w), m in zip(walls.items(), med.values())))
    walls = walls_in_turns(torch, {"direct": direct_clips,
                                   "service": service_clips}, reps=1)
    n = N_MESH_TURNS * N_FRAMES
    out["service"] = {k: n / float(np.median(w)) for k, w in walls.items()}
    print(f"smoke timing (not a benchmark) [{card}]: mesh world 1, "
          f"{N_MESH_TURNS} clips of {N_FRAMES} frames through "
          f"PredictionService(mesh) " + ", ".join(
              f"{s * 1e3:.2f} ms" for s in walls["service"])
          + " against direct calls " + ", ".join(
              f"{s * 1e3:.2f} ms" for s in walls["direct"])
          + f"; frames/s {out['service']['service']:.1f} against "
          f"{out['service']['direct']:.1f} (medians)")
    return out


def mesh_rank(torch, dev, rank, world, url, backend, out_path):
    """One rank of a phase-14 group: join it, run mesh_checks, write the
    results to out_path."""
    import torch.distributed as dist

    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
    from human_dynamics_tpu_torch.ops import smpl_cuda

    parallel.initialize_multihost(
        {"HD_TPU_COORDINATOR": url, "HD_TPU_NUM_PROCESSES": str(world),
         "HD_TPU_PROCESS_ID": str(rank)}, device=dev, backend=backend)
    try:
        mesh = parallel.make_mesh(world, "data", device=dev)
        mesh_2d = parallel.make_mesh_2d(1, world, device=dev)
        res = mesh_checks(torch, mesh_case(torch, mesh.device), mesh,
                          mesh_2d, K, smpl_cuda)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def mesh_worker(argv):
    """Entry of a phase-14 rank: chip_smoke.py --mesh-worker RANK WORLD URL
    OUT BACKEND."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, HERE)
    rank, world, url, out_path, backend = argv
    rank, world = int(rank), int(world)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    mesh_rank(torch, dev, rank, world, url, backend, out_path)


def run_mesh_group(world, backend):
    """Phase 14's ranks: `world` subprocesses on `backend`."""
    return run_rank_group(world, "--mesh-worker", [backend],
                          f"mesh world {world} ({backend})")


def run_processes(argvs, envs, what):
    """Start one process per argv (with its env, from this directory); a
    process that fails or outlives MESH_WORKER_TIMEOUT fails the phase
    (every process is killed). Returns each one's output."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(len(argvs))]
        procs = [subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                  cwd=HERE, env=env)
                 for argv, env, log in zip(argvs, envs, logs)]
        deadline = time.monotonic() + MESH_WORKER_TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    print(f"--- {what}, rank 0's output ---\n" + texts[0].rstrip())
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in failed:
        print(f"--- rank {r} exited with {procs[r].returncode} ---\n"
              + texts[r][-6000:].rstrip())
    check(not failed, f"{what}: ranks {failed} failed or timed out")
    return texts


def run_rank_group(world, flag, tail, what):
    """`world` ranks of this script as subprocesses (chip_smoke.py FLAG
    RANK WORLD URL OUT *TAIL), every one passing; returns each rank's
    results and the group's wall."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        url = "file://" + os.path.join(tmp, "rendezvous")
        env = dict(os.environ)
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        run_processes(
            [[sys.executable, os.path.abspath(__file__), flag, str(r),
              str(world), url, outs[r], *tail] for r in range(world)],
            [env] * world, what)
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
    return results, time.perf_counter() - t0


def phase_mesh(torch, np, dev, K, smpl_cuda, card):
    """Phase 14: multi-GPU inference at full width. World 1 on NCCL in this
    process (checks, K1's launches, timings); then two ranks sharing the
    card over gloo, and, where two or more cards are visible, NCCL over all
    of them, as subprocesses."""
    import torch.distributed as dist

    from human_dynamics_tpu_torch import parallel

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1, "data", device=dev)
        mesh_2d = parallel.make_mesh_2d(1, 1, device=dev)
        case = mesh_case(torch, dev)
        res = mesh_checks(torch, case, mesh, mesh_2d, K, smpl_cuda)
        res["timings"] = mesh_timings(torch, np, case, mesh, card)
    finally:
        dist.destroy_process_group()
    del case
    torch.cuda.empty_cache()
    worlds = [(1, "nccl")]
    groups = [(2, "gloo")]
    if torch.cuda.device_count() >= 2:
        groups.append((torch.cuda.device_count(), "nccl"))
    for world, backend in groups:
        ranks, wall = run_mesh_group(world, backend)
        worlds.append((world, backend))
        print(f"mesh world {world} ({backend}): every rank passed in "
              f"{wall:.1f} s; K1 launches by rank "
              f"{[r['launches'][smpl_cuda.KERNEL_NAME] for r in ranks]} at "
              f"N = {[r['k1_n'] for r in ranks]}")
        res[f"world{world}_{backend}"] = ranks
    print(f"mesh: worlds run {worlds}; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 15: data-parallel training
# ---------------------------------------------------------------------------


def dp_configs():
    """Phase 15's configurations: phi fp32 fused, and image mode (b) the
    whole trunk in bf16 and (a) freeze_phi fp32, at full width."""
    import dataclasses

    from human_dynamics_tpu_torch.utils.config import Config

    phi = Config(batch_size=TRAIN_B, T=TRAIN_T, feature_dim=TRAIN_C,
                 num_kps=SMPL_KPS, use_fused_smpl=True)
    image = dataclasses.replace(phi, batch_size=IMG_B, T=IMG_T, img_size=IMG,
                                precomputed_phi=False, feature_dim=2048)
    return {"phi fp32 fused": phi,
            "image (b) unfrozen bf16": dataclasses.replace(
                image, freeze_phi=False, use_bfloat16=True),
            "image (a) freeze_phi fp32": image}


def dp_batch(torch, name, config, dev):
    """The global batch of a phase-15 configuration, made on `dev` from a
    seed (the same on every process)."""
    if config.precomputed_phi:
        return train_batch(torch, config, dev, seed=7)
    return image_batch(torch, config, dev, seed=17)


def named_parameters(tr):
    """(name, parameter) of both of a Trainer's models."""
    return ([("e." + n, p) for n, p in tr.state.hmmr.named_parameters()]
            + [("d." + n, p) for n, p in tr.state.disc.named_parameters()])


def rel_l2(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def max_rank_difference(torch, tensors, mesh):
    """The largest |x - rank 0's x| over `tensors` on every rank, summed
    over the ranks by an all_reduce: 0 when every rank holds rank 0's
    state, bit for bit."""
    from human_dynamics_tpu_torch.parallel.mesh import all_sum, broadcast

    worst = torch.zeros(1, device=mesh.device)
    for t in tensors:
        ref = broadcast(t.detach().clone(), mesh)
        worst = torch.maximum(worst, (t.detach().float() - ref.float())
                              .abs().max().reshape(1))
    return float(all_sum(worst, mesh))


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """Inside, CUDA ops that have a deterministic implementation use it
    (an accumulating index_put, cuDNN's convolution algorithms): two runs
    of the same step give the same bits."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]


def dp_world1(torch, np, dev, smpl, K, smpl_cuda, card):
    """World 1 on NCCL: each configuration's DP Trainer against the plain
    one from the same state (DP_STEPS steps, losses and every state
    tensor) with deterministic algorithms, a second plain Trainer with
    PyTorch's default ones beside it (the run-to-run difference those
    allow), K1's launches over the DP steps, and the DP and plain steps
    timed in turns."""
    import torch.distributed as dist

    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.train.trainer import Trainer

    def state_err(a, b):
        errs = [rel_l2(p, q) for p, q in zip(a.state_tensors(),
                                             b.state_tensors())]
        return max(errs)

    def loss_err(got, want):
        return max(abs(float(g[k]) - float(w[k])) / max(abs(float(w[k])),
                                                        1e-30)
                   for g, w in zip(got, want) for k in w)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    out = {"launches": 0, "steps": 0, "ms": {}, "err": {}}
    failures = []
    try:
        mesh = parallel.make_mesh(1, device=dev)
        for name, config in dp_configs().items():
            batch = dp_batch(torch, name, config, dev)
            block = parallel.shard_batch(batch, mesh)
            plain = Trainer(config, smpl, device=dev)
            dp = Trainer(config, smpl, device=dev, mesh=mesh)
            again = Trainer(config, smpl, device=dev)
            k1 = smpl_cuda.KERNEL_NAME

            def dp_step():
                before = smpl_cuda.LAUNCHES[k1]
                m = dp.step(block)
                torch.cuda.synchronize()
                launches[0] += smpl_cuda.LAUNCHES[k1] - before
                return m

            launches = [0]
            with deterministic_algorithms(torch):
                want = [plain.step(batch)]
                first = {n: p.grad.clone() for n, p in named_parameters(plain)
                         if p.grad is not None}
                got = [dp_step()]
                diffs = {n: max_abs(p.grad, first[n])
                         / max(float(first[n].abs().max()), 1e-30)
                         for n, p in named_parameters(dp) if n in first}
                worst = max(diffs, key=diffs.get)
                first_err = diffs[worst]
                repeat = [again.step(batch)]
                repeat_err = max(max_abs(p.grad, first[n])
                                 for n, p in named_parameters(again)
                                 if n in first)
                print(f"dp world 1 {name}, first step, deterministic "
                      f"algorithms: losses of DP / a second plain Trainer "
                      f"equal to the plain one's: "
                      f"{all(float(got[0][k]) == float(want[0][k]) for k in want[0])}"
                      f" / {all(float(repeat[0][k]) == float(want[0][k]) for k in want[0])}"
                      f"; gradients: largest difference relative to the "
                      f"parameter's largest element {first_err:.3e} ({worst}"
                      f", {sum(v > 0 for v in diffs.values())} of "
                      f"{len(diffs)} tensors differ; bound "
                      f"{DP_WORLD1_GRAD_REL:g}) / max abs {repeat_err:.3e}")
                if first_err > DP_WORLD1_GRAD_REL:
                    failures.append(f"{name}: first-step gradients")
                want += [plain.step(batch) for _ in range(DP_STEPS - 1)]
                got += [dp_step() for _ in range(DP_STEPS - 1)]
            default = repeat + [again.step(batch)
                                for _ in range(DP_STEPS - 1)]
            check(launches[0] == DP_STEPS, f"dp world 1 {name}: K1 launched "
                  f"{launches[0]} times in {DP_STEPS} steps")
            out["launches"] += launches[0]
            out["steps"] += DP_STEPS
            err = {"loss": loss_err(got, want), "state": state_err(dp, plain),
                   "default_loss": loss_err(default, want),
                   "default_state": state_err(again, plain)}
            out["err"][name] = err
            print(f"dp world 1 (nccl) {name}: {DP_STEPS} steps against the "
                  f"plain Trainer.step from the same state, deterministic "
                  f"algorithms: largest relative loss error "
                  f"{err['loss']:.3e}, largest relative L2 error of a "
                  f"parameter, moving average or Adam moment "
                  f"{err['state']:.3e} (bounds {DP_WORLD1_RTOL:g} and "
                  f"{DP_WORLD1_STATE_REL:g}); a second "
                  f"plain Trainer (deterministic algorithms for the first "
                  f"step, the default ones after): "
                  f"{err['default_loss']:.3e} and {err['default_state']:.3e}; "
                  f"K1 {launches[0]} launches")
            if not (err["loss"] <= DP_WORLD1_RTOL
                    and err["state"] <= DP_WORLD1_STATE_REL):
                failures.append(name)
            del again, default
            fns = {"plain": lambda: plain.step(batch),
                   "dp": lambda: dp.step(block)}
            times = {n: [] for n in fns}
            for n in ["plain", "dp", "dp", "plain"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DP_TIMED):
                    fns[n]()
                torch.cuda.synchronize()
                times[n].append((time.perf_counter() - t0) * 1e3 / DP_TIMED)
            out["ms"][name] = {n: min(v) for n, v in times.items()}
            if PROFILE:
                for n, fn in fns.items():
                    profile_run(torch, f"dp world 1 {name}, {n} step", fn)
            print(f"smoke timing (not a benchmark) [{card}]: dp world 1 "
                  f"{name}, global B={config.batch_size} T={config.T}: dp "
                  f"{out['ms'][name]['dp']:.2f} ms/step, plain "
                  f"{out['ms'][name]['plain']:.2f} (best of 2 turns of "
                  f"{DP_TIMED} synchronised steps, in turns plain, dp, dp, "
                  f"plain; all {times})")
            del plain, dp, batch, block, fns, want, got
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    check(not failures, f"dp world 1: the DP step left the plain one in "
          f"{failures}")
    return out


def dp_rank_phi(torch, dev, mesh, smpl, K, smpl_cuda, tag, shard=None,
                tp=False):
    """Two-rank phi steps: every rank equal after each, rank 0 against the
    world-1 (plain) step on the global batch, K1 once per rank per step at
    the rank's N and held to its plain version. `shard` cuts the rank's
    block (parallel.shard_batch by default); with `tp` the state is
    shard_params_tp'ed first, and the ranks' states and rank 0's gradients
    are compared whole (parallel.gathered_tp, on every rank)."""
    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.train.trainer import Trainer

    name = "phi fp32 fused"
    config = dp_configs()[name]
    batch = dp_batch(torch, name, config, dev)
    block = (shard or parallel.shard_batch)(batch, mesh)
    lead = mesh.rank == 0
    dp = Trainer(config, smpl, device=dev, mesh=mesh)
    if tp:
        dp.state = parallel.shard_params_tp(dp.state, mesh)
    ref = Trainer(config, smpl, device=dev) if lead else None
    res = {"rank_diff": [], "loss_err": 0.0}
    calls, launches = [], 0
    for step in range(DP_RANK_STEPS):
        reset_all(K, smpl_cuda)
        with Recorder(smpl_cuda, ["blend_skin"]) as rec:
            got = dp.step(block)
            torch.cuda.synchronize()
        calls += rec.calls
        launches += smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]
        with parallel.gathered_tp(dp.state):
            diff = max_rank_difference(torch, dp.state_tensors(), mesh)
            summed = ([(n, p.grad.clone()) for n, p in named_parameters(dp)]
                      if lead and step == 0 else None)
        res["rank_diff"].append(diff)
        check(diff == 0.0, f"{tag} {name} step {step}: the ranks differ by "
              f"{diff}")
        if lead:
            want = ref.step(batch)
            err = max(abs(float(got[k]) - float(want[k]))
                      / max(abs(float(want[k])), 1e-30) for k in want)
            res["loss_err"] = max(res["loss_err"], err)
            check(err <= DP_LOSS_RTOL, f"{tag} {name} step {step}: losses "
                  f"{err} from the world-1 step")
        if summed is not None:
            grads = {n: rel_l2(g, q.grad) for (n, g), (_, q) in zip(
                summed, named_parameters(ref))}
            del summed
            worst = max(grads, key=grads.get)
            res["grad_err"] = grads[worst]
            check(grads[worst] <= TRAIN_GRAD_REL, f"{tag} {name}: the "
                  f"summed gradient of {worst} is {grads[worst]} from "
                  "the world-1 one")
    k1_n = [args[0].shape[0] for _, args, _ in calls]
    rank_n = TRAIN_N // mesh.axis_size(mesh.batch_axes)
    check(launches == DP_RANK_STEPS and k1_n == [rank_n] * DP_RANK_STEPS,
          f"{tag}: K1 launched {launches} times at N = {k1_n} over "
          f"{DP_RANK_STEPS} steps")
    planes = max(max(max_abs(a, b) for a, b in zip(
        smpl_cuda.blend_skin(*args), smpl_cuda.blend_skin_reference(*args)))
        for _, args, _ in calls)
    check(planes <= K1_PLANES_TOL, f"{tag}: K1 planes {planes}")
    res.update(k1_n=k1_n, k1_err=planes)
    return res


def dp_rank_image(torch, dev, mesh, smpl, tag, shard=None):
    """One two-rank step of image (b) on the rank's block (`shard`,
    parallel.shard_batch by default): every rank equal, and rank 0 against
    the world-1 bf16 step and its fp32 counterpart on the global batch."""
    import dataclasses

    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.train.trainer import Trainer

    name = "image (b) unfrozen bf16"
    config = dp_configs()[name]
    batch = dp_batch(torch, name, config, dev)
    dp = Trainer(config, smpl, device=dev, mesh=mesh)
    got = dp.step((shard or parallel.shard_batch)(batch, mesh))
    torch.cuda.synchronize()
    diff = max_rank_difference(torch, dp.state_tensors(), mesh)
    check(diff == 0.0, f"{tag} {name}: the ranks differ by {diff}")
    res = {"rank_diff": [diff]}
    if mesh.rank != 0:
        return res
    grads = {n: p.grad for n, p in named_parameters(dp)
             if p.grad is not None}
    del dp
    torch.cuda.empty_cache()
    ref = Trainer(config, smpl, device=dev)
    want = ref.step(batch)
    ref_grads = dict(named_parameters(ref))
    ref_grads = {n: ref_grads[n].grad for n in grads}
    del ref
    ref32 = Trainer(dataclasses.replace(config, use_bfloat16=False), smpl,
                    device=dev)
    want32 = ref32.step(batch)
    grads32 = dict(named_parameters(ref32))
    grads32 = {n: grads32[n].grad for n in grads}
    del ref32
    torch.cuda.empty_cache()
    print(f"{tag} {name}: losses, two ranks / world-1 bf16 / world-1 fp32: "
          + ", ".join(f"{k} {float(got[k]):.6g}/{float(want[k]):.6g}/"
                      f"{float(want32[k]):.6g}" for k in want))

    def loss_dist(m):
        return max(abs(float(m[k]) - float(want32[k]))
                   / max(abs(float(want32[k])), 1e-30) for k in want32)

    def grad_dist(g, part):
        names = [n for n in g if n.startswith(part)]
        cat = lambda d: torch.cat([d[n].float().reshape(-1) for n in names])
        return rel_l2(cat(g), cat(grads32))

    res.update(loss_err=loss_dist(got), loss_bf16=loss_dist(want),
               loss_vs_world1=max(abs(float(got[k]) - float(want[k]))
                                  / max(abs(float(want[k])), 1e-30)
                                  for k in want))
    check(res["loss_err"] <= DP_BF16_GRAD_FACTOR * res["loss_bf16"]
          + DP_BF16_LOSS_RTOL, f"{tag} {name}: losses up to "
          f"{res['loss_err']} from the fp32 step, the world-1 bf16 step's "
          f"{res['loss_bf16']}")
    for part in ("e.", "d."):
        d, w = grad_dist(grads, part), grad_dist(ref_grads, part)
        res[f"grad_err_{part[0]}"], res[f"grad_bf16_{part[0]}"] = d, w
        check(d <= DP_BF16_GRAD_FACTOR * w + DP_BF16_GRAD_FLOOR,
              f"{tag} {name}: the {part[0]} gradient is {d} from the fp32 "
              f"step's, the world-1 bf16 step's {w}")
    return res


def dp_rank(torch, dev, rank, world, url, out_path):
    """One rank of phase 15's two-rank group: phi steps and an image step;
    writes its results to out_path."""
    import torch.distributed as dist

    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
    from human_dynamics_tpu_torch.ops import smpl_cuda

    parallel.initialize_multihost(
        {"HD_TPU_COORDINATOR": url, "HD_TPU_NUM_PROCESSES": str(world),
         "HD_TPU_PROCESS_ID": str(rank)}, device=dev, backend="gloo")
    try:
        mesh = parallel.make_mesh(world, device=dev)
        tag = f"dp world {world} (gloo) rank {rank}"
        smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS,
                                    device=dev)
        t0 = time.perf_counter()
        res = {"phi": dp_rank_phi(torch, dev, mesh, smpl, K, smpl_cuda, tag)}
        torch.cuda.empty_cache()
        res["image"] = dp_rank_image(torch, dev, mesh, smpl, tag)
        res["steps_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def dp_worker(argv):
    """Entry of a phase-15 rank: chip_smoke.py --dp-worker RANK WORLD URL
    OUT."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, HERE)
    rank, world, url, out_path = argv
    dev = torch.device("cuda", int(rank) % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dp_rank(torch, dev, int(rank), int(world), url, out_path)


def run_train_main(world, data_dir, model_dir):
    """python -m human_dynamics_tpu_torch.train.main as `world` processes
    sharing the card over gloo, joined by the HD_TPU_* variables, for
    DP_MAIN_STEPS steps, every one passing. Returns rank 0's output and
    the wall."""
    import tempfile

    t0 = time.perf_counter()
    argv = [sys.executable, "-m", "human_dynamics_tpu_torch.train.main",
            "--data_dir", data_dir, "--model_dir", model_dir,
            "--smpl_model_path", os.path.join(data_dir, "smpl.npz"),
            "--datasets", "h36m", "insta_variety", "--batch_size",
            str(TRAIN_B), "--T", str(TRAIN_T), "--feature_dim", str(TRAIN_C),
            "--num_kps", str(SMPL_KPS), "--use_fused_smpl", "--log_step", "1",
            "--num_steps", str(DP_MAIN_STEPS), "--backend", "gloo"]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, HD_TPU_COORDINATOR="file://" + os.path.join(
            tmp, "rendezvous"), HD_TPU_NUM_PROCESSES=str(world))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        texts = run_processes(
            [argv] * world, [dict(env, HD_TPU_PROCESS_ID=str(r))
                             for r in range(world)],
            f"dp train.main, {world} processes")
    return texts[0], time.perf_counter() - t0


def phase_dp(torch, np, dev, smpl, K, smpl_cuda, card):
    """Phase 15: data-parallel training at full width. World 1 on NCCL in
    this process; K1 timed at a rank's N; then two ranks sharing the card
    over gloo as subprocesses (phi steps, an image step); then train.main
    as two processes and a single-process Trainer restoring its
    checkpoint."""
    import dataclasses
    import tempfile

    from human_dynamics_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    res = {"world1": dp_world1(torch, np, dev, smpl, K, smpl_cuda, card)}
    consts = smpl_cuda.prepare_fused_constants(smpl)
    n = TRAIN_N // 2
    g = torch.Generator(device=dev).manual_seed(15)
    ops = k1_operands(smpl, consts,
                      torch.randn(n, 10, generator=g, device=dev) * 0.3,
                      torch.randn(n, 72, generator=g, device=dev) * 0.3)
    k_ms, p_ms = k1_in_turns(torch, ops)
    b_ms, b_by = k1_bound(smpl_cuda, n)[:2]
    res["k1"] = {"n": n, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms}
    print(f"K1 N={n} V={SMPL_VERTS} (a rank's rows of a two-rank training "
          f"step): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    ranks, wall = run_rank_group(2, "--dp-worker", [], "dp world 2 (gloo)")
    lead = ranks[0]
    print(f"dp world 2 (gloo, one card): every rank passed in "
          f"{wall:.1f} s; phi: {DP_RANK_STEPS} steps, ranks equal after "
          f"each ({[r['phi']['rank_diff'] for r in ranks]}), losses "
          f"{lead['phi']['loss_err']:.3e} from the world-1 step (bound "
          f"{DP_LOSS_RTOL:g}), summed gradients {lead['phi']['grad_err']:.3e}"
          f" (relative L2, worst parameter; bound {TRAIN_GRAD_REL:g}); "
          f"K1 at N = {[r['phi']['k1_n'] for r in ranks]}, planes within "
          f"{max(r['phi']['k1_err'] for r in ranks):.3e} of plain; image "
          f"(b): ranks equal ({[r['image']['rank_diff'] for r in ranks]}), "
          f"losses up to {lead['image']['loss_vs_world1']:.3e} from the "
          f"world-1 bf16 step's; from the world-1 fp32 step, the "
          f"two-rank / world-1 bf16 losses up to "
          f"{lead['image']['loss_err']:.3e} / "
          f"{lead['image']['loss_bf16']:.3e}, the HMMR gradient "
          f"{lead['image']['grad_err_e']:.3e} / "
          f"{lead['image']['grad_bf16_e']:.3e}, the discriminator's "
          f"{lead['image']['grad_err_d']:.3e} / "
          f"{lead['image']['grad_bf16_d']:.3e} (bounds: twice world 1's, "
          f"+{DP_BF16_LOSS_RTOL:g} and +{DP_BF16_GRAD_FLOOR:g}); steps "
          f"{lead['steps_s']:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        write_train_records(np, tmp, TRAIN_C, shards=2)
        model_dir = os.path.join(tmp, "run")
        log, main_s = run_train_main(2, tmp, model_dir)
        ckpts = sorted(f for f in os.listdir(model_dir)
                       if f.startswith("ckpt-"))
        check(ckpts == [f"ckpt-{DP_MAIN_STEPS}.npz"],
              f"dp train.main wrote {ckpts}")
        restored = Trainer(dataclasses.replace(
            dp_configs()["phi fp32 fused"], model_dir=model_dir), smpl,
            device=dev)
        fresh = Trainer(dp_configs()["phi fp32 fused"], smpl, device=dev)
        params = list(zip(named_parameters(restored),
                          named_parameters(fresh)))
        moved = sum(not torch.equal(p, q) for (_, p), (_, q) in params)
        check(restored.state.step == DP_MAIN_STEPS
              and all(bool(torch.isfinite(t).all())
                      for t in restored.state_tensors()) and moved,
              f"dp train.main: the restored Trainer is at step "
              f"{restored.state.step}, {moved} tensors moved")
        steps = [ln for ln in log.splitlines() if ln.startswith("step ")]
        print(f"dp train.main as 2 processes sharing the card over gloo "
              f"(HD_TPU_* variables, --backend gloo), {DP_MAIN_STEPS} steps "
              f"on phi records (2 shards per dataset, one per rank) in "
              f"{main_s:.1f} s with the processes' start; rank 0: "
              f"{steps}; it alone wrote {ckpts}, which a single-process "
              f"Trainer restored at step {restored.state.step}, every "
              f"tensor finite, {moved} of {len(params)} parameters moved "
              f"from the initial state")
        del restored, fresh
    res["world2"] = ranks
    print(f"phase 15 (data-parallel training) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 16: the demo
# ---------------------------------------------------------------------------


def demo_person(np, i):
    """25 PoseFlow keypoints (x, y, score) of a person ~300 px tall walking
    right across a DEMO_W-wide frame."""
    kps = np.zeros((SMPL_KPS, 3))
    kps[:, 0] = 200 + 3.5 * i + np.linspace(-60, 60, SMPL_KPS)
    kps[:, 1] = DEMO_H / 2 + np.linspace(-150, 150, SMPL_KPS)
    kps[:, 2] = 0.9
    return kps


def write_demo_track(np, path, n):
    """A PoseFlow tracked JSON of one person over n frames."""
    data = {f"frame{i:06d}.png": (
        [] if i in DEMO_MISSING
        else [{"keypoints": demo_person(np, i).ravel().tolist(), "idx": 0}])
        for i in range(n)}
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def demo_schema(n):
    """Keys, shapes and dtypes of the JAX demo's hmmr_output.pkl for an
    n-frame track (two delta heads)."""
    per = {"cams": (3,), "joints": (SMPL_KPS, 3), "kps": (SMPL_KPS, 2),
           "poses": (24, 3, 3), "shapes": (10,), "verts": (SMPL_VERTS, 3),
           "omegas": (85,)}
    schema = {k: ((n,) + s, "float32") for k, s in per.items()}
    schema.update({k + "_delta": ((n, 2) + s, "float32")
                   for k, s in per.items()})
    schema["frame_range"] = ((2,), "int64")
    return schema


def check_demo_pkl(np, path, n, what):
    import pickle

    with open(path, "rb") as f:
        preds = pickle.load(f)
    want = demo_schema(n)
    got = {k: (tuple(v.shape), str(v.dtype)) for k, v in preds.items()}
    check(got == want and all(type(v) is np.ndarray for v in preds.values()),
          f"{what}: pkl schema {got} != the JAX demo's {want}")
    check(all(np.isfinite(v).all() for v in preds.values()),
          f"{what}: non-finite values in the pkl")
    return preds


def uv_sphere(np, n_lat, n_lon, radius=0.6):
    """A UV sphere: 2 + (n_lat - 1) * n_lon vertices, 2 * n_lon * (n_lat -
    1) faces, each spanning a small patch of the surface."""
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(lat), np.cos(lon)),
                     np.repeat(np.cos(lat)[:, None], n_lon, 1),
                     np.outer(np.sin(lat), np.sin(lon))], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * radius

    def idx(i, j):
        return 1 + i * n_lon + j % n_lon

    faces = [(0, idx(0, j + 1), idx(0, j)) for j in range(n_lon)]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            faces += [(idx(i, j), idx(i, j + 1), idx(i + 1, j + 1)),
                      (idx(i, j), idx(i + 1, j + 1), idx(i + 1, j))]
    last = len(verts) - 1
    faces += [(last, idx(n_lat - 2, j), idx(n_lat - 2, j + 1))
              for j in range(n_lon)]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def demo_renders(np, proc_info, frame, card):
    """The native rasterizer against its numpy plain version on the three
    panels the demo renders without cv2: the crop, the original frame
    (orig_view, at most 300 px) and the rotated view; ms per render on the
    host."""
    from human_dynamics_tpu_torch.viz import renderer as R
    from human_dynamics_tpu_torch.viz.composite import orig_view

    verts, faces = uv_sphere(np, *RENDER_SPHERE)
    check((len(verts), len(faces)) == (6890, 13776),
          f"render mesh {len(verts)} verts, {len(faces)} faces")
    cam = np.array([0.9, 0.02, -0.05], np.float32)
    kps = np.zeros((SMPL_KPS, 2), np.float32)
    orig = ((frame / 255.0) - 0.5) * 2
    img, _, _, orig_cam = orig_view(
        cam, kps, proc_info["start_pt"], proc_info["scale"],
        proc_info["im_shape"], orig)
    rot = R.rodrigues(np.deg2rad(90) * np.array([0, 1.0, 0]))
    center = verts.mean(axis=0, keepdims=True)
    rotated = ((verts - center) @ rot.T + center).astype(np.float32)
    panels = {"crop 224": (verts, cam, IMG),
              f"original {img.shape[0]}": (verts, orig_cam, img.shape[0]),
              "rotated 224": (rotated, cam, IMG)}
    color = np.asarray(R.MESH_COLORS["blue"], np.float32)
    renderer = R.VisRenderer(img_size=IMG, faces=faces)
    t0 = time.perf_counter()
    R.load_library()
    print(f"demo render: the C++ rasterizer built or loaded in "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(R.library_path(), HERE)}")
    out = {}
    for name, (v, c, size) in panels.items():
        proj = renderer._project(v, c)
        args = (proj, faces, size, color, renderer.light_dir,
                renderer.int_dir, renderer.int_amb)
        times = {}
        for fn, reps in ((R.rasterize_native, N_RENDER_TIMED),
                         (R.rasterize_numpy, 1)):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                res = fn(*args)
                ts.append((time.perf_counter() - t0) * 1e3)
            times[fn.__name__] = (min(ts), res)
        (n_ms, (rgb, mask)), (p_ms, (prgb, pmask)) = times.values()
        covered = int(mask.sum())
        err = float(np.abs(rgb - prgb).max())
        print(f"demo render {name}: native vs numpy masks "
              f"{'equal' if np.array_equal(mask, pmask) else 'DIFFER'} "
              f"({covered} px covered), rgb max abs {err:.3e} (tol "
              f"{RENDER_RGB_TOL:g}); host time [{card}] native {n_ms:.2f} ms, "
              f"numpy {p_ms:.2f} ms per render (native best of "
              f"{N_RENDER_TIMED}, numpy once)")
        check(covered > 0 and np.array_equal(mask, pmask)
              and err <= RENDER_RGB_TOL,
              f"demo render {name}: native differs from numpy")
        out[name] = {"native_ms": n_ms, "numpy_ms": p_ms}
    return out


def demo_video(np, preds, images, infos, frames, out_dir, card):
    """render_preds (the 2x2 composite: mesh on the crop, mesh in the
    original frame, skeleton, rotated mesh) and make_video on a track's
    predictions, with the UV sphere in place of each frame's vertices: the
    synthetic SMPL's random faces each span the whole panel. Returns ms per
    rendered frame, host time."""
    from human_dynamics_tpu_torch.infer import demo

    verts, faces = uv_sphere(np, *RENDER_SPHERE)
    preds = dict(preds, verts=np.broadcast_to(verts, (len(images),)
                                              + verts.shape))
    t0 = time.perf_counter()
    mp4 = demo.render_preds(out_dir, preds, images, infos, faces,
                            orig_frames=frames)
    ms = (time.perf_counter() - t0) * 1e3 / len(images)
    size = os.path.getsize(mp4)
    print(f"demo render_preds + make_video [{card}], host: {len(images)} "
          f"frames of 448x448 -> {os.path.basename(mp4)} ({size} bytes), "
          f"{ms:.2f} ms per frame")
    check(size > 1000, f"demo video {mp4} has {size} bytes")
    return ms


def phase_demo(torch, np, dev, model, smpl, K, smpl_cuda, card):
    """Phase 16: the demo on in-memory uint8 frames (the card's machine has
    no cv2 to decode PNGs): crops, the fp32 and --fast predictors through
    predict_on_tracks, the pkl, and the native rasterizer."""
    import copy
    import importlib.util
    import tempfile

    from human_dynamics_tpu_torch.infer import HmmrPredictor, WindowSchedule
    from human_dynamics_tpu_torch.infer import demo
    from human_dynamics_tpu_torch.infer.crop import resize_img
    from human_dynamics_tpu_torch.infer.tracks import get_labels_poseflow

    t_phase = time.perf_counter()
    rng = np.random.RandomState(16)
    base = rng.randint(0, 256, (DEMO_H, DEMO_W + DEMO_FRAMES, 3),
                       dtype=np.uint8)
    frames = [np.ascontiguousarray(base[:, i:i + DEMO_W])
              for i in range(DEMO_FRAMES)]
    b, t = 8, 20
    kw = dict(batch_size=b, seq_length=t, device=dev)
    fp32 = HmmrPredictor(model, None, smpl, **kw)
    fast = HmmrPredictor(model, None, smpl, use_fused_smpl=True,
                         bf16_encoder=True, **kw)
    heads = 1 + sum(1 for dt in model.delta_t_values if dt != 0)
    sched = WindowSchedule(DEMO_FRAMES, b, t, model.fov)
    demo_n = sched.count * b * sched.good_frames * heads
    out = {"n": demo_n}
    with tempfile.TemporaryDirectory() as tmp:
        track = write_demo_track(np, os.path.join(tmp, "tracked.json"),
                                 DEMO_FRAMES)
        kps = get_labels_poseflow(track, DEMO_FRAMES)[0]
        check(sum(k is None for k in kps)
              == sum(i < DEMO_FRAMES for i in DEMO_MISSING),
              "demo track: missing detections not read as gaps")

        # Crops: the card against the CPU, the float32 crops and the
        # float64 resize they are cut from.
        got, infos, rng_f = demo.preprocess_track(frames, kps, device=dev)
        want, want_infos, want_f = demo.preprocess_track(frames, kps,
                                                         device="cpu")
        err = max_abs(got.cpu(), want)
        same_meta = rng_f == want_f and all(
            a["im_shape"] == w["im_shape"]
            and np.array_equal(a["start_pt"], w["start_pt"])
            for a, w in zip(infos, want_infos))
        err64 = 0.0
        for i in (0, len(infos) // 2, len(infos) - 1):
            frame, scale = frames[rng_f[0] + i], infos[i]["scale"]
            card64 = resize_img(torch.as_tensor(frame, device=dev), scale)[0]
            cpu64 = torch.as_tensor(resize_img(frame, scale)[0])
            err64 = max(err64, float((card64.cpu() - cpu64).abs().max()))
        print(f"demo crops, {len(got)} frames of {DEMO_H}x{DEMO_W}, bbox "
              f"scale {infos[0]['scale']:.3f}-{infos[-1]['scale']:.3f}: card "
              f"vs CPU float32 crops max abs {err:.3e} (tol "
              f"{DEMO_CROP32_TOL:g}), float64 resize of 3 frames {err64:.3e} "
              f"(tol {DEMO_CROP_TOL:g}), start_pt and im_shape "
              f"{'equal' if same_meta else 'DIFFER'}")
        check(err <= DEMO_CROP32_TOL and err64 <= DEMO_CROP_TOL and same_meta
              and len(got) == DEMO_FRAMES,
              "demo crops: card differs from the CPU")
        del got, want

        # The fp32 and --fast predictors on the whole track, in turns; each
        # run writes its own pkl, then a rerun loads it.
        walls = {"crops": [], "fp32": [], "fast": []}
        launches = []
        for rep, name in enumerate(("fp32", "fast", "fast", "fp32")):
            pred = fp32 if name == "fp32" else fast
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            demo.preprocess_track(frames, kps, device=dev)
            torch.cuda.synchronize()
            walls["crops"].append((time.perf_counter() - t0) * 1e3)
            out_dir = os.path.join(tmp, f"{name}{rep}")
            reset_all(K, smpl_cuda)
            t0 = time.perf_counter()
            preds, images, _, path = demo.predict_on_tracks(
                pred, frames, track, out_dir)
            walls[name].append((time.perf_counter() - t0) * 1e3)
            counts, _ = read_counts(K, smpl_cuda)
            k1 = counts.pop(smpl_cuda.KERNEL_NAME)
            check(k1 == (1 if name == "fast" else 0)
                  and not any(counts.values()),
                  f"demo {name}: launches K1 {k1}, {counts}: want K1 once "
                  f"per --fast track and never for fp32")
            if name == "fast":
                launches.append(k1)
            check_demo_pkl(np, os.path.join(path, "hmmr_output.pkl"),
                           DEMO_FRAMES, f"demo {name}")
            again = demo.predict_on_tracks(pred, frames, track, out_dir)[0]
            check(all(np.array_equal(again[k], preds[k]) for k in preds),
                  f"demo {name}: the rerun did not reuse the pkl")
        print(f"demo: K1 launched {launches} on the --fast tracks of "
              f"{DEMO_FRAMES} frames (N = {demo_n}), 0 on fp32; pkl keys, "
              f"shapes and dtypes equal the JAX demo's; reruns reuse the pkl")
        print(f"demo timing [{card}], ms per {DEMO_FRAMES}-frame track in "
              f"turns fp32, fast, fast, fp32: crops on the device "
              f"{', '.join(f'{w:.2f}' for w in walls['crops'])}; "
              f"predict_on_tracks (crops, prediction, pkl) fp32 "
              f"{', '.join(f'{w:.2f}' for w in walls['fp32'])}, --fast "
              f"{', '.join(f'{w:.2f}' for w in walls['fast'])}")
        out.update(launches=sum(launches), tracks=len(launches),
                   crops_ms=min(walls["crops"]), fp32_ms=min(walls["fp32"]),
                   fast_ms=min(walls["fast"]))

        # The fp32 omegas of a short track against the same call on the
        # CPU (a copy of the model).
        short = write_demo_track(np, os.path.join(tmp, "short.json"),
                                 DEMO_SHORT)
        cpu = HmmrPredictor(copy.deepcopy(model).to("cpu"), None,
                            smpl.to("cpu"), batch_size=b, seq_length=t,
                            device="cpu")
        t0 = time.perf_counter()
        ref = demo.predict_on_tracks(cpu, frames[:DEMO_SHORT], short,
                                     os.path.join(tmp, "short_cpu"))[0]
        cpu_s = time.perf_counter() - t0
        card_preds, images, short_infos, short_out = demo.predict_on_tracks(
            fp32, frames[:DEMO_SHORT], short, os.path.join(tmp, "short_card"))
        errs = {k: float(np.abs(card_preds[k] - ref[k]).max())
                for k in ("omegas", "joints", "verts")}
        print(f"demo fp32, {DEMO_SHORT}-frame track, card vs CPU "
              f"({cpu_s:.1f} s on the CPU): " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items())
              + f" (omegas tol {DEMO_OMEGA_TOL:g})")
        check(errs["omegas"] <= DEMO_OMEGA_TOL,
              f"demo fp32 omegas card vs CPU {errs['omegas']}")
        out["omega_err"] = errs["omegas"]
        del cpu
        out["render"] = demo_renders(np, infos[0], frames[0], card)
        if importlib.util.find_spec("cv2") is None:
            print("demo: render_preds and make_video not driven: they draw "
                  "the skeleton panel and write PNG frames with cv2, which "
                  "this machine lacks; tests/test_torch_demo.py drives them "
                  "against the JAX demo on the CPU")
        else:
            out["video_ms"] = demo_video(np, card_preds, images, short_infos,
                                         frames[:DEMO_SHORT], short_out, card)

    # K1 at the demo's N against its plain version, and timed.
    beta = torch.from_numpy(rng.randn(demo_n, 10).astype(np.float32) * 0.3)
    theta = torch.from_numpy(rng.randn(demo_n, 72).astype(np.float32) * 0.3)
    ops = k1_operands(smpl, smpl_cuda.prepare_fused_constants(smpl),
                      beta.to(dev), theta.to(dev))
    planes = max(max_abs(k, p) for k, p in zip(
        smpl_cuda.blend_skin(*ops), smpl_cuda.blend_skin_reference(*ops)))
    check(planes <= K1_PLANES_TOL, f"K1 planes error {planes} at N={demo_n}")
    k_ms, p_ms = k1_in_turns(torch, ops)
    bound, by = k1_bound(smpl_cuda, demo_n)[:2]
    print(f"K1 N={demo_n} V={SMPL_VERTS} (a --fast demo track of "
          f"{DEMO_FRAMES} frames): planes max|kernel-plain| {planes:.3e}, "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by})")
    out.update(k1_err=planes, ms=k_ms, plain_ms=p_ms, bound_ms=bound)
    print(f"phase 16 (demo): {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the dataset tools
# ---------------------------------------------------------------------------


def ds_frames(np, root, n):
    """n JPEG frames of DEMO_H x DEMO_W (blocky noise sliding left) in
    `root`, and demo_person's 25 keypoints walking through them."""
    import cv2

    rng = np.random.RandomState(17)
    base = cv2.resize(
        rng.randint(0, 256, (DEMO_H // 4, (DEMO_W + 2 * n) // 4 + 1, 3),
                    dtype=np.uint8),
        None, fx=4, fy=4, interpolation=cv2.INTER_NEAREST)
    paths = []
    for i in range(n):
        paths.append(os.path.join(root, f"frame{i:04d}.jpg"))
        cv2.imwrite(paths[-1], base[:, 2 * i:2 * i + DEMO_W])
    return paths, np.stack([demo_person(np, i) for i in range(n)])


def phi_rel(np, got, want):
    """The largest relative L2 distance of a frame's phi."""
    return float((np.linalg.norm(got - want, axis=1)
                  / np.linalg.norm(want, axis=1)).max())


def check_tube_record(np, got, want, what):
    """A tube record of the card against the CPU's: labels within
    DS_LABEL_ATOL, phis within DS_PHI_REL, every other field equal."""
    lab = float(np.abs(got.kps - want.kps).max())
    rel = phi_rel(np, got.phis, want.phis)
    differ = []
    for field in ("n", "image_shapes", "centers", "scale_factors",
                  "start_pts", "time_pts", "image_paths", "image_datas",
                  "poses", "gt3ds", "shape", "cams"):
        g, w = getattr(got, field), getattr(want, field)
        if (g is None) != (w is None) or (
                w is not None and not np.array_equal(np.asarray(g),
                                                     np.asarray(w))):
            differ.append(field)
    print(f"datasets: {what}, card vs CPU: labels max abs {lab:.3e} (tol "
          f"{DS_LABEL_ATOL:g}), phis rel L2 {rel:.3e} (tol {DS_PHI_REL:g}), "
          f"other fields {f'DIFFER: {differ}' if differ else 'equal'}")
    check(lab <= DS_LABEL_ATOL and rel <= DS_PHI_REL and not differ,
          f"datasets: {what} differs from the CPU's")
    return lab, rel


def time_tube(torch, conv, tube, path):
    """Wall ms of one tube through process_tube and into a record file,
    split at the device's synchronised stage boundaries: the host crops
    (bbox smoothing, frame decode, resize, crop: until the augmentation
    starts), the augmentation on the device, the phis, and the rest (the
    record's encoding and write)."""
    from human_dynamics_tpu_torch.data.tfrecord import TFRecordWriter

    marks = {}
    fe = conv.feature_extractor

    def marked(stage, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            marks[stage] = [time.perf_counter()]
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            marks[stage].append(time.perf_counter())
            return result
        return run

    conv._augment_tube = marked("augment", conv._augment_tube)
    fe.compute_all_phis = marked("phis", fe.compute_all_phis)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with TFRecordWriter(path) as w:
            w.write(conv.process_tube(rng_key=0, **tube))
        total = (time.perf_counter() - t0) * 1e3
    finally:
        del conv._augment_tube, fe.compute_all_phis
    split = {"crops": (marks["augment"][0] - t0) * 1e3}
    split.update((k, (marks[k][1] - marks[k][0]) * 1e3)
                 for k in ("augment", "phis"))
    split["write"] = total - sum(split.values())
    return total, split


def fit_iterations(torch, fit, smpl, target, device, **kw):
    """fit(...) with its optimizer steps counted (one an iteration);
    returns (beta, loss, iterations, wall ms)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    steps = [0]
    hook = register_optimizer_step_post_hook(
        lambda opt, args, kwargs: steps.__setitem__(0, steps[0] + 1))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta, loss = fit(smpl, target, device=device, **kw)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        hook.remove()
    return beta, loss, steps[0], wall


def phase_datasets(torch, np, dev, model, smpl, smpl_cuda, card):
    """Phase 17: the dataset tools on a walking person's JPEG frames: phis,
    the augmented tube writer, one training step on its shard, the 3DPW
    neutral-shape fit and a test record."""
    import tempfile

    from human_dynamics_tpu_torch.core import smpl_forward
    from human_dynamics_tpu_torch.data.loader import TrainDataPipeline
    from human_dynamics_tpu_torch.data.schema import (
        parse_temporal_example,
        read_test_example,
    )
    from human_dynamics_tpu_torch.data.tfrecord import read_tfrecord
    from human_dynamics_tpu_torch.datasets import common, tube_writer
    from human_dynamics_tpu_torch.datasets.mocap import write_mocap_records
    from human_dynamics_tpu_torch.datasets.phi_extractor import (
        FeatureExtractor,
    )
    from human_dynamics_tpu_torch.datasets.tdpw import fit_neutral_shape
    from human_dynamics_tpu_torch.datasets.test_records import (
        save_seq_to_test_tfrecord,
    )
    from human_dynamics_tpu_torch.infer.bbox import get_smooth_bbox_params
    from human_dynamics_tpu_torch.train.trainer import Batch, Trainer
    from human_dynamics_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths, kps = ds_frames(np, tmp, DS_FRAMES)
        print(f"datasets: {DS_FRAMES} JPEG frames of {DEMO_H}x{DEMO_W} "
              f"written in {time.perf_counter() - t0:.1f} s")
        fe = FeatureExtractor(model.resnet_v2_50, batch_size=DS_PHI_BATCH,
                              device=dev)
        fe_cpu = FeatureExtractor(model.resnet_v2_50,
                                  batch_size=DS_PHI_BATCH, device="cpu")
        check(fe.resnet is model.resnet_v2_50,
              "datasets: the extractor copied a ResNet already on the card")
        data_dir = os.path.join(tmp, "data")
        conv = tube_writer.TubeConverter(
            os.path.join(data_dir, "insta_variety", "train"),
            feature_extractor=fe)
        conv_cpu = tube_writer.TubeConverter(os.path.join(tmp, "cpu"),
                                             feature_extractor=fe_cpu)

        # Phis of DS_PHI_N augmented crops (a zero-padded batch of 64): the
        # card against the CPU.
        bbox = get_smooth_bbox_params(list(kps[:DS_PHI_N]), 0.0, sigma=3)[0]
        rets = [common.crop_person(common.load_image(paths[i]), kps[i],
                                   bbox[i], tube_writer.CROP, encode=False)
                for i in range(DS_PHI_N)]
        crops224, _ = conv._augment_tube(
            [r["image"] for r in rets], [r["label"] for r in rets],
            [r["center"] for r in rets], 0)
        phis = fe.compute_all_phis(crops224)
        rel = phi_rel(np, phis, fe_cpu.compute_all_phis(crops224.cpu()))
        print(f"datasets: phis of {DS_PHI_N} augmented 224 crops at batch "
              f"{DS_PHI_BATCH}, card vs CPU: max rel L2 per frame {rel:.3e} "
              f"(tol {DS_PHI_REL:g}); mean |phi| "
              f"{np.linalg.norm(phis, axis=1).mean():.3f}")
        check(phis.shape == (DS_PHI_N, 2048) and np.isfinite(phis).all()
              and rel <= DS_PHI_REL, "datasets: phis on the card differ "
              "from the CPU's")
        out["phi_rel"] = rel
        del crops224, rets

        # The tube writer on the card: both tubes into one shard; the short
        # one (rng_key 1) against the same converter on the CPU; a rerun
        # skips the shard.
        tubes = [dict(image_paths=paths, gt2ds=kps),
                 dict(image_paths=paths[:DS_SHORT], gt2ds=kps[:DS_SHORT])]
        t0 = time.perf_counter()
        shard, = conv.write_tubes("ds", tubes)
        first_s = time.perf_counter() - t0
        records = [parse_temporal_example(r)
                   for r in read_tfrecord(shard, check_crc=True)]
        check([r.n for r in records] == [DS_FRAMES, DS_SHORT]
              and all(r.phis.shape == (r.n, 2048)
                      and np.isfinite(r.phis).all()
                      and np.abs(r.kps[..., :2]).max() <= 1.0
                      for r in records),
              "datasets: the shard's records have other shapes")
        out["label_err"], out["tube_phi_rel"] = check_tube_record(
            np, records[1], parse_temporal_example(
                conv_cpu.process_tube(rng_key=1, **tubes[1])),
            f"the {DS_SHORT}-frame tube (draws from seed 0 + rng_key 1)")
        mtime = os.path.getmtime(shard)
        check(conv.write_tubes("ds", tubes) == [shard]
              and os.path.getmtime(shard) == mtime,
              "datasets: a rerun rewrote the shard")
        mib = os.path.getsize(shard) / 2**20
        print(f"datasets: write_tubes of a {DS_FRAMES}- and a {DS_SHORT}-"
              f"frame tube into one shard ({mib:.2f} MiB) in {first_s:.2f} "
              f"s, first call; a rerun skips it")

        # Timings: the long tube split by stage, its frames read and
        # cropped by one thread and by the converter's workers, in turns;
        # then the phis alone.
        workers = conv.workers
        runs = {1: [], workers: []}
        for i, w in enumerate((1, workers, workers, 1)):
            conv.workers = w
            runs[w].append(time_tube(torch, conv, tubes[0], os.path.join(
                tmp, f"timed{i}.tfrecord")))
        conv.workers = workers
        for w in sorted(runs, reverse=True):
            total, split = min(runs[w], key=lambda r: r[0])
            print(f"datasets timing [{card}]: ms per {DS_FRAMES}-frame tube, "
                  f"frames read and cropped by {w} thread(s) (best of "
                  f"{len(runs[w])}; all {[round(r[0], 2) for r in runs[w]]})"
                  f": {total:.2f} = host crops {split['crops']:.2f} + "
                  f"augment on the card {split['augment']:.2f} + phis "
                  f"{split['phis']:.2f} + encode and write "
                  f"{split['write']:.2f}")
        out.update(tube_ms=min(r[0] for r in runs[workers]),
                   tube_ms_1=min(r[0] for r in runs[1]), workers=workers)
        x = torch.rand((3 * DS_PHI_BATCH, IMG, IMG, 3), device=dev) * 2 - 1
        phi_walls = []
        for _ in range(DS_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fe.compute_all_phis(x)
            phi_walls.append(time.perf_counter() - t0)
        fps = len(x) / min(phi_walls[1:])
        print(f"datasets timing [{card}]: phis alone {fps:.1f} frames/s at "
              f"batch {DS_PHI_BATCH} ({len(x)} crops on the card, fp32 "
              f"without TF32; best of {DS_TIMED} after one)")
        out["phi_fps"] = fps
        del x

        # Into training: the shard (read as a 2-D and, linked, a 3-D
        # dataset) and mocap records from the port's converter through the
        # phi-mode pipeline, then one full-width step.
        os.makedirs(os.path.join(data_dir, "h36m", "train"))
        os.symlink(shard, os.path.join(data_dir, "h36m", "train",
                                       "ds.tfrecord"))
        rng = np.random.RandomState(17)
        os.makedirs(os.path.join(tmp, "mosh", "CMU"))
        np.savez(os.path.join(tmp, "mosh", "CMU", "walk.npz"),
                 poses=rng.randn(500, 72).astype(np.float32) * 0.2,
                 betas=rng.randn(10).astype(np.float32) * 0.3)
        write_mocap_records(os.path.join(tmp, "mosh"),
                            os.path.join(data_dir, "mocap_neutrMosh"), "CMU")
        config = Config(batch_size=TRAIN_B, T=TRAIN_T, feature_dim=TRAIN_C,
                        num_kps=SMPL_KPS, use_fused_smpl=True,
                        data_dir=data_dir,
                        datasets=("insta_variety", "h36m"),
                        mocap_datasets=("CMU",))
        pipe = TrainDataPipeline(config)
        try:
            batch = next(iter(pipe))
        finally:
            pipe.close()
        check(batch.phis.shape == (TRAIN_B, TRAIN_T, TRAIN_C),
              f"datasets: pipeline phis {batch.phis.shape}")
        tr = Trainer(config, smpl, device=dev)
        smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] = 0
        losses = tr.step(Batch(*[torch.as_tensor(a, device=dev)
                                 for a in batch]))
        losses = {k: float(v) for k, v in losses.items()}
        k1 = smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]
        print(f"datasets: the shard through TrainDataPipeline (phi mode) "
              f"and one Trainer.step (B={TRAIN_B}, T={TRAIN_T}, feature_dim "
              f"{TRAIN_C}, fused SMPL: K1 launched {k1}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items())))
        check(all(np.isfinite(v) for v in losses.values()) and k1 == 1,
              "datasets: the training step on the shard")
        del tr, batch

        # The 3DPW neutral-shape fit against a known beta: the card's first
        # FIT_CPU_ITERS steps against the CPU's, then the whole fit.
        true_beta = (np.random.RandomState(31).randn(10) * 0.5).astype(
            np.float32)
        target = smpl_forward(
            smpl, torch.from_numpy(true_beta)[None].to(dev),
            torch.zeros((1, 72), device=dev)).verts[0].cpu().numpy()
        kw = dict(lr=0.05, max_iters=FIT_CPU_ITERS, tol=0.0)
        cpu_beta = fit_neutral_shape(smpl.to("cpu"), target, device="cpu",
                                     **kw)[0]
        card_beta = fit_neutral_shape(smpl, target, device=dev, **kw)[0]
        early = float(np.abs(card_beta - cpu_beta).max())
        beta, loss, iters, wall = fit_iterations(
            torch, fit_neutral_shape, smpl, target, dev, lr=0.05,
            max_iters=FIT_ITERS)
        err = float(np.abs(beta - true_beta).max())
        print(f"datasets: fit_neutral_shape on synthetic_smpl_model("
              f"{SMPL_VERTS}, {SMPL_KPS}) [{card}]: beta after "
              f"{FIT_CPU_ITERS} steps {early:.3e} from the CPU's (tol "
              f"{FIT_CPU_TOL:g}); the fit ran {iters} iterations in "
              f"{wall:.1f} ms ({wall / iters:.3f} ms per iteration), loss "
              f"{loss:.3e} (max {FIT_LOSS_MAX:g}), beta {err:.3e} from the "
              f"truth (tol {FIT_BETA_TOL:g})")
        check(early <= FIT_CPU_TOL and loss < FIT_LOSS_MAX
              and err <= FIT_BETA_TOL, "datasets: the neutral-shape fit")
        out.update(fit_early=early, fit_iters=iters,
                   fit_ms_per_iter=wall / iters, fit_loss=loss, fit_err=err)

        # A test record of the whole tube (224 crops), read back.
        rec = os.path.join(tmp, "test.tfrecord")
        t0 = time.perf_counter()
        save_seq_to_test_tfrecord(rec, paths, [kps])
        rec_s = time.perf_counter() - t0
        data = read_test_example(next(read_tfrecord(rec, check_crc=True)))
        check(data["N"] == DS_FRAMES and len(data["images"]) == DS_FRAMES
              and all(im.shape == (224, 224, 3) for im in data["images"]),
              "datasets: the test record")
        print(f"datasets: save_seq_to_test_tfrecord of the {DS_FRAMES} "
              f"frames in {rec_s:.2f} s; read back N = {data['N']}, 224 "
              f"crops")
    print(f"phase 17 (datasets): {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: 2-D (data x time) and tensor-parallel training
# ---------------------------------------------------------------------------


def sharded_world1(torch, dev, smpl, smpl_cuda, card):
    """World 1 on NCCL: a 1x1 2-D Trainer and a 1x1 TP Trainer against the
    plain one from the same state and batch, SHARDED_STEPS steps each, in
    turns (the losses of each step, the first step's gradients); K1's
    launches and operands on each path (the counts set to 0 just before
    each path's steps and read just after); then the three timed in turns.
    """
    import torch.distributed as dist

    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.train.trainer import Trainer

    name = "phi fp32 fused"
    config = dp_configs()[name]
    batch = dp_batch(torch, name, config, dev)
    k1 = smpl_cuda.KERNEL_NAME
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        meshes = {"2d": parallel.make_mesh_2d(1, 1, device=dev),
                  "tp": parallel.make_mesh_tp(1, 1, device=dev)}
        trainers = {"plain": Trainer(config, smpl, device=dev)}
        trainers.update({p: Trainer(config, smpl, device=dev, mesh=m)
                         for p, m in meshes.items()})
        trainers["tp"].state = parallel.shard_params_tp(
            trainers["tp"].state, meshes["tp"])
        blocks = {"plain": batch,
                  "2d": parallel.shard_batch_2d(batch, meshes["2d"]),
                  "tp": parallel.shard_batch(batch, meshes["tp"])}
        out = {"launches": {}, "n": {}, "ops": {}, "loss_err": {},
               "grad_err": {}}
        metrics, grads = {}, {}
        for step in range(SHARDED_STEPS):
            for p in ("plain", "2d", "tp"):
                smpl_cuda.LAUNCHES[k1] = 0
                with Recorder(smpl_cuda, ["blend_skin"]) as rec:
                    m = trainers[p].step(blocks[p])
                    torch.cuda.synchronize()
                out["launches"][p] = (out["launches"].get(p, 0)
                                      + smpl_cuda.LAUNCHES[k1])
                out["n"][p] = [a[0].shape[0] for _, a, _ in rec.calls]
                out["ops"][p] = rec.calls[-1][1]
                metrics.setdefault(p, []).append(
                    {k: float(v) for k, v in m.items()})
                if step == 0:
                    grads[p] = {n: q.grad.clone()
                                for n, q in named_parameters(trainers[p])}
        for p in meshes:
            out["loss_err"][p] = max(
                abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for g, w in zip(metrics[p], metrics["plain"]) for k in w)
            errs = {n: rel_l2(g, grads["plain"][n])
                    for n, g in grads[p].items()}
            worst = max(errs, key=errs.get)
            out["grad_err"][p] = (errs[worst], worst)
            check(out["launches"][p] == SHARDED_STEPS
                  and out["n"][p] == [TRAIN_N],
                  f"sharded world 1 {p}: K1 launched "
                  f"{out['launches'][p]} times in {SHARDED_STEPS} steps at "
                  f"N = {out['n'][p]}")
            check(out["loss_err"][p] <= DP_LOSS_RTOL
                  and errs[worst] <= TRAIN_GRAD_REL,
                  f"sharded world 1 {p}: losses {out['loss_err'][p]}, the "
                  f"gradient of {worst} {errs[worst]} from the plain step")
        del grads
        times = {p: [] for p in trainers}
        for p in ["plain", "2d", "tp", "tp", "2d", "plain"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SHARDED_TIMED):
                trainers[p].step(blocks[p])
            torch.cuda.synchronize()
            times[p].append((time.perf_counter() - t0) * 1e3 / SHARDED_TIMED)
        out["ms"] = {p: min(v) for p, v in times.items()}
        if PROFILE:
            for p in trainers:
                profile_run(torch, f"sharded world 1, {p} step",
                            lambda p=p: trainers[p].step(blocks[p]))
        print(f"sharded world 1 (nccl), {name}, global B={config.batch_size}"
              f" T={config.T}: against the plain Trainer.step from the same "
              f"state, {SHARDED_STEPS} steps: largest relative loss error "
              f"2-D {out['loss_err']['2d']:.3e}, TP "
              f"{out['loss_err']['tp']:.3e} (bound {DP_LOSS_RTOL:g}); first "
              f"step's gradients, worst parameter's relative L2: 2-D "
              f"{out['grad_err']['2d'][0]:.3e} ({out['grad_err']['2d'][1]}),"
              f" TP {out['grad_err']['tp'][0]:.3e} "
              f"({out['grad_err']['tp'][1]}) (bound {TRAIN_GRAD_REL:g}); K1 "
              f"{out['launches']} launches at N = {out['n']}")
        print(f"smoke timing (not a benchmark) [{card}]: sharded world 1, "
              f"ms/step (host clock + synchronise, best of 2 turns of "
              f"{SHARDED_TIMED} steps, in turns plain, 2d, tp, tp, 2d, "
              f"plain): plain {out['ms']['plain']:.2f}, 2-D "
              f"{out['ms']['2d']:.2f}, TP {out['ms']['tp']:.2f} (all {times})")
        del trainers, blocks
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def sharded_rank(torch, dev, rank, world, url, out_path):
    """One rank of phase 18's two-rank group sharing the card over gloo: a
    1 x world 2-D phi run and a 1 x world TP phi run (dp_rank_phi with
    shard_batch_2d / shard_params_tp), then one image (b) 2-D step
    (dp_rank_image with shard_batch_2d); writes its results to out_path."""
    import torch.distributed as dist

    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
    from human_dynamics_tpu_torch.ops import smpl_cuda

    parallel.initialize_multihost(
        {"HD_TPU_COORDINATOR": url, "HD_TPU_NUM_PROCESSES": str(world),
         "HD_TPU_PROCESS_ID": str(rank)}, device=dev, backend="gloo")
    try:
        mesh_2d = parallel.make_mesh_2d(1, world, device=dev)
        mesh_tp = parallel.make_mesh_tp(1, world, device=dev)
        tag = f"sharded world {world} (gloo) rank {rank}"
        smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS,
                                    device=dev)
        t0 = time.perf_counter()
        res = {"2d": dp_rank_phi(torch, dev, mesh_2d, smpl, K, smpl_cuda,
                                 tag + " 2-D", shard=parallel.shard_batch_2d)}
        torch.cuda.empty_cache()
        res["tp"] = dp_rank_phi(torch, dev, mesh_tp, smpl, K, smpl_cuda,
                                tag + " TP", tp=True)
        torch.cuda.empty_cache()
        res["image"] = dp_rank_image(torch, dev, mesh_2d, smpl,
                                     tag + " 2-D",
                                     shard=parallel.shard_batch_2d)
        res["steps_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def sharded_worker(argv):
    """Entry of a phase-18 rank: chip_smoke.py --sharded-worker RANK WORLD
    URL OUT."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, HERE)
    rank, world, url, out_path = argv
    dev = torch.device("cuda", int(rank) % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    sharded_rank(torch, dev, int(rank), int(world), url, out_path)


def phase_sharded(torch, dev, smpl, smpl_cuda, card):
    """Phase 18: 2-D and tensor-parallel training at full width. World 1
    on NCCL in this process; two ranks sharing the card over gloo as
    subprocesses; K1 at each path's N against its plain version, timed in
    turns, with its bound."""
    t_phase = time.perf_counter()
    res = {"world1": sharded_world1(torch, dev, smpl, smpl_cuda, card)}
    ranks, wall = run_rank_group(2, "--sharded-worker", [],
                                 "sharded world 2 (gloo)")
    lead = ranks[0]
    print(f"sharded world 2 (gloo, one card): every rank passed in "
          f"{wall:.1f} s ({lead['steps_s']:.1f} s of steps); "
          + "; ".join(
              f"{p}: {DP_RANK_STEPS} phi steps, ranks equal after each "
              f"({[r[p]['rank_diff'] for r in ranks]}), losses "
              f"{lead[p]['loss_err']:.3e} from the world-1 step (bound "
              f"{DP_LOSS_RTOL:g}), summed gradients "
              f"{lead[p]['grad_err']:.3e} (relative L2, worst parameter; "
              f"bound {TRAIN_GRAD_REL:g}); K1 at N = "
              f"{[r[p]['k1_n'] for r in ranks]}, planes within "
              f"{max(r[p]['k1_err'] for r in ranks):.3e} of plain"
              for p in ("2d", "tp"))
          + f"; image (b) 2-D: ranks equal "
          f"({[r['image']['rank_diff'] for r in ranks]}), losses up to "
          f"{lead['image']['loss_vs_world1']:.3e} from the world-1 bf16 "
          f"step's; from the world-1 fp32 step, the two-rank / world-1 bf16"
          f" losses up to {lead['image']['loss_err']:.3e} / "
          f"{lead['image']['loss_bf16']:.3e}, the HMMR gradient "
          f"{lead['image']['grad_err_e']:.3e} / "
          f"{lead['image']['grad_bf16_e']:.3e}, the discriminator's "
          f"{lead['image']['grad_err_d']:.3e} / "
          f"{lead['image']['grad_bf16_d']:.3e}")
    # K1 at each path's N: the 2-D rank's (two time ranks) and the TP
    # rank's (every model rank decodes its data row's rows); the operands
    # of the world-1 TP step at N = TRAIN_N, seeded draws at the 2-D N.
    consts = smpl_cuda.prepare_fused_constants(smpl)
    g = torch.Generator(device=dev).manual_seed(18)
    n_2d = lead["2d"]["k1_n"][0]
    ops = {"2d": k1_operands(
        smpl, consts, torch.randn(n_2d, 10, generator=g, device=dev) * 0.3,
        torch.randn(n_2d, 72, generator=g, device=dev) * 0.3),
        "tp": res["world1"]["ops"]["tp"]}
    res["k1"] = {}
    for p, o in ops.items():
        n = o[0].shape[0]
        err = max(max_abs(a, b) for a, b in zip(
            smpl_cuda.blend_skin(*o), smpl_cuda.blend_skin_reference(*o)))
        check(err <= K1_PLANES_TOL, f"sharded: K1 planes at N = {n}: {err}")
        k_ms, p_ms = k1_in_turns(torch, o)
        b_ms, b_by = k1_bound(smpl_cuda, n)[:2]
        res["k1"][p] = {"n": n, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "err": err}
        print(f"K1 N={n} V={SMPL_VERTS} (a {p} rank's rows of a 1x2 "
              f"step): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); planes within {err:.3e} of plain")
    res["world2"] = ranks
    print(f"phase 18 (2-D and TP training) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return res


GEN_SMPL_FIELDS = ("mosh/gt3ds", "image/xys", "image/face_pts",
                   "image/toe_pts")


def compare_generated(np, root_a, root_b, what):
    """Two generate_data trees: every record field equal, but the SMPL
    ones within GEN_TOL of their scale and the frames by the pixel rule.
    Returns (largest scaled SMPL-field error, share of pixels differing)."""
    import glob

    from human_dynamics_tpu_torch.data.tfrecord import (
        decode_example,
        read_tfrecord,
    )

    def names(root):
        return sorted(os.path.relpath(p, root) for p in glob.glob(
            os.path.join(root, "**", "*.tfrecord"), recursive=True))

    check(names(root_a) == names(root_b), f"{what}: other record files")
    err, differ, total = 0.0, 0, 0
    for name in names(root_a):
        recs = [[decode_example(r) for r in read_tfrecord(
            os.path.join(root, name))] for root in (root_a, root_b)]
        check(len(recs[0]) == len(recs[1]) > 0, f"{what} {name}: records")
        for fa, fb in zip(*recs):
            check(sorted(fa) == sorted(fb), f"{what} {name}: other fields")
            for k in fa:
                if k == "image/encoded":
                    d, t = compare_frames(np, fa, fb, f"{what} {name}")
                    differ, total = differ + d, total + t
                elif k in GEN_SMPL_FIELDS:
                    a, b = (np.asarray(x, np.float32) for x in (fa[k], fb[k]))
                    e = float(np.abs(a - b).max()) / max(
                        1.0, float(np.abs(b).max()))
                    check(e <= GEN_TOL, f"{what} {name} {k}: {e}")
                    err = max(err, e)
                else:
                    check(np.array_equal(np.asarray(fa[k]),
                                         np.asarray(fb[k])),
                          f"{what} {name} {k} differs")
    share = differ / total if total else 0.0
    check(share <= GEN_PIXEL_SHARE, f"{what}: {share} of the pixels differ")
    return err, share


def compare_frames(np, fa, fb, what):
    """Frames whose joints round to the same pixels are byte-equal; returns
    (pixels differing, pixels) after decoding."""
    import cv2

    n = len(fa["image/encoded"])
    xy = [np.round(np.concatenate([
        np.asarray(f[k], np.float32).reshape(n, -1)
        for k in ("image/xys", "image/face_pts", "image/toe_pts")], 1))
        for f in (fa, fb)]
    differ = total = 0
    for i, (ja, jb) in enumerate(zip(fa["image/encoded"],
                                     fb["image/encoded"])):
        if np.array_equal(xy[0][i], xy[1][i]):
            check(bytes(ja) == bytes(jb), f"{what}: frame {i} differs")
        a, b = (cv2.imdecode(np.frombuffer(bytes(j), np.uint8),
                             cv2.IMREAD_COLOR) for j in (ja, jb))
        differ += int((a != b).any(-1).sum())
        total += a.shape[0] * a.shape[1]
    return differ, total


def gauntlet_card_vs_cpu(torch, np, dev, tmp):
    """The generator's records on the card against the same call on the
    CPU, in phi mode and (where cv2 is importable) image mode."""
    import importlib.util

    from human_dynamics_tpu_torch.scripts.stability_run import generate_data

    modes = ["phi"] + (["image"] if importlib.util.find_spec("cv2") else [])
    for mode in modes:
        roots = []
        for tag, where in (("card", dev), ("cpu", "cpu")):
            out = os.path.join(tmp, f"gen_{mode}_{tag}")
            roots.append(generate_data(out, with_images=mode == "image",
                                       device=where, **GEN_SMALL)[0])
        err, share = compare_generated(np, *roots, f"generator {mode}")
        print(f"gauntlet generator, {mode} mode, {GEN_SMALL}: the card's "
              f"records against the CPU's: numpy fields equal, SMPL "
              f"fields within {err:.3e} of their scale (tol {GEN_TOL:g})"
              + (f", {share:.3e} of the decoded pixels differ (bound "
                 f"{GEN_PIXEL_SHARE:g})" if mode == "image" else ""))
    if "image" not in modes:
        print("gauntlet generator: no cv2 here, image mode not compared")


class K1Operands:
    """Wraps smpl_cuda.blend_skin: counts its calls by N and keeps a copy of
    the first operands at each N. The launches are counted by the wrapper
    it calls."""

    def __init__(self, smpl_cuda):
        self.smpl_cuda, self.by_n, self.ops = smpl_cuda, {}, {}

    def __enter__(self):
        self.saved = fn = self.smpl_cuda.blend_skin

        def wrapper(*ops):
            n = ops[0].shape[0]
            self.by_n[n] = self.by_n.get(n, 0) + 1
            if n not in self.ops:
                self.ops[n] = tuple(o.detach().clone() for o in ops)
            return fn(*ops)

        self.smpl_cuda.blend_skin = wrapper
        return self

    def __exit__(self, *exc):
        self.smpl_cuda.blend_skin = self.saved


def phase_gauntlet(torch, np, dev, K, smpl_cuda, card):
    """Phase 19: the phi-mode synthetic gauntlet at full width, through
    scripts.synthetic_gauntlet.run_gauntlet: the generator held to the CPU,
    K1's launches over the run against what the code makes, and K1 held to
    its plain version at the run's N values."""
    import importlib.util
    import pickle
    import tempfile

    from human_dynamics_tpu_torch.infer import WindowSchedule
    from human_dynamics_tpu_torch.scripts import synthetic_gauntlet as G
    from human_dynamics_tpu_torch.train import trainer as T
    from human_dynamics_tpu_torch.data.loader import TrainDataPipeline
    from human_dynamics_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        gauntlet_card_vs_cpu(torch, np, dev, tmp)

        # Without cv2 the numpy mesh metric cannot run: the device one.
        device_metrics = importlib.util.find_spec("cv2") is None
        out = os.path.join(tmp, "gauntlet")
        args = G.build_arg_parser().parse_args(
            ["--out", out, "--device", str(dev), "--fused",
             "--num_steps", str(GAUNTLET_STEPS),
             "--save_step", str(GAUNTLET_SAVE),
             "--num_tubes", str(GAUNTLET_TUBES),
             "--num_test_tubes", str(GAUNTLET_TEST),
             "--frames_per_tube", str(GAUNTLET_FRAMES),
             "--batch_size", str(TRAIN_B), "--T", str(TRAIN_T),
             "--feature_dim", str(TRAIN_C),
             "--report", os.path.join(tmp, "report.md")]
            + (["--device_metrics"] if device_metrics else []))
        step_times = []
        step = T.Trainer.step

        def timed_step(self, batch):
            metrics = step(self, batch)
            step_times.append(time.perf_counter())
            return metrics

        reset_all(K, smpl_cuda)
        T.Trainer.step = timed_step
        try:
            with K1Operands(smpl_cuda) as k1:
                t0 = time.perf_counter()
                result = G.run_gauntlet(args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            T.Trainer.step = step
        counts, _ = read_counts(K, smpl_cuda)

        table = {int(k): v for k, v in result["table"].items()}
        steps = sorted(table)
        ckpts = steps[1:]
        check(ckpts == list(range(GAUNTLET_SAVE, GAUNTLET_STEPS + 1,
                                  GAUNTLET_SAVE)),
              f"gauntlet: checkpoints at {ckpts}")
        for s in steps:
            print(f"gauntlet [{card}] step {s}: " + ", ".join(
                f"{k} {table[s][k]:.5f}" for k in G.METRIC_KEYS))
            for k in G.METRIC_KEYS:
                check(np.isfinite(table[s][k]), f"gauntlet: {k} at step {s}")
        check(all(np.isfinite(v) for v in result["const_table"].values()),
              "gauntlet: a constant-baseline metric is not finite")
        first, last = table[0], table[steps[-1]]
        for k in ("kp", "joints"):
            check(last[k] < first[k], f"gauntlet: {k} {last[k]} at step "
                  f"{steps[-1]} is not below the untrained {first[k]}")
        print(f"gauntlet gates after {GAUNTLET_STEPS} steps (calibrated for "
              f"4000; printed, not checked here): {result['gates']}")
        with open(os.path.join(out, "demo_out", "hmmr_output.pkl"),
                  "rb") as f:
            preds = pickle.load(f)
        # The predictor's keys and their delta stacks (the JAX package's
        # schema), and the gauntlet's frame_range.
        heads = ("cams", "joints", "kps", "poses", "shapes", "verts",
                 "omegas")
        want_keys = {"frame_range", *heads, *(f"{k}_delta" for k in heads)}
        check(set(preds) == want_keys, f"gauntlet: demo pkl keys "
              f"{sorted(preds)}")
        check(preds["frame_range"].tolist() == [0, GAUNTLET_FRAMES]
              and preds["omegas"].shape == (GAUNTLET_FRAMES, 85),
              "gauntlet: demo pkl frame_range or omegas shape")
        for path in (os.path.join(out, "gauntlet_results.json"),
                     args.report):
            check(os.path.exists(path), f"gauntlet: {path} not written")

        # K1: one launch per fused step, per tube the evaluator predicts
        # (every test tube once per checkpoint and for the baseline;
        # run_const reads the prediction cache, or predicts again with
        # device_metrics, which keeps no cache), and one for the demo.
        n_steps = len(step_times)
        tubes = GAUNTLET_TEST * (len(ckpts) + 1 + int(device_metrics))
        want = n_steps + tubes + 1
        sched = WindowSchedule(GAUNTLET_FRAMES, TRAIN_B, TRAIN_T,
                               Config().fov)
        eval_n = sched.count * TRAIN_B * sched.good_frames * 3
        print(f"gauntlet: K1 launched {counts[smpl_cuda.KERNEL_NAME]} times "
              f"(want {want}: {n_steps} fused steps, {tubes} tubes "
              f"predicted, 1 demo clip); calls by N {k1.by_n}; int8 "
              f"kernels {dict((k, v) for k, v in counts.items() if k != smpl_cuda.KERNEL_NAME)}")
        check(n_steps == GAUNTLET_STEPS, f"gauntlet: {n_steps} steps")
        check(counts[smpl_cuda.KERNEL_NAME] == want,
              f"gauntlet: K1 launched {counts[smpl_cuda.KERNEL_NAME]} "
              f"times, want {want}")
        check(k1.by_n == {TRAIN_N: n_steps, eval_n: tubes + 1},
              f"gauntlet: K1 calls by N {k1.by_n}")
        check(all(v == 0 for k, v in counts.items()
                  if k != smpl_cuda.KERNEL_NAME),
              f"gauntlet: int8 kernels launched: {counts}")

        # The loader alone on the loop's records: the prefetch thread's
        # rate, iterated as fast as it yields.
        pipeline = TrainDataPipeline(Config(
            data_dir=os.path.join(out, "data"), datasets=("synth", "h36m"),
            mocap_datasets=("CMU",), batch_size=TRAIN_B, T=TRAIN_T,
            feature_dim=TRAIN_C))
        try:
            batches = iter(pipeline)
            for _ in range(5):
                next(batches)
            t0 = time.perf_counter()
            for _ in range(N_LOADER_BATCHES):
                next(batches)
            loader_ms = (time.perf_counter() - t0) / N_LOADER_BATCHES * 1e3
        finally:
            pipeline.close()

        # K1 against its plain version on the operands the run gave it.
        v = k1.ops[TRAIN_N][2].shape[-1]
        res["k1"] = {}
        for what, n in (("train", TRAIN_N), ("eval", eval_n)):
            ops = k1.ops[n]
            err = max(max_abs(a, b) for a, b in zip(
                smpl_cuda.blend_skin(*ops),
                smpl_cuda.blend_skin_reference(*ops)))
            check(err <= K1_PLANES_TOL,
                  f"gauntlet: K1 planes at N = {n}: {err}")
            k_ms, p_ms = k1_in_turns(torch, ops)
            b_ms, b_by = k1_bound(smpl_cuda, n, v)[:2]
            res["k1"][what] = {"n": n, "v": v, "ms": k_ms, "plain_ms": p_ms,
                               "bound_ms": b_ms, "err": err}
            print(f"K1 N={n} V={v} (the gauntlet's {what} calls): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}); planes within {err:.3e} of plain (tol "
                  f"{K1_PLANES_TOL:g})")

    sec = result["seconds"]
    ms_step = (step_times[-1] - step_times[9]) / (n_steps - 10) * 1e3
    eval_s = {k: round(t, 3) for k, t in sec["eval"].items()}
    print(f"gauntlet timing [{card}]: {wall:.1f} s for the loop (generate "
          f"{sec['generate']:.1f} s, train.main {sec['train']:.1f} s, "
          f"eval per checkpoint {eval_s} s), {ms_step:.2f} ms per training "
          f"step (host clock, steps 10-{n_steps}, checkpoint saves "
          f"included); the phi loader alone {loader_ms:.2f} ms per batch "
          f"({N_LOADER_BATCHES} batches of the loop's records, host clock)")
    print(f"phase 19 (the synthetic gauntlet) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    res.update(launches=counts[smpl_cuda.KERNEL_NAME], steps=n_steps,
               ms_step=ms_step, loader_ms=loader_ms)
    return res


# ---------------------------------------------------------------------------
# Phase 20: the int8 root stems and the int8 residual stream
# ---------------------------------------------------------------------------


def root_counts(K, R):
    """The launch counts phase 20 holds to models.resnet_int8.plan_launches:
    the fused stem and pool, K2's units, the standalone pre-activations,
    the convs by epilogue and every pre-activation by mode."""
    return {"root_pool": R.LAUNCHES[R.STEM_POOL],
            "block": K.LAUNCHES[K.BLOCK], "preact": K.LAUNCHES[K.PREACT],
            "conv": {e: K.EPILOGUE_LAUNCHES[e]
                     for e in ("dequant", "requant", "stream")},
            "preact_modes": dict(K.PREACT_MODE_LAUNCHES)}


def check_root_counts(K, R, plan, what):
    """The launches of one counted run against what its plan predicts."""
    from human_dynamics_tpu_torch.models import resnet_int8 as T

    got, want = root_counts(K, R), T.plan_launches(plan)
    n_conv = sum(want["conv"].values())
    check(got == want and K.LAUNCHES[K.CONV] == n_conv
          and sum(K.EPILOGUE_LAUNCHES.values()) == n_conv
          and sum(K.PATH_LAUNCHES.values()) == n_conv,
          f"{what}: launches {got} (conv {dict(K.LAUNCHES)}, by epilogue "
          f"{dict(K.EPILOGUE_LAUNCHES)}), the plan predicts {want}")
    return got


def stem_pool_bound(args, kw):
    """(bound ms, by, ops, bytes) of one fused stem + pool call: the stem's
    7x7x3 taps (2 ops a multiply-add; the folds' further K slots hold zero
    weights and are not the function's work) at the int8 rate; the frames,
    the weights, the epilogue operands, the border map's entries at the
    border (all the function reads of it) and the pre-activation's
    operands read once, the pooled map written once."""
    from human_dynamics_tpu_torch.ops import int8_root_cuda as R

    x, wt, mul, add = args
    h, w = x.shape[1], x.shape[2]
    ho, wo = R.root_geometry(h, w, kw["fold"])
    po, qo = R.same_pool_geometry(ho)[0], R.same_pool_geometry(wo)[0]
    ops = 2 * x.shape[0] * ho * wo * wt.shape[0] * STEM_TAPS
    b = nbytes(x, wt, mul, add) + x.shape[0] * po * qo * wt.shape[0]
    if kw.get("border") is not None:
        border = R.border_mask(h, w, kw["fold"])
        b += int(border.sum()) * wt.shape[0] * 4
    pre = kw.get("preact")
    if pre is not None:
        b += nbytes(pre.pa, pre.pb, pre.s, pre.ds)
    return bound_ms(ops, INT8_OPS, b) + (ops, b)


def stream_conv_bound(torch, K, xq, wt, kw):
    """(operations, bytes) of one stream-epilogue conv call: the shortcut
    counted as read once at its stride (a strided int8 shortcut is read at
    a quarter of its pixels), the int8 stream and any fused
    pre-activation written once."""
    ks, ho, wo = K.conv_geometry(xq, wt, 1)
    m, cout = xq.shape[0] * ho * wo, wt.shape[0]
    res = kw["residual"]
    res_b = m * cout * res.element_size()
    b = nbytes(xq, wt, kw["mul"], kw["add"], kw["res_scale"]) + res_b + m * cout
    pre = kw.get("preact")
    if pre is not None:
        b += nbytes(pre.pa, pre.pb, pre.s, pre.ds) + m * cout
    return 2 * m * wt.shape[1] * cout, b


def replay_root_calls(torch, K, R, calls, what, preacts):
    """Every recorded call of phase 20's kernels, the kernel against its
    plain version on the card: the fused stem + pool's int8 output in its
    own mode and in each of modes -1, 2 and 3 (``preacts``: mode -> Preact
    or None), the stream conv's int32 accumulators, int8 stream and fused
    pre-activation, and the standalone mode-2 / mode-3 pre-activations,
    equal. Returns the largest difference by kind (0 when equal) and the
    number of calls replayed."""
    err = {"root_pool": 0.0, "stream": 0.0, "preact_s8": 0.0}
    n = {k: 0 for k in err}
    with torch.no_grad():
        for name, args, kw in calls:
            if name == "root_stem_pool":
                for pre in [kw.get("preact")] + list(preacts.values()):
                    kw_ = dict(kw, preact=pre)
                    got = R.root_stem_pool(*args, **kw_)
                    want = R.root_stem_pool_reference(*args, **kw_)
                    check(torch.equal(got, want), f"{what}: root_stem_pool "
                          f"({kw['fold']}, {kw['kind']}, mode "
                          f"{pre.mode if pre else -1}) differs from its "
                          f"plain version")
                    err["root_pool"] = max(err["root_pool"],
                                           max_abs(got, want))
                    n["root_pool"] += 1
                continue
            if name == "preact_quant" and kw.get("mode") in (2, 3):
                got = K.preact_quant(*args, **kw)
                want = K.preact_quant_reference(*args, **kw)
                key = "preact_s8"
            elif name == "conv_s8" and kw.get("epilogue") == "stream":
                xq, wt, stride = args
                acc = K.conv_s8(xq, wt, stride)
                acc_ref = K.conv_s8_reference(xq, wt, stride)
                check(torch.equal(acc, acc_ref),
                      f"{what}: stream conv accumulators differ")
                got = K.conv_s8(xq, wt, stride, **kw)
                want = K.epilogue_reference(acc_ref, **kw)
                if kw.get("preact") is not None:
                    check(torch.equal(got[1], want[1]), f"{what}: the stream "
                          f"conv's fused mode-{kw['preact'].mode} "
                          f"pre-activation differs")
                    err["stream"] = max(err["stream"],
                                        max_abs(got[1], want[1]))
                    got, want = got[0], want[0]
                key = "stream"
            else:
                continue
            n[key] += 1
            check(torch.equal(got, want),
                  f"{what}: {name} differs from its plain version")
            err[key] = max(err[key], max_abs(got, want))
    print(f"{what}: replayed {n} calls of the fused stem + pool (each "
          f"recorded call also in modes -1, 2 and 3), the stream epilogue "
          f"and the int8-input pre-activation: equal to their plain "
          f"versions (max abs {err})")
    return err, n


def bf16_stem_parts(torch, head, x):
    """The bf16 stem the port runs without int8_root, in its two timed
    parts: the NHWC -> NCHW permute, cuDNN's bf16 7x7/2 conv and the bias;
    then max_pool_same and the permute back (models/resnet_int8._root)."""
    import torch.nn.functional as F
    from human_dynamics_tpu_torch.models.resnet import max_pool_same

    w = head["root/w"].permute(3, 2, 0, 1)

    def conv():
        y = F.conv2d(x.to(torch.bfloat16).permute(0, 3, 1, 2), w, stride=2,
                     padding=3)
        return y + head["root/b"][:, None, None]

    y = conv()
    return conv, lambda: max_pool_same(y).permute(0, 2, 3, 1).contiguous()


def phase_int8_root(torch, np, model, frames, calib, bench, smpl, kw, K,
                    smpl_cuda, card):
    """Phase 20: the int8 root stems and the int8 residual stream."""
    from human_dynamics_tpu_torch.infer import (HmmrPredictor,
                                                StreamingPredictor)
    from human_dynamics_tpu_torch.models import resnet_int8 as T
    from human_dynamics_tpu_torch.ops import int8_root_cuda as R

    raw = frames[:CHUNK].contiguous()
    x = HmmrPredictor._normalise(raw)
    with torch.no_grad():
        qp = T.prepare_int8_params(model.resnet_v2_50)
        scales = T.calibrate_int8_scales(
            qp, calib.float() * (2.0 / 255.0) - 1.0)
        base = T.run_int8_static(T.prepare_int8_static(qp, scales), x)
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            phi_fp32 = model.resnet_v2_50(x)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())

    # Every variant, counted against its plan; its calls recorded.
    runs, totals = {}, {"root_pool": 0, "stream": 0, "mode2": 0}
    names = ["root_stem_pool", "conv_s8", "preact_quant", "fused_block_pq"]
    for name, opts, u8 in ROOT_RUNS:
        images = raw if u8 else x
        with torch.no_grad():
            plan = T.prepare_int8_static(qp, scales, **opts)
            T.run_int8_static(plan, images)  # warm-up; makes the u8 map
            torch.cuda.synchronize()
            with Recorder(T, names) as rec:
                reset_counts(K)
                phi = T.run_int8_static(plan, images)
                torch.cuda.synchronize()
                counts = check_root_counts(K, R, plan, f"int8 trunk {name}")
        totals["root_pool"] += counts["root_pool"]
        totals["stream"] += counts["conv"]["stream"]
        totals["mode2"] += counts["preact_modes"][2]
        c_f, rel = cos(phi, phi_fp32), float((phi - base).norm() / base.norm())
        print(f"int8 trunk {name} {opts}, {CHUNK} frames of {IMG}x{IMG} "
              f"({'uint8' if u8 else 'f32'}): launches {counts}, as the plan "
              f"predicts; phi finite, min cos to fp32 {c_f:.6f} (>= "
              f"{ROOT_FP32_COS}), rel to the base int8 trunk {rel:.4f} (<= "
              f"{ROOT_REL})")
        check(bool(torch.isfinite(phi).all()) and c_f >= ROOT_FP32_COS
              and rel <= ROOT_REL, f"int8 trunk {name} is off")
        runs[name] = {"plan": plan, "calls": rec.calls, "images": images}
    calls = [c for r in runs.values() for c in r["calls"]]
    preacts = {-1: None, 2: runs["s2d_stream_1"]["plan"]["pool_preact"],
               3: runs["s2d"]["plan"]["pool_preact"]}
    check(preacts[2].mode == 2 and preacts[3].mode == 3,
          "phase 20: the plans' pool pre-activations are not modes 2 and 3")
    err, replayed = replay_root_calls(torch, K, R, calls, "phase 20",
                                      preacts)
    # s2d, wfold, u8 and s2d_stream_1 record a fused call each, every one
    # replayed in its own mode and in modes -1, 2 and 3.
    for key, want in (("root_pool", 16), ("stream", 1), ("preact_s8", 1)):
        check(replayed[key] >= want, f"phase 20 replayed {replayed[key]} "
              f"{key} calls, want at least {want}")

    # Times, kernel and plain version in turns; the bf16 stem beside them.
    out = {}
    lib_conv, lib_pool = bf16_stem_parts(torch, runs["s2d"]["plan"]["head"],
                                         x)
    with torch.no_grad():
        lib_conv_ms = cuda_ms(lib_conv, 10)
        lib_pool_ms = cuda_ms(lib_pool, 10)
        lib_ms = cuda_ms(lambda: T._root(runs["s2d"]["plan"]["head"], x),
                         10)
        print(f"bf16 stem (the port's without int8_root), {CHUNK} frames: "
              f"permute + cuDNN bf16 7x7/2 conv + bias {lib_conv_ms:.4f} ms, "
              f"max_pool_same + permute back {lib_pool_ms:.4f} ms, the "
              f"whole _root {lib_ms:.4f} ms (CUDA events, 10 runs)")
        stems = {}
        for name in ("s2d", "wfold", "u8", "s2d_stream_1"):
            (_, args, kwargs), = [c for c in runs[name]["calls"]
                                  if c[0] == "root_stem_pool"]
            k_ms, p_ms = in_turns(
                lambda: R.root_stem_pool(*args, **kwargs),
                lambda: R.root_stem_pool_reference(*args, **kwargs))
            b_ms, b_by, ops, b = stem_pool_bound(args, kwargs)
            stems[name] = (k_ms, p_ms, b_ms, b_by)
            print(f"  stem + pool {name} ({kwargs['fold']}, {kwargs['kind']} "
                  f"frames, K {args[1].shape[1]}, pre-activation mode "
                  f"{kwargs['preact'].mode}): kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                  f"{ops / 1e9:.2f} GOP, {b / 1e6:.1f} MB; "
                  f"{ops / k_ms / 1e9:.1f} TOP/s of the stem's taps); the "
                  f"bf16 _root {lib_ms:.4f} ms")
        # No stem map in device memory: the call's peak allocation is its
        # pooled output.
        (_, args, kwargs), = [c for c in runs["u8"]["calls"]
                              if c[0] == "root_stem_pool"]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pooled = R.root_stem_pool(*args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ho, wo = R.root_geometry(args[0].shape[1], args[0].shape[2],
                                 kwargs["fold"])
        stem_map = args[0].shape[0] * ho * wo * R.COUT
        print(f"  stem + pool u8: {peak / 1e6:.1f} MB allocated at the peak "
              f"of a call (its pooled output {pooled.numel() / 1e6:.1f} MB; "
              f"the stem map it keeps on chip {stem_map / 1e6:.1f} MB)")
        check(peak <= pooled.numel() + (1 << 20),
              f"stem + pool allocated {peak} bytes, more than its output")
        del pooled
        k_ms, p_ms, b_ms, b_by = stems["u8"]
        out["root_pool"] = {
            "max_abs_err": err["root_pool"], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "launches": totals["root_pool"], "s2d_ms": stems["s2d"][0],
            "wfold_ms": stems["wfold"][0],
            "mode2_ms": stems["s2d_stream_1"][0]}
        # The stream epilogue: every stream conv of the all-blocks run.
        st = {"ms": 0.0, "plain_ms": 0.0, "ops": 0, "bytes": 0, "n": 0}
        for name_, args, kwargs in runs["stream"]["calls"]:
            if name_ != "conv_s8" or kwargs.get("epilogue") != "stream":
                continue
            xq, wt, stride = args
            d_ms = min(device_ms(lambda: K.conv_s8(xq, wt, stride, **kwargs))
                       for _ in range(2))
            _, p_ms = in_turns(
                lambda: K.conv_s8(xq, wt, stride, **kwargs),
                lambda: K.epilogue_reference(
                    K.conv_s8_reference(xq, wt, stride), **kwargs), 2, 2)
            ops, b = stream_conv_bound(torch, K, xq, wt, kwargs)
            st["ms"] += d_ms
            st["plain_ms"] += p_ms
            st["ops"] += ops
            st["bytes"] += b
            st["n"] += 1
        s_bound, s_by = bound_ms(st["ops"], INT8_OPS, st["bytes"])
        print(f"  stream epilogue: the {st['n']} conv3 calls of the "
              f"int8_stream=True chunk: kernel device {st['ms']:.4f} ms, "
              f"plain {st['plain_ms']:.4f} ms, bound {s_bound:.4f} ms "
              f"({s_by}: {st['ops'] / 1e12:.3f} TOP, {st['bytes'] / 1e9:.3f} "
              f"GB)")
        out["stream"] = {"max_abs_err": err["stream"], "ms": st["ms"],
                         "plain_ms": st["plain_ms"], "bound_ms": s_bound,
                         "bound_by": s_by, "library_ms": None,
                         "launches": totals["stream"]}
        (_, args, kwargs), = [
            c for c in runs["stream"]["calls"]
            if c[0] == "preact_quant" and c[2].get("mode") == 2]
        k_ms, p_ms = in_turns(lambda: K.preact_quant(*args, **kwargs),
                              lambda: K.preact_quant_reference(*args,
                                                               **kwargs))
        xin = args[0]
        b = nbytes(xin, args[1], args[2]) + xin.numel()
        p_bound, p_by = bound_ms(3 * xin.numel(), FP32_OPS, b)
        print(f"  mode-2 pre-activation, standalone, {tuple(xin.shape)} "
              f"int8: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{p_bound:.4f} ms ({p_by})")
        out["preact_s8"] = {"max_abs_err": err["preact_s8"], "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": p_bound,
                            "bound_by": p_by, "library_ms": None,
                            "launches": totals["mode2"]}

    # The predictor in the bench configuration with int8_root="u8".
    u8 = HmmrPredictor(model, None, smpl, int8_encoder=True,
                       int8_calibration=calib, int8_root="u8",
                       bf16_temporal=True, use_fused_smpl=True, **kw)
    chunks = -(-len(frames) // u8.encode_chunk)
    want_out = bench.predict_all_images(frames, as_numpy=False)
    reset_all(K, smpl_cuda)
    got = u8.predict_all_images(frames, as_numpy=False)
    torch.cuda.synchronize()
    counts = root_counts(K, R)
    check_predictor_outputs(torch, got, "bench config + int8_root='u8'")
    per_chunk = T.plan_launches(u8._int8_plan)
    want_counts = {k: (v * chunks if isinstance(v, int)
                       else {m: c * chunks for m, c in v.items()})
                   for k, v in per_chunk.items()}
    print(f"predictor bench config + int8_root='u8', one {len(frames)}-frame "
          f"uint8 clip ({chunks} chunks): launches {counts}, K1 "
          f"{smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]}")
    check(counts == want_counts and smpl_cuda.LAUNCHES[
        smpl_cuda.KERNEL_NAME] == 1, f"u8 clip launches: want {want_counts}")
    out["root_pool"]["clip_launches"] = counts["root_pool"]
    check(counts["root_pool"] == chunks, f"u8 clip: {counts['root_pool']} "
          f"stem + pool launches for {chunks} encoder chunks")
    err = max_abs(got["omegas"], want_out["omegas"])
    print(f"predictor bench config + int8_root='u8' against the bench "
          f"config: omegas max abs diff {err:.4f} (tol {OMEGA_TOL})")
    check(err < OMEGA_TOL, f"u8 omegas differ from the bench config by {err}")
    # The clip in turns with the bench config.
    preds = {"bench": bench, "bench_u8": u8}
    times = {name: [] for name in preds}
    order = ["bench", "bench_u8"]
    for name in (order + order[::-1]) * N_ROOT_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds[name].predict_all_images(frames, as_numpy=False)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = float(np.median(ts))
        print(f"smoke timing (not a benchmark) [{card}]: predictor {name}: "
              f"{med * 1e3:.2f} ms/clip of {len(frames)} uint8 frames "
              f"(median of {len(ts)}, in turns; all ms "
              f"{[round(t * 1e3, 2) for t in ts]})")
    out["clip_ms"] = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    # A uint8 stream through the byte-direct stem against its offline output.
    sp = StreamingPredictor(u8)
    n_calls, emits = stream_encoder_calls(sp, len(frames))
    reset_all(K, smpl_cuda)
    emissions = feed_pieces(sp, frames, STREAM_PIECES)
    torch.cuda.synchronize()
    check(R.LAUNCHES[R.STEM_POOL] == n_calls
          and len(emissions) == emits and K.LAUNCHES[K.PREACT] == 0,
          f"u8 stream: {R.LAUNCHES} for {n_calls} encoder calls, "
          f"{dict(K.LAUNCHES)}")
    check_stream(torch, "streaming bench config + int8_root='u8' (uint8 "
                 "pieces)", u8, emissions, got)
    # Where each clip's time goes in this process: its kernels' device time
    # and the device's idle share (a clip whose host is the slower side
    # shows all of the host's time), and what else holds the host.
    import threading

    names = sorted(t.name for t in threading.enumerate())
    print(f"phase 20's process: {len(names)} threads {names}, "
          f"{torch.get_num_threads()} torch CPU threads")
    out["clip_kernel_ms"] = {}
    for name in order:
        _, total = profile_run(
            torch, f"predictor {name}, one clip",
            lambda: preds[name].predict_all_images(frames, as_numpy=False))
        out["clip_kernel_ms"][name] = total
    return out


def phase_tf_checkpoint(torch, np, dev, smpl_cuda, card):
    """Phase 21: the TF-slim fixture read without TensorFlow and run through
    the phi predictor on the card against the CPU; MocapTemporalStream."""
    import tempfile

    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.data.loader import MocapTemporalStream
    from human_dynamics_tpu_torch.datasets.mocap import (
        write_mocap_temporal_records,
    )
    from human_dynamics_tpu_torch.infer import HmmrPredictor
    from human_dynamics_tpu_torch.models import HmmrModel
    from human_dynamics_tpu_torch.utils import tf_bundle
    from human_dynamics_tpu_torch.utils.checkpoint import convert_tf_checkpoint
    from human_dynamics_tpu_torch.utils.weights import load_jax_variables

    bundles = {}
    for sub in ("", "sharded"):
        d = os.path.join(TF_FIXTURE, sub)
        t0 = time.perf_counter()
        reader = tf_bundle.load_checkpoint(d)
        values = {k: reader.get_tensor(k)
                  for k in reader.get_variable_to_shape_map()}
        sec = time.perf_counter() - t0
        mb = sum(v.nbytes for v in values.values()) / 2**20
        shards = sum(".data-" in f for f in os.listdir(d))
        print(f"TF bundle reader [{card}]: {os.path.relpath(d, HERE)}, "
              f"{len(values)} variables, {shards} data shard(s), {mb:.3f} MB "
              f"in {sec * 1e3:.2f} ms, {sec * 1e3 / mb:.2f} ms/MB "
              f"(index, CRC-32C of every value, host clock)")
        bundles[sub or "one"] = values
    one, two = bundles["one"], bundles["sharded"]
    check(int(one["global_step"]) == 1 and one["global_step"].dtype
          == np.int64, "the fixture's global_step is not an int64 1")
    for k, v in two.items():
        check(v.dtype == one[k].dtype and np.array_equal(v, one[k]),
              f"{k} differs between the 1- and 2-shard bundles")
    t0 = time.perf_counter()
    variables = convert_tf_checkpoint(TF_FIXTURE, strict=True, **TF_SLIM_KW)
    print(f"convert_tf_checkpoint (strict): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    phi = torch.from_numpy(np.random.RandomState(21).randn(
        TF_PHI_FRAMES, TF_FEATURE).astype(np.float32))

    def predict(device):
        model = HmmrModel(feature_dim=TF_FEATURE, device="meta",
                          **TF_SLIM_KW).to_empty(device="cpu")
        load_jax_variables(model, variables)
        smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS)
        pred = HmmrPredictor(model, None, smpl, batch_size=8, seq_length=20,
                             use_fused_smpl=True, device=device)
        return pred.predict_all_images(phi.to(device), as_numpy=False)

    ref = predict("cpu")
    smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] = 0
    out = predict(dev)
    torch.cuda.synchronize()
    launches = smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]
    check(launches > 0, "the phi predictor on the TF fixture did not launch "
          "K1")
    check(set(out) == set(ref), "card and CPU outputs have other keys")
    for k, shape in (("verts", (TF_PHI_FRAMES, SMPL_VERTS, 3)),
                     ("omegas", (TF_PHI_FRAMES, 85))):
        check(tuple(out[k].shape) == shape, f"TF fixture phi predictor: {k} "
              f"has shape {tuple(out[k].shape)}, want {shape}")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()),
              f"TF fixture phi predictor: {k} is not finite")
    errs = {k: max_abs(out[k].cpu(), ref[k])
            for k in ("omegas", "joints", "verts")}
    print(f"TF fixture phi predictor, {TF_PHI_FRAMES} frames (B=8, T=20), "
          f"card vs CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       errs.items())
          + f" (omegas bound {TF32_OMEGA_TOL:g}); K1 launched {launches} "
          "time(s)")
    check(errs["omegas"] <= TF32_OMEGA_TOL,
          f"TF fixture omegas card vs CPU {errs['omegas']}")

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(22)
        src = []
        for i in range(MOCAP_SEQS):
            d = os.path.join(tmp, "mosh", "CMU")
            os.makedirs(d, exist_ok=True)
            poses = rng.randn(MOCAP_FRAMES, 72).astype(np.float32)
            np.savez(os.path.join(d, f"seq{i}.npz"), poses=poses,
                     betas=rng.randn(10).astype(np.float32))
            sub = poses[::4]
            src += [sub[s:s + MOCAP_WINDOW].tobytes() for s in
                    range(0, len(sub) - MOCAP_WINDOW, MOCAP_WINDOW)]
        write_mocap_temporal_records(
            os.path.join(tmp, "mosh"),
            os.path.join(tmp, "mocap_neutrMosh_temporal_pose"), "CMU")
        files = MocapTemporalStream.mocap_files(tmp, ["CMU"])
        stream = iter(MocapTemporalStream(files, seed=0))
        seen = []
        for _ in range(2 * len(src)):
            pose, deltas = next(stream)
            check(pose.shape == (MOCAP_WINDOW, 72)
                  and deltas.shape == (MOCAP_WINDOW - 1, 72),
                  f"temporal mocap shapes {pose.shape}, {deltas.shape}")
            check(np.array_equal(deltas, pose[1:] - pose[:-1]),
                  "temporal mocap deltas != poses[1:] - poses[:-1]")
            seen.append(pose.tobytes())
    for p in range(2):
        check(sorted(seen[p * len(src):(p + 1) * len(src)]) == sorted(src),
              f"pass {p} of MocapTemporalStream is not every window once")
    print(f"MocapTemporalStream: {len(files)} file(s), two passes of "
          f"{len(src)} windows of {MOCAP_WINDOW} frames, deltas equal")
    return {"launches": launches, "omegas_err": errs["omegas"]}


def main():
    import numpy as np
    import torch

    # Phase 0: device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one GPU")
    sys.path.insert(0, HERE)
    import human_dynamics_tpu_torch as port

    check(os.path.dirname(os.path.abspath(port.__file__))
          == os.path.join(HERE, "human_dynamics_tpu_torch"),
          f"imported the port from {port.__file__}, not from this checkout")
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.infer import HmmrPredictor, WindowSchedule
    from human_dynamics_tpu_torch.models import HmmrModel
    from human_dynamics_tpu_torch.ops import resnet_int8_cuda as K
    from human_dynamics_tpu_torch.ops import smpl_cuda
    from human_dynamics_tpu_torch.ops._build import load_kernel_libraries

    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    print(f"TF32 in force: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    # Phase 1: build.
    from human_dynamics_tpu_torch.ops import int8_root_cuda

    build_all(load_kernel_libraries, [smpl_cuda.KERNEL_NAME, K.KERNEL_NAME,
                                      K.K2_KERNEL_NAME,
                                      int8_root_cuda.KERNEL_NAME])

    # Phase 2: K1 against its plain version, TF32 off for the plain products.
    smpl = synthetic_smpl_model(num_verts=SMPL_VERTS, num_kps=SMPL_KPS,
                                device=dev)
    consts = smpl_cuda.prepare_fused_constants(smpl)
    b, t = 8, 20
    model = HmmrModel(include_resnet=True, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    sched = WindowSchedule(N_FRAMES, b, t, model.fov)
    heads = 1 + sum(1 for dt in model.delta_t_values if dt != 0)
    main_n = sched.count * b * sched.good_frames * heads
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        k1 = phase_k1(torch, np, dev, smpl, consts, main_n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32

    # Phase 3: the fp32 predictor end to end.
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (N_FRAMES, IMG, IMG, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    kw = dict(batch_size=b, seq_length=t, device=dev)
    fused = HmmrPredictor(model, None, smpl, use_fused_smpl=True, **kw)
    unfused = HmmrPredictor(model, None, smpl, use_fused_smpl=False, **kw)

    smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] = 0
    out = fused.predict_all_images(frames, as_numpy=False)
    torch.cuda.synchronize()
    launches = smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME]
    print(f"predictor fp32 (fused): K1 launched {launches} time(s) for "
          f"{N_FRAMES} frames")
    check(launches > 0, "the fp32 predictor did not launch K1")
    print("predictor shapes: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in sorted(out.items())))
    check_predictor_outputs(torch, out, "fp32 predictor")

    ref = unfused.predict_all_images(frames, as_numpy=False)
    torch.cuda.synchronize()
    check(smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] == launches,
          "the unfused predictor launched K1")
    check(set(ref) == set(out), "fused and unfused outputs have other keys")
    for k in ("omegas", "omegas_delta"):
        check(torch.equal(out[k], ref[k]), f"{k} differ between fused and "
              "unfused SMPL")
    for k in ("verts", "joints", "kps", "verts_delta", "joints_delta",
              "kps_delta"):
        err = max_abs(out[k], ref[k])
        print(f"predictor fused vs unfused: {k} max abs diff {err:.3e} "
              f"(tol 2e-4)")
        check(err <= 2e-4, f"{k} fused vs unfused differs by {err}")
    omegas_fp32 = out["omegas"]
    del out, ref, unfused

    # Phase 4: the int8 trunk and its kernels.
    int8 = phase_int8_kernels(torch, model, frames)

    # Phase 5: the predictor in the bench configuration, and bf16_encoder.
    calib = torch.randint(0, 256, (N_CALIB, IMG, IMG, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
    bench = HmmrPredictor(model, None, smpl, int8_encoder=True,
                          int8_calibration=calib, bf16_temporal=True,
                          use_fused_smpl=True, **kw)
    bf16 = HmmrPredictor(model, None, smpl, bf16_encoder=True,
                         use_fused_smpl=True, **kw)
    reset_counts(K)
    smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] = 0
    out = bench.predict_all_images(frames, as_numpy=False)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES, **smpl_cuda.LAUNCHES)
    paths = dict(K.PATH_LAUNCHES)
    chunks = -(-N_FRAMES // bench.encode_chunk)
    print(f"predictor bench config (int8 + calibration + bf16_temporal + "
          f"fused SMPL), one {N_FRAMES}-frame clip ({chunks} chunks): "
          f"launches {counts}, conv by path {paths}")
    for name in (K.CONV, K.PREACT, smpl_cuda.KERNEL_NAME):
        check(counts[name] > 0, f"the bench-config predictor did not launch "
              f"{name}")
    want = {K.CONV: 52 * chunks, K.PREACT: chunks, K.BLOCK: 0}
    check(all(counts[k] == v for k, v in want.items())
          and paths == {"tma": 36 * chunks, "gather": 16 * chunks},
          f"bench-config launches per clip: want {want} and conv by path "
          f"tma {36 * chunks}, gather {16 * chunks}")
    check_predictor_outputs(torch, out, "bench-config predictor")
    for name, o in (("bench config", out),
                    ("bf16_encoder", bf16.predict_all_images(
                        frames, as_numpy=False))):
        check_predictor_outputs(torch, o, name)
        err = max_abs(o["omegas"], omegas_fp32)
        print(f"predictor {name}: omegas max abs diff to fp32 {err:.4f} "
              f"(tol {OMEGA_TOL})")
        check(err < OMEGA_TOL, f"{name} omegas differ from fp32 by {err}")
    del out

    # Phase 6: smoke timing, in turns.
    preds = {"fp32": fused, "bf16_encoder": bf16, "int8_bench": bench}
    times = {name: [] for name in preds}
    order = ["fp32", "bf16_encoder", "int8_bench"]
    for name in order + order[::-1] + order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds[name].predict_all_images(frames, as_numpy=False)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = float(np.median(ts))
        print(f"smoke timing (not a benchmark) [{card}]: predictor {name}: "
              f"{med * 1e3:.2f} ms/clip of {N_FRAMES} frames, "
              f"{N_FRAMES / med:.1f} frames/s (median of {len(ts)}; all ms "
              f"{[round(x * 1e3, 2) for x in ts]})")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if PROFILE:
        bench.predict_all_images(frames, as_numpy=False)
        profile_run(torch, "int8 bench config, one clip",
                    lambda: bench.predict_all_images(frames, as_numpy=False))

    # Phase 7: streaming, bench config, B=8, against offline.
    from human_dynamics_tpu_torch.models import resnet_int8 as R

    offline = bench.predict_all_images(frames, as_numpy=False)
    phase_streaming(torch, bench, frames, offline, K, smpl_cuda, R)

    # Phase 8: streaming latency at B=1.
    b1 = dict(batch_size=1, seq_length=t, use_fused_smpl=True, device=dev)
    for name, pred in (
        ("bench config", HmmrPredictor(
            model, None, smpl, int8_encoder=True, int8_calibration=calib,
            bf16_temporal=True, **b1)),
        ("fp32", HmmrPredictor(model, None, smpl, **b1)),
    ):
        phase_latency(torch, np, name, pred, frames, K, smpl_cuda, R, card)

    # Phase 9: the service, 4 submitters and a live stream.
    clips = [torch.randint(0, 256, (N_FRAMES, IMG, IMG, 3), dtype=torch.uint8,
                           device=dev, generator=gen) for _ in range(4)]
    phase_service(torch, bench, clips, frames, offline, K, smpl_cuda, card)
    del clips, offline

    # Phase 10: evaluation in the --fast configuration.
    phase_eval(torch, np, bf16, frames, K, smpl_cuda, card)

    # Phase 11: TF32 in the fp32 predictor, against the CPU.
    phase_tf32(torch, np, dev)

    # Phase 12: phi-mode training.
    train = phase_train(torch, np, dev, smpl, K, smpl_cuda, card)

    # Phase 13: image-mode training.
    image = phase_train_image(torch, np, dev, smpl, K, smpl_cuda, card)

    # Phase 14: multi-GPU inference.
    mesh = phase_mesh(torch, np, dev, K, smpl_cuda, card)

    # Phase 15: data-parallel training.
    dp = phase_dp(torch, np, dev, smpl, K, smpl_cuda, card)

    # Phase 16: the demo.
    dm = phase_demo(torch, np, dev, model, smpl, K, smpl_cuda, card)

    # Phase 17: the dataset tools.
    phase_datasets(torch, np, dev, model, smpl, smpl_cuda, card)

    # Phase 18: 2-D (data x time) and tensor-parallel training.
    sh = phase_sharded(torch, dev, smpl, smpl_cuda, card)

    # Phase 19: the synthetic gauntlet, phi mode.
    ga = phase_gauntlet(torch, np, dev, K, smpl_cuda, card)

    # Phase 20: the int8 root stems and the int8 residual stream.
    t20 = time.perf_counter()
    ir = phase_int8_root(torch, np, model, frames, calib, bench, smpl, kw, K,
                         smpl_cuda, card)
    print(f"phase 20 took {time.perf_counter() - t20:.1f} s")

    # Phase 21: TF-slim checkpoints without TensorFlow; MocapTemporalStream.
    t21 = time.perf_counter()
    phase_tf_checkpoint(torch, np, dev, smpl_cuda, card)
    print(f"phase 21 took {time.perf_counter() - t21:.1f} s")

    csrc = "human_dynamics_tpu_torch/ops/csrc/"
    kernels = [
        dict(name=smpl_cuda.KERNEL_NAME, source=csrc + "smpl_blend_skin.cu",
             replaces="human_dynamics_tpu/ops/smpl_pallas.py:108",
             launches=launches, train_launches=train["train_launches"],
             train_steps=train["train_steps"],
             image_train_launches=image["image_train_launches"],
             image_train_steps=image["image_train_steps"],
             sharded_launches=mesh["launches"][smpl_cuda.KERNEL_NAME],
             sharded_n=mesh["k1_n"][0],
             dp_launches=dp["world1"]["launches"],
             dp_steps=dp["world1"]["steps"], dp_rank_n=dp["k1"]["n"],
             dp_ms=dp["k1"]["ms"], dp_plain_ms=dp["k1"]["plain_ms"],
             dp_bound_ms=dp["k1"]["bound_ms"], demo_launches=dm["launches"],
             demo_tracks=dm["tracks"], demo_n=dm["n"], demo_ms=dm["ms"],
             demo_plain_ms=dm["plain_ms"], demo_bound_ms=dm["bound_ms"],
             mesh2d_launches=sh["world1"]["launches"]["2d"],
             mesh2d_n=sh["k1"]["2d"]["n"], mesh2d_ms=sh["k1"]["2d"]["ms"],
             mesh2d_plain_ms=sh["k1"]["2d"]["plain_ms"],
             mesh2d_bound_ms=sh["k1"]["2d"]["bound_ms"],
             tp_launches=sh["world1"]["launches"]["tp"],
             tp_n=sh["k1"]["tp"]["n"], tp_ms=sh["k1"]["tp"]["ms"],
             tp_plain_ms=sh["k1"]["tp"]["plain_ms"],
             tp_bound_ms=sh["k1"]["tp"]["bound_ms"],
             gauntlet_launches=ga["launches"], gauntlet_steps=ga["steps"],
             gauntlet_v=ga["k1"]["train"]["v"],
             gauntlet_train_n=ga["k1"]["train"]["n"],
             gauntlet_train_ms=ga["k1"]["train"]["ms"],
             gauntlet_train_plain_ms=ga["k1"]["train"]["plain_ms"],
             gauntlet_train_bound_ms=ga["k1"]["train"]["bound_ms"],
             gauntlet_eval_n=ga["k1"]["eval"]["n"],
             gauntlet_eval_ms=ga["k1"]["eval"]["ms"],
             gauntlet_eval_plain_ms=ga["k1"]["eval"]["plain_ms"],
             gauntlet_eval_bound_ms=ga["k1"]["eval"]["bound_ms"],
             **k1),
        dict(name=K.BLOCK, source=csrc + "k2_unit.cu",
             replaces="human_dynamics_tpu/ops/resnet_int8_pallas.py:151",
             **int8["k2"]),
        dict(name=K.CONV, source=csrc + "resnet_int8.cu",
             replaces="human_dynamics_tpu/models/resnet_int8.py:262",
             launches=counts[K.CONV], **int8["conv"]),
        dict(name=K.PREACT, source=csrc + "resnet_int8.cu",
             replaces="human_dynamics_tpu/models/resnet_int8.py:578",
             launches=counts[K.PREACT], **int8["preact"]),
        # Phase 20's kernels: launches over its six trunk chunks (each
        # counted against its plan), clip_launches in the bench config
        # with int8_root="u8"; the fused stem + pool's times are the u8
        # stem's (mode 3), s2d_ms, wfold_ms and mode2_ms those of the
        # other recorded calls.
        dict(name=int8_root_cuda.STEM_POOL, source=csrc + "int8_root.cu",
             replaces="human_dynamics_tpu/models/resnet_int8.py:371",
             **ir["root_pool"]),
        dict(name="resnet_int8_conv_stream", source=csrc + "resnet_int8.cu",
             replaces="human_dynamics_tpu/models/resnet_int8.py:633",
             **ir["stream"]),
        dict(name="resnet_int8_preact_s8", source=csrc + "resnet_int8.cu",
             replaces="human_dynamics_tpu/models/resnet_int8.py:565",
             **ir["preact_s8"]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K1 also runs on the training paths: its launches over the phase-12
    # steps and the phase-13 timed steps, and its times at a training
    # step's N; on the sharded windowed path (phase 14, world 1, one clip)
    # at the rank's N; on the data-parallel step (phase 15: its
    # launches over the world-1 DP steps, one per step, and its times at a
    # rank's N of a two-rank step); and on the --fast demo (phase 16: its
    # launches over the --fast tracks, one per track, and its times at the
    # track's N); on the 2-D and TP steps (phase 18: its launches over the
    # world-1 steps of each, one per step, and its times at the N of a
    # rank of the two-rank 2-D and TP steps); and on the synthetic
    # gauntlet (phase 19: its launches over the whole loop, and its times
    # at the N of a training step and of a test tube, at the generator's
    # V).
    train_keys = ("train_launches", "train_steps", "train_n", "train_ms",
                  "train_plain_ms", "train_bound_ms", "image_train_launches",
                  "image_train_steps", "sharded_launches", "sharded_n",
                  "dp_launches", "dp_steps", "dp_rank_n", "dp_ms",
                  "dp_plain_ms", "dp_bound_ms", "demo_launches",
                  "demo_tracks", "demo_n", "demo_ms", "demo_plain_ms",
                  "demo_bound_ms", "mesh2d_launches", "mesh2d_n",
                  "mesh2d_ms", "mesh2d_plain_ms", "mesh2d_bound_ms",
                  "tp_launches", "tp_n", "tp_ms", "tp_plain_ms",
                  "tp_bound_ms", "gauntlet_launches", "gauntlet_steps",
                  "gauntlet_v", "gauntlet_train_n", "gauntlet_train_ms",
                  "gauntlet_train_plain_ms", "gauntlet_train_bound_ms",
                  "gauntlet_eval_n", "gauntlet_eval_ms",
                  "gauntlet_eval_plain_ms", "gauntlet_eval_bound_ms",
                  "byte_floor_ms", "conv_chain_ms", "clip_launches",
                  "s2d_ms", "wfold_ms", "mode2_ms")
    print(json.dumps({"kernels": [
        {k: dict(kern, route="cuda")[k] for k in keys
         + tuple(k for k in train_keys if k in kern)} for kern in kernels
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--sharded-worker"]:
        sharded_worker(sys.argv[2:])
    else:
        main()
