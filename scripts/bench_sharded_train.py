#!/usr/bin/env python3
"""chip_smoke.py's phase 18 alone: 2-D (data x time) and tensor-parallel
training on the card.

    python3 scripts/bench_sharded_train.py [--profile]
    python3 scripts/bench_sharded_train.py --cards N

Needs one CUDA card and nvcc (K1 runs in every step). It builds K1, makes
the synthetic SMPL model as chip_smoke.py's main does and runs
``chip_smoke.phase_sharded`` at full width (phi mode, feature_dim 2048,
global B=8, T=20, fused SMPL): a 1x1 2-D Trainer and a 1x1 TP Trainer
against the plain step on NCCL (losses, first-step gradients, K1's
launches, ms/step of the three in turns); two ranks sharing the card over
gloo (chip_smoke.py --sharded-worker): 1x2 2-D and 1x2 TP phi steps and an
image-mode (b) 1x2 2-D step, every rank equal after each; K1 at each
path's N against its plain version, timed in turns, with its bound.

With ``--cards N`` (N cards of one host, N even) it runs N ranks on NCCL
instead, one per card, on the same phi batch: a data-parallel (N), a 2-D
(N/2 x 2) and a TP (N/2 x 2) Trainer, each stepped once and held to rank
0's plain single-card step (losses within chip_smoke's DP_LOSS_RTOL), every
rank's state (a TP state gathered whole) equal to rank 0's and K1 once per
rank at the rank's N; then ms/step of the three and of rank 0's plain step
in turns (plain, dp, 2d, tp, tp, 2d, dp, plain; rank 0's host clock, the
rank synchronised, every rank at a barrier between turns).
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def cards_rank(rank, cards, port, dev=None, backend="nccl"):
    """One rank of the --cards run; rank 0 prints the results as a JSON
    line."""
    import json

    import torch
    import torch.distributed as dist

    import chip_smoke as S
    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.ops import smpl_cuda
    from human_dynamics_tpu_torch.parallel.mesh import barrier
    from human_dynamics_tpu_torch.train.trainer import Trainer

    dev = dev or torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=cards, rank=rank)
    try:
        name = "phi fp32 fused"
        config = S.dp_configs()[name]
        batch = S.dp_batch(torch, name, config, dev)
        smpl = synthetic_smpl_model(num_verts=S.SMPL_VERTS,
                                    num_kps=S.SMPL_KPS, device=dev)
        meshes = {"dp": parallel.make_mesh(cards, device=dev),
                  "2d": parallel.make_mesh_2d(cards // 2, 2, device=dev),
                  "tp": parallel.make_mesh_tp(cards // 2, 2, device=dev)}
        plain = Trainer(config, smpl, device=dev) if rank == 0 else None
        want = ({k: float(v) for k, v in plain.step(batch).items()}
                if plain else None)
        trainers, blocks, res = {}, {}, {"cards": cards, "k1_n": {},
                                         "rank_diff": {}, "loss_err": {}}
        for kind, mesh in meshes.items():
            tr = Trainer(config, smpl, device=dev, mesh=mesh)
            if kind == "tp":
                tr.state = parallel.shard_params_tp(tr.state, mesh)
            block = (parallel.shard_batch_2d if kind == "2d"
                     else parallel.shard_batch)(batch, mesh)
            smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] = 0
            with S.Recorder(smpl_cuda, ["blend_skin"]) as rec:
                got = tr.step(block)
                torch.cuda.synchronize()
            n = [a[0].shape[0] for _, a, _ in rec.calls]
            rank_n = S.TRAIN_N // mesh.axis_size(mesh.batch_axes)
            S.check(smpl_cuda.LAUNCHES[smpl_cuda.KERNEL_NAME] == 1
                    and n == [rank_n], f"{kind} rank {rank}: K1 at N = {n}")
            with parallel.gathered_tp(tr.state):
                diff = S.max_rank_difference(torch, tr.state_tensors(), mesh)
            S.check(diff == 0.0, f"{kind}: the ranks differ by {diff}")
            res["k1_n"][kind], res["rank_diff"][kind] = n[0], diff
            if want is not None:
                err = max(abs(float(got[k]) - w) / max(abs(w), 1e-30)
                          for k, w in want.items())
                S.check(err <= S.DP_LOSS_RTOL, f"{kind}: losses {err} from "
                        "the plain step")
                res["loss_err"][kind] = err
            trainers[kind], blocks[kind] = tr, block
        times = {k: [] for k in ("plain", *meshes)}
        for kind in ("plain", "dp", "2d", "tp", "tp", "2d", "dp", "plain"):
            barrier(meshes["dp"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(S.SHARDED_TIMED):
                if kind != "plain":
                    trainers[kind].step(blocks[kind])
                elif plain is not None:
                    plain.step(batch)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3
                               / S.SHARDED_TIMED)
        res["ms"] = {k: min(v) for k, v in times.items()}
        res["all_ms"] = times
        if rank == 0:
            print(json.dumps(res))
    finally:
        dist.destroy_process_group()


def run_cards(cards):
    """The --cards run: K1 built once here, then one process per card."""
    import chip_smoke as S
    from human_dynamics_tpu_torch.ops import smpl_cuda
    from human_dynamics_tpu_torch.ops._build import load_kernel_libraries

    S.build_all(load_kernel_libraries, [smpl_cuda.KERNEL_NAME])
    port = S.free_port()
    argv = lambda r: [sys.executable, os.path.abspath(__file__),
                      "--cards-rank", str(r), str(cards), str(port)]
    t0 = time.perf_counter()
    S.run_processes([argv(r) for r in range(cards)],
                    [dict(os.environ)] * cards, f"{cards} cards on NCCL")
    print(f"{cards} ranks passed in {time.perf_counter() - t0:.1f} s")


def main():
    import torch

    import chip_smoke as S

    if not torch.cuda.is_available():
        raise SystemExit("bench_sharded_train: no CUDA device; this script "
                         "needs one GPU")
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.ops import smpl_cuda
    from human_dynamics_tpu_torch.ops._build import load_kernel_libraries

    card = S.card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    S.build_all(load_kernel_libraries, [smpl_cuda.KERNEL_NAME])
    dev = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(num_verts=S.SMPL_VERTS, num_kps=S.SMPL_KPS,
                                device=dev)
    t0 = time.perf_counter()
    result = S.phase_sharded(torch, dev, smpl, smpl_cuda, card)
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    print({k: v for k, v in result.items() if k != "world1"})
    print(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards-rank"]:
        cards_rank(*map(int, sys.argv[2:5]))
    elif sys.argv[1:2] == ["--cards"]:
        run_cards(int(sys.argv[2]))
    else:
        main()
