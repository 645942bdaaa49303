"""One rank of the port's multi-process tests: a gloo group on the CPU.

    python tests/torch_mesh_worker.py INIT_URL WORLD RANK IN.pt OUT.pt

The rank joins the group through ``parallel.initialize`` and the HD_TPU_*
environment contract, runs every case listed in IN.pt (a ``torch.save``d
dict: the cases, the models' state dicts and the inputs), and saves its
results to OUT.pt. Every rank runs the same cases in the same order, as
SPMD code does. It imports the port, never JAX.

``run_group`` starts a whole group as subprocesses with a timeout, so a
deadlock fails the test instead of hanging it.
"""

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_group(workdir, world, payload, timeout=150):
    """Run ``world`` worker processes on ``payload``; returns each rank's
    results, rank 0 first. Fails (raises) on a non-zero exit or a
    timeout, after killing every worker."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "in.pt")
    torch.save(payload, inp)
    url = "file://" + os.path.join(workdir, "rendezvous")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [os.path.join(workdir, f"rank{r}.pt") for r in range(world)]
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), url, str(world),
             str(r), inp, outs[r]],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=REPO,
        )
        for r in range(world)
    ]
    try:
        for p in procs:
            p.wait(timeout=timeout)
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
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"rank {r} of {world} exited with {p.returncode}:\n"
                + "\n".join(f"--- rank {i} ---\n{t[-4000:]}"
                            for i, t in enumerate(texts)))
    return [torch.load(o) for o in outs]


def _tensors(out):
    if isinstance(out, dict):
        return {k: _tensors(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [_tensors(v) for v in out]
    if isinstance(out, np.ndarray):
        return torch.from_numpy(out)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().clone()
    return out


def _predictor(payload, key, **kw):
    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.infer import HmmrPredictor
    from human_dynamics_tpu_torch.models import HmmrModel

    model_kw, state = payload["models"][key]
    model = HmmrModel(device="meta", **model_kw).to_empty(device="cpu")
    model.load_state_dict(state)
    smpl = synthetic_smpl_model(num_verts=48, num_kps=25)
    return HmmrPredictor(model, None, smpl, batch_size=2, seq_length=20,
                         device="cpu", **kw)


def _serve(payload, args, mesh, rank):
    """Rank 0: a mesh-backed service per mode (a clip, a request with the
    wrong feature width, and in windowed mode a live stream); other
    ranks: follow."""
    from human_dynamics_tpu_torch.infer import PredictionService

    pred = _predictor(payload, args["model"])
    phi, stream_phi = payload["inputs"][args["phi"]], payload["inputs"][
        args["stream_phi"]]
    out = {}
    for mode in ("windowed", "halo"):
        if rank != 0:
            out[mode] = PredictionService.follow(pred, mesh)
            continue
        with PredictionService(pred, as_numpy=True, mesh=mesh,
                               mesh_mode=mode) as service:
            fut = service.submit(phi.numpy())
            bad = service.submit(np.zeros((5, 7), np.float32))
            feeds = []
            if mode == "windowed":
                session = service.open_stream()
                feeds = [session.feed(c) for c in
                         np.array_split(stream_phi.numpy(), 3)]
                feeds.append(session.flush())
            got = fut.result(timeout=120)
            try:
                bad.result(timeout=120)
                bad_error = ""
            except ValueError as e:
                bad_error = str(e)
            emissions = [e for f in feeds for e in f.result(timeout=120)]
        out[mode] = {"result": got, "bad_error": bad_error,
                     "stats": service.stats()}
        if emissions:
            out[mode]["stream_omegas"] = np.concatenate(
                [e["omegas"] for e in emissions])
    return out


def _train_batch(arrays, mesh):
    """This rank's block of a global train Batch (numpy or tensors):
    ``shard_batch_2d`` on a (data, time) mesh, else ``shard_batch``."""
    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.train.trainer import Batch

    if "time" in mesh.shape:
        return parallel.shard_batch_2d(Batch(**arrays), mesh)
    return parallel.shard_batch(Batch(**arrays), mesh)


def _train_mesh(args, world):
    """The mesh of a "train" case: ``mesh`` ("2d", d, t) or ("tp", d, m),
    else a data mesh over the world."""
    from human_dynamics_tpu_torch import parallel

    kind = args.get("mesh")
    if kind is None:
        return parallel.make_mesh(world, "data", device="cpu")
    make = {"2d": parallel.make_mesh_2d, "tp": parallel.make_mesh_tp}
    return make[kind[0]](*kind[1:], device="cpu")


def _trainer_state(tr):
    """A Trainer's parameters, moving averages and Adam moments by name."""
    st = tr.state
    out = {}
    for tag, module, opt in (("e", st.hmmr, st.opt_e), ("d", st.disc,
                                                         st.opt_d)):
        for n, p in module.named_parameters():
            out[f"{tag}.{n}"] = p
            for key in ("exp_avg", "exp_avg_sq"):
                if p in opt.state:
                    out[f"{tag}.{n}:{key}"] = opt.state[p][key]
        for n, b in module.named_buffers():
            out[f"{tag}.{n}"] = b
    return out


def _train(payload, args, mesh):
    """A sharded Trainer on ``mesh`` from the payload's weights, ``steps``
    steps on this rank's block of the global batch; returns the metrics of
    each step, the summed gradients of each (rank 0 only) and the state
    after the last. ``blocks`` builds a narrow ResNet; ``dropout`` False
    evaluates the heads without dropout, as the JAX comparisons do. On a
    (data, model) mesh the state is ``shard_params_tp``ed (``min_dim``),
    the gradients and the state are the whole tensors, the names of the
    sharded weights come back, and with ``save`` the Trainer writes a
    checkpoint to its config's model_dir at the end and restores it."""
    import contextlib
    import functools

    from human_dynamics_tpu_torch.core import synthetic_smpl_model
    from human_dynamics_tpu_torch.models import hmmr as PH
    from human_dynamics_tpu_torch.models import resnet as PR
    from human_dynamics_tpu_torch.parallel import gathered_tp, shard_params_tp
    from human_dynamics_tpu_torch.train.trainer import Trainer
    from human_dynamics_tpu_torch.utils.config import Config

    resnet = PH.ResNetV2_50
    if "blocks" in args:
        PH.ResNetV2_50 = functools.partial(PR.ResNetV2_50,
                                           blocks=args["blocks"])
    try:
        tr = Trainer(Config(**args["config"]),
                     synthetic_smpl_model(num_verts=32,
                                          num_kps=args["num_kps"]),
                     device="cpu", mesh=mesh)
    finally:
        PH.ResNetV2_50 = resnet
    state_e, state_d = payload["states"][args["state"]]
    tr.state.hmmr.load_state_dict(state_e)
    tr.state.disc.load_state_dict(state_d)
    if not args.get("dropout", True):
        heads = tr.state.hmmr._pred_heads
        tr.state.hmmr._pred_heads = lambda f, with_deltas, train, g: heads(
            f, with_deltas, False, None)
    tp = "model" in mesh.shape
    out = {}
    if tp:
        tr.state = shard_params_tp(tr.state, mesh,
                                   min_dim=args.get("min_dim", 128))
        out["sharded"] = sorted(
            f"{tag}.{n}.weight" for tag, module in (("e", tr.state.hmmr),
                                                    ("d", tr.state.disc))
            for n, m in module.named_modules() if "_tp" in m.__dict__)
    whole = (lambda: gathered_tp(tr.state)) if tp else contextlib.nullcontext
    batch = _train_batch(payload["batches"][args["batch"]], mesh)
    metrics, grads = [], []
    for _ in range(args.get("steps", 1)):
        metrics.append({k: float(v) for k, v in tr.step(batch).items()})
        with whole():
            if mesh.rank == 0:
                grads.append({n: p.grad.clone()
                              for n, p in _trainer_state(tr).items()
                              if getattr(p, "grad", None) is not None})
    with whole():
        out.update(metrics=metrics, grads=grads, state=_tensors(
            _trainer_state(tr)))
    if args.get("save"):
        # Written whole, then restored into this (sharded) state.
        out["checkpoint"] = tr.save()
        tr.maybe_restore(tr.config.model_dir)
        with whole():
            out["restored"] = _tensors(_trainer_state(tr))
    return out


def _train_main(args, rank):
    """train.main on this rank with the group already joined; returns
    what it trained and the files of its model directory."""
    from human_dynamics_tpu_torch.parallel.mesh import barrier
    from human_dynamics_tpu_torch.train import main as train_main

    tr = train_main.main(args["argv"])
    barrier(tr.mesh)
    return {"step": tr.state.step, "state": _trainer_state(tr),
            "files": sorted(os.listdir(tr.config.model_dir)),
            "lead": tr.is_lead}


def run_case(kind, args, payload, rank, world):
    from human_dynamics_tpu_torch import parallel
    from human_dynamics_tpu_torch.parallel import halo

    inputs = payload["inputs"]
    if kind == "strip":
        pred = _predictor(payload, args["model"])
        mesh = parallel.make_mesh(world, "time", device="cpu")
        return halo.movie_strip_sharded(pred.model, inputs[args["phi"]],
                                        mesh)
    if kind == "clip":
        pred = _predictor(payload, args["model"])
        mesh = parallel.make_mesh(world, "time", device="cpu")
        return halo.predict_clip_sharded(pred.model, pred.smpl,
                                         inputs[args["phi"]], mesh)
    if kind == "clips_2d":
        pred = _predictor(payload, args["model"])
        mesh = parallel.make_mesh_2d(*args["shape"], device="cpu")
        return halo.predict_clips_sharded_2d(pred.model, pred.smpl,
                                             inputs[args["phi"]], mesh)
    if kind == "windowed":
        pred = _predictor(payload, args["model"], **args.get("kw", {}))
        mesh = parallel.make_mesh(world, "data", device="cpu")
        x = inputs[args["x"]]
        if x.dim() == 2:
            return pred.predict_all_images_sharded(x, mesh)
        return pred.predict_all_images_sharded(x.numpy(), mesh)
    if kind == "shard_batch":
        mesh = (parallel.make_mesh_2d(*args["shape"], device="cpu")
                if "shape" in args else
                parallel.make_mesh(world, "data", device="cpu"))
        batch = {k: inputs[k] for k in args["keys"]}
        if args.get("two_d"):
            from human_dynamics_tpu_torch.train.trainer import Batch

            blocks = parallel.shard_batch_2d(Batch(**batch), mesh)._asdict()
            try:
                parallel.shard_batch_2d(
                    Batch(**dict(batch, phis=batch["phis"][:, :-1])), mesh)
                error = ""
            except ValueError as e:
                error = str(e)
            return {"blocks": blocks, "error": error}
        return {"blocks": parallel.shard_batch(batch, mesh)}
    if kind == "replicate":
        mesh = parallel.make_mesh(world, "data", device="cpu")
        mine = {"w": torch.full((3, 2), float(rank)), "step": torch.tensor(rank)}
        return parallel.replicate(mine, mesh)
    if kind == "serve":
        mesh = parallel.make_mesh(world, "data", device="cpu")
        return _serve(payload, args, mesh, rank)
    if kind == "train":
        return _train(payload, args, _train_mesh(args, world))
    if kind == "trainer_init":
        # Every rank initialises from its own seed; the Trainer holds rank
        # 0's state everywhere. A batch the world does not divide raises.
        from human_dynamics_tpu_torch.core import synthetic_smpl_model
        from human_dynamics_tpu_torch.train.trainer import Trainer
        from human_dynamics_tpu_torch.utils.config import Config

        mesh = parallel.make_mesh(world, "data", device="cpu")
        smpl = synthetic_smpl_model(num_verts=32, num_kps=args["num_kps"])
        tr = Trainer(Config(**dict(args["config"], seed=rank)), smpl,
                     device="cpu", mesh=mesh)
        try:
            Trainer(Config(**dict(args["config"], batch_size=world + 1)),
                    smpl, device="cpu", mesh=mesh)
            error = ""
        except ValueError as e:
            error = str(e)
        return {"state": _trainer_state(tr), "error": error}
    if kind == "train_main":
        return _train_main(args, rank)
    raise ValueError(f"unknown case kind {kind!r}")


def main(argv):
    url, world, rank, inp, out = argv
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    from human_dynamics_tpu_torch.parallel import initialize_multihost

    environ = {
        "HD_TPU_COORDINATOR": url,
        "HD_TPU_NUM_PROCESSES": str(world),
        "HD_TPU_PROCESS_ID": str(rank),
    }
    if world == 1:
        # One process is "not configured" for the env contract: join a
        # group of one directly.
        import torch.distributed as dist

        assert initialize_multihost(environ, device="cpu") == (0, 1)
        dist.init_process_group("gloo", init_method=url, world_size=1,
                                rank=0)
    got = initialize_multihost(environ, device="cpu")
    payload = torch.load(inp)
    results = {"initialize": list(got)}
    for name, kind, args in payload["cases"]:
        results[name] = _tensors(run_case(kind, args, payload, rank, world))
    torch.save(results, out)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
