"""Concurrent prediction service: pipelined serving on one GPU or a mesh.

Counterpart of ``human_dynamics_tpu/infer/service.py``. PyTorch queues
CUDA work asynchronously, so a single dispatcher thread that issues
requests back to back keeps the device busy, while callers block only on
their own results. The service packages that behind a thread-safe,
future-based API:

    service = PredictionService(predictor)
    fut = service.submit(frames)          # any thread, returns a Future
    preds = fut.result()                  # tensors on the device (see as_numpy)

Design notes:
- One dispatcher thread owns all device work, so requests run in
  submission order. It runs under ``torch.inference_mode``, which is
  per thread.
- Futures resolve with tensors on the predictor's device by default; the
  caller decides what (if anything) to fetch. Every request runs on the
  device's default stream, which the caller's thread also uses, so the
  caller's reads of a resolved result are ordered after the work that
  produced it. ``as_numpy=True`` fetches on the dispatcher thread.
- An error in a request resolves only that request's future; the service
  keeps running. ``close()`` drains the queue and joins the thread.
- With a ``parallel.Mesh`` (one process per GPU), offline clips run
  sharded over every rank. Rank 0 owns the service; every other rank runs
  ``PredictionService.follow(predictor, mesh)``. For each clip the
  dispatcher encodes image input on rank 0, broadcasts a header (the
  path, N, C) and the (N, C) features, and every rank makes the same
  sharded call; ``close()`` broadcasts a stop. The dispatcher thread is
  the only thread of rank 0 that issues collectives. A follower waits for
  the next header at most the process group's timeout.
"""

from __future__ import annotations

import queue
import threading
import traceback
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch

from human_dynamics_tpu_torch.infer.streaming import StreamingPredictor
from human_dynamics_tpu_torch.parallel.halo import predict_clip_sharded
from human_dynamics_tpu_torch.parallel.mesh import broadcast

# The header's first entry: what every rank runs next.
_STOP, _WINDOWED, _HALO = 0, 1, 2
_OPS = {"windowed": _WINDOWED, "halo": _HALO}


class PredictionService:
    """Thread-safe, pipelined serving wrapper around ``HmmrPredictor``.

    Args:
        predictor: a constructed ``HmmrPredictor`` (weights already on its
            device).
        as_numpy: resolve futures with host numpy arrays instead of
            tensors on the device (adds a device->host fetch per request).
        max_queue: backpressure bound: ``submit`` blocks once this many
            requests are waiting (0 = unbounded).
        mesh: optional ``parallel.Mesh``, on rank 0 (the other ranks run
            ``follow``). Offline ``submit`` clips then run sharded over its
            first axis; live streams (``open_stream``) stay on rank 0's
            device: an emission is too small to pay for collectives, and
            its state stays where the next one runs.
        mesh_mode: which sharded clip path ``submit`` uses:
            ``"windowed"``: ``predict_all_images_sharded``, window groups
            split over the ranks, results equal to ``predict_all_images``;
            ``"halo"``: ``parallel.halo.predict_clip_sharded``, the clip's
            frames split over the ranks, the exact full-clip forward
            (fp32, no window stitching) under that function's keys.
    """

    def __init__(
        self,
        predictor,
        as_numpy: bool = False,
        max_queue: int = 0,
        mesh=None,
        mesh_mode: str = "windowed",
    ):
        if mesh_mode not in ("windowed", "halo"):
            raise ValueError(
                f"mesh_mode must be 'windowed' or 'halo', got {mesh_mode!r}"
            )
        if mesh is not None and mesh.rank != 0:
            raise ValueError(
                f"PredictionService(mesh=...) runs on rank 0; rank "
                f"{mesh.rank} serves with PredictionService.follow"
            )
        self.predictor = predictor
        self.as_numpy = as_numpy
        self.mesh = mesh
        self.mesh_mode = mesh_mode
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        # Lifecycle lock: makes the closed-check + enqueue in submit()
        # atomic against close()'s closed-set + sentinel enqueue, so no
        # request can land behind the sentinel and hang its Future.
        # Separate from _lock: the dispatcher takes _lock for stats, and
        # a bounded-queue put may block in submit while holding this.
        self._close_lock = threading.Lock()
        self._stats = {
            "submitted": 0, "completed": 0, "failed": 0, "frames": 0,
        }
        self._closed = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="hd-torch-serve", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(
        self, frames, phi: Optional[np.ndarray] = None
    ) -> "Future[Dict[str, Any]]":
        """Enqueue one clip; returns a Future of the prediction dict.

        ``frames``/``phi`` follow ``HmmrPredictor.predict_all_images``.
        Raises RuntimeError after ``close()``.
        """
        n = int(len(frames) if frames is not None else len(phi))
        if self.mesh is not None:
            thunk = lambda: self._predict_sharded(frames, phi)
        else:
            thunk = lambda: self.predictor.predict_all_images(
                frames, phi=phi, as_numpy=self.as_numpy
            )
        return self._submit_thunk(thunk, num_frames=n)

    def _predict_sharded(self, frames, phi) -> Dict[str, Any]:
        """One clip over the mesh, on the dispatcher thread: rank 0 encodes
        image input, checks the features, and hands the header and the
        features to the followers before the sharded call."""
        p = self.predictor
        if phi is None:
            phi = frames if getattr(frames, "ndim", 0) == 2 else (
                p.encode_frames(frames))
        phi = torch.as_tensor(phi, dtype=torch.float32,
                              device=self.mesh.device).contiguous()
        c = p.model.feature_dim
        if phi.dim() != 2 or phi.shape[0] < 1 or phi.shape[1] != c:
            raise ValueError(
                f"features of shape {tuple(phi.shape)}; the model takes "
                f"(N >= 1, {c})"
            )
        op = _OPS[self.mesh_mode]
        broadcast(torch.tensor([op, *phi.shape], device=self.mesh.device),
                  self.mesh)
        broadcast(phi, self.mesh)
        return _sharded_call(p, self.mesh, op, phi, self.as_numpy)

    @staticmethod
    def follow(predictor, mesh) -> Dict[str, int]:
        """Serve rank 0's sharded calls on this rank until its service
        closes.

        Every rank but 0 runs this, with a predictor built as rank 0's.
        Returns {"served": calls made, "failed": calls that raised} (a
        failed call is rank 0's failed request too).
        """
        if mesh.rank == 0:
            raise ValueError("rank 0 owns the PredictionService")
        stats = {"served": 0, "failed": 0}
        with torch.inference_mode():
            while True:
                header = broadcast(
                    torch.zeros(3, dtype=torch.int64, device=mesh.device),
                    mesh)
                op, n, c = header.tolist()
                if op == _STOP:
                    return stats
                phi = broadcast(torch.empty((n, c), device=mesh.device),
                                mesh)
                stats["served"] += 1
                try:
                    _sharded_call(predictor, mesh, op, phi, as_numpy=False)
                except Exception:  # rank 0's future fails too; keep serving
                    traceback.print_exc()
                    stats["failed"] += 1

    def _submit_thunk(self, thunk, num_frames: int = 0) -> "Future":
        """Enqueue arbitrary work on the dispatcher thread (the single
        owner of all device work); used by submit() and StreamingSession."""
        fut: "Future" = Future()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("PredictionService is closed")
            # Count before enqueueing so a fast dispatcher can never
            # make a concurrent stats() read completed > submitted.
            with self._lock:
                self._stats["submitted"] += 1
            self._queue.put((fut, thunk, num_frames))
        return fut

    def open_stream(
        self, predictor=None, as_numpy: Optional[bool] = None
    ) -> "StreamingSession":
        """Open an online (live-video) stream served through this
        service's dispatcher thread.

        The session wraps ``StreamingPredictor`` (infer/streaming.py):
        emissions are offline-identical, with ``quantum`` frames per
        emission and ``latency_frames`` of input lookahead. Several
        streams and offline ``submit`` clips interleave safely: the
        dispatcher serialises all device work, and each session's
        emissions resolve in feed order.

        Args:
            predictor: optionally a differently configured
                ``HmmrPredictor`` (e.g. batch_size=1 for the lowest
                latency); defaults to the service's offline predictor.
            as_numpy: fetch emissions to the host (default: the service's
                setting).
        """
        sp = StreamingPredictor(
            predictor if predictor is not None else self.predictor,
            as_numpy=self.as_numpy if as_numpy is None else as_numpy,
        )
        return StreamingSession(self, sp)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def close(self, drain: bool = True) -> None:
        """Stop accepting work; by default finish what's queued."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            if not drain:
                # Fail queued-but-unstarted requests.
                try:
                    while True:
                        fut, _, _ = self._queue.get_nowait()
                        fut.set_exception(
                            RuntimeError("PredictionService closed")
                        )
                except queue.Empty:
                    pass
            self._queue.put(None)  # sentinel
        self._thread.join()

    def __enter__(self) -> "PredictionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        # inference_mode is per thread: without it here, work built on this
        # thread outside the predictor's own decorated methods would record
        # autograd state. So is the current CUDA device.
        if self.mesh is not None and self.mesh.device.type == "cuda":
            torch.cuda.set_device(self.mesh.device)
        with torch.inference_mode():
            while True:
                item = self._queue.get()
                if item is None:
                    if self.mesh is not None:
                        broadcast(torch.zeros(3, dtype=torch.int64,
                                              device=self.mesh.device),
                                  self.mesh)
                    return
                fut, thunk, num_frames = item
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    out = thunk()
                except Exception as e:  # resolve only this request
                    fut.set_exception(e)
                    with self._lock:
                        self._stats["failed"] += 1
                    continue
                fut.set_result(out)
                with self._lock:
                    self._stats["completed"] += 1
                    self._stats["frames"] += num_frames


def _sharded_call(predictor, mesh, op, phi, as_numpy: bool):
    """The sharded call that the header's ``op`` names, on every rank."""
    if op == _WINDOWED:
        return predictor.predict_all_images_sharded(
            None, mesh, phi=phi, as_numpy=as_numpy)
    out = predict_clip_sharded(predictor.model, predictor.smpl, phi, mesh,
                               axis_name=mesh.axis_names[0])
    if as_numpy:
        out = {k: v.cpu().numpy() for k, v in out.items()}
    return out


class StreamingSession:
    """A live stream multiplexed onto a ``PredictionService``.

    All methods return Futures resolved by the service's dispatcher
    thread in feed order:

        session = service.open_stream()
        for frames in camera:
            for out in session.feed(frames).result():
                consume(out)           # list of emission dicts
        for out in session.flush().result():
            consume(out)

    ``feed``/``flush``/``reset`` order is preserved per session (one
    FIFO queue); feeding after ``flush`` requires ``reset`` first
    (StreamingPredictor's contract).
    """

    def __init__(self, service: PredictionService, sp: StreamingPredictor):
        self._service = service
        self._sp = sp

    @property
    def quantum(self) -> int:
        """Frames per emission (batch_size * g)."""
        return self._sp.quantum

    @property
    def latency_frames(self) -> int:
        """Input lookahead before a frame's output can emit."""
        return self._sp.latency_frames

    def feed(self, frames) -> "Future":
        """Future of the (possibly empty) list of emission dicts the
        frames complete. ``frames``: numpy arrays or tensors."""
        return self._service._submit_thunk(
            lambda: self._sp.feed(frames), num_frames=len(frames)
        )

    def flush(self) -> "Future":
        """Future of the final emissions (zero-phi back fill)."""
        return self._service._submit_thunk(self._sp.flush)

    def reset(self) -> "Future":
        """Start a new clip (runs on the dispatcher, after queued work)."""
        return self._service._submit_thunk(self._sp.reset)
