"""Training input pipeline: tfrecord shards -> balanced batches.

Counterpart of ``human_dynamics_tpu/data/loader.py``, reading records with
the port's pure-Python ``data.tfrecord`` codec. In phi mode it yields the
same batches as the JAX pipeline for the same records and seed:

- 2D/3D split balancing: each batch is half in-the-wild 2-D data, half 3-D
  (h36m) data, shuffled.
- A random contiguous T-window per tube; short tubes are zero-padded to T.
- A mocap real-pose pool sized exactly to the discriminator's fake pool;
  ``MocapTemporalStream`` yields the temporal mocap records' (pose,
  delta-pose) windows.
- A background thread assembles numpy batches ahead of the consumer.

Image mode (``precomputed_phi=False``) reads the frames of the sampled
window: JPEG records (cv2, imported only to decode them) or pre-decoded
``raw_u8`` records. They ride the shuffle buffer still encoded, with the
buffer's bytes bounded, and are decoded as they leave it; the batch's tubes
then go to the device as uint8 and through ``data.augment`` in one batched
call, with the augmentation drawn from a generator on the device seeded from
``config.seed``. An image batch holds tensors on the pipeline's device (the
CUDA device unless the CPU is asked for).

With ``host_id`` and ``num_hosts`` (one pipeline per process of a
data-parallel run) each process reads every ``num_hosts``-th shard from its
``host_id`` on, with its streams' generators seeded ``seed + host_id``, as
the JAX pipeline shards them; the mocap pool, the batch shuffle and the
augmentation draws are seeded alike on every process, as in the JAX
pipeline.
"""

from __future__ import annotations

import glob
import os
import queue as queue_mod
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from human_dynamics_tpu_torch.data.schema import parse_temporal_example
from human_dynamics_tpu_torch.data.tfrecord import decode_example, read_tfrecord

THREED_DATASETS = ("h36m",)


def get_all_files(dataset_dir: str, datasets: Sequence[str],
                  split: str = "train") -> List[str]:
    """{data_dir}/{dataset}/{split}/*.tfrecord, with h36m also read from
    human36m."""
    datasets = list(datasets)
    if "h36m" in datasets:
        datasets.append("human36m")
    files: List[str] = []
    for dataset in datasets:
        files += sorted(glob.glob(os.path.join(dataset_dir, dataset, split,
                                               "*.tfrecord")))
    return files


def _item_nbytes(item: Dict) -> int:
    """The host memory one buffered example holds, about: its arrays and
    its encoded frames."""
    return sum(v.nbytes if isinstance(v, np.ndarray)
               else sum(map(len, v)) if isinstance(v, list) else 64
               for v in item.values())


def shuffle_buffered(iterator: Iterator, rng: np.random.RandomState,
                     capacity: int = 300,
                     max_bytes: Optional[int] = None) -> Iterator:
    """Items in random order from a rolling buffer of ``capacity`` items,
    decorrelating consecutive tubes of one shard. With ``max_bytes``,
    random items leave first whenever a new one would take the buffer
    over that many bytes."""
    if capacity <= 1:
        yield from iterator
        return
    buf: List = []
    sizes: List[int] = []
    total = 0
    for item in iterator:
        sz = _item_nbytes(item) if max_bytes is not None else 0
        while buf and (len(buf) >= capacity
                       or (max_bytes is not None and total + sz > max_bytes)):
            idx = rng.randint(len(buf))
            out = buf[idx]
            buf[idx] = buf[-1]
            sizes[idx] = sizes[-1]
            buf.pop()
            total -= sizes.pop()
            yield out
        buf.append(item)
        sizes.append(sz)
        total += sz
    for idx in rng.permutation(len(buf)):
        yield buf[idx]


def pick_window(n: int, t: int, rng: np.random.RandomState) -> slice:
    """A random contiguous window of t frames (all n when n <= t)."""
    if n <= t:
        return slice(0, n)
    start = rng.randint(0, n - t + 1)
    return slice(start, start + t)


def _pad_to_t(arr: np.ndarray, t: int) -> np.ndarray:
    """Zero-pad a short sequence to t frames (or cut a long one)."""
    if len(arr) >= t:
        return arr[:t]
    pad = np.zeros((t - len(arr),) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


class ExampleStream:
    """Infinite shuffled stream of per-tube training examples: phi records
    or, with ``decode_images``, the window's frames (uint8) with their
    keypoints in source pixels and person centres."""

    def __init__(self, files: List[str], t: int, num_kps: int = 25,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 decode_images: bool = False, shuffle_buffer: int = 300,
                 shuffle_bytes: Optional[int] = None):
        if not files:
            raise FileNotFoundError("No tfrecord shards found")
        self.files = files[host_id::num_hosts]
        if not self.files:
            raise FileNotFoundError(
                f"No tfrecord shard for host {host_id} of {num_hosts} among "
                f"{len(files)}")
        self.t = t
        self.num_kps = num_kps
        self.decode_images = decode_images
        self.shuffle_buffer = shuffle_buffer
        self.shuffle_bytes = shuffle_bytes
        self.rng = np.random.RandomState(seed + host_id)

    def _raw_stream(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            for fi in self.rng.permutation(len(self.files)):
                for serialized in read_tfrecord(self.files[fi]):
                    ex = parse_temporal_example(serialized)
                    missing = (ex.image_datas is None if self.decode_images
                               else ex.phis is None)
                    if missing:
                        raise ValueError(
                            f"{self.files[fi]}: a record without "
                            + ("frames" if self.decode_images else "phis"))
                    window = pick_window(ex.n, self.t, self.rng)
                    yield self._make_example(ex, window)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        shuffled = shuffle_buffered(self._raw_stream(), self.rng,
                                    self.shuffle_buffer,
                                    max_bytes=self.shuffle_bytes)
        return (self._finalize(d) for d in shuffled)

    def _make_example(self, ex, window) -> Dict[str, np.ndarray]:
        t = self.t
        out = {
            "kps": _pad_to_t(ex.kps[window], t)[:, :self.num_kps].astype(
                np.float32),
            "poses": _pad_to_t(ex.poses[window], t).astype(np.float32),
            "shape": ex.shape.astype(np.float32),
            "gt3ds": _pad_to_t(ex.gt3ds[window], t).astype(np.float32),
            "has_3d_joints": np.float32(ex.has_3d_joints),
            "has_3d_smpl": np.float32(ex.has_3d),
        }
        if ex.phis is not None:
            out["phis"] = _pad_to_t(ex.phis[window], t).astype(np.float32)
        if self.decode_images:
            # The frames stay encoded through the shuffle buffer and are
            # decoded in _finalize; keypoints stay in source pixels, (3, K),
            # for the augmentation.
            out["_frames"] = [bytes(d) for d in ex.image_datas[window]]
            if ex.image_format == b"raw_u8":
                out["_raw_hw"] = ex.image_shapes[window]
            out["labels_raw"] = _pad_to_t(
                np.transpose(ex.kps[window], (0, 2, 1)), t
            )[:, :, :self.num_kps].astype(np.float32)
            out["centers"] = _pad_to_t(
                ex.centers[window].astype(np.float32), t)
        return out

    def _finalize(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Decode the frames (if any) into uint8 "images" (T, H, W, 3)."""
        frames = out.pop("_frames", None)
        raw_hw = out.pop("_raw_hw", None)
        if frames is None:
            return out
        if raw_hw is not None:
            imgs = np.stack([
                np.frombuffer(d, np.uint8).reshape(int(h), int(w), 3)
                for d, (h, w) in zip(frames, raw_hw)
            ])
        else:
            import cv2

            imgs = np.stack([
                cv2.cvtColor(cv2.imdecode(np.frombuffer(d, np.uint8),
                                          cv2.IMREAD_COLOR),
                             cv2.COLOR_BGR2RGB)
                for d in frames
            ])
        out["images"] = _pad_to_t(imgs, self.t)
        return out


class MocapStream:
    """Real (pose, shape) pairs for the adversarial prior; every record is
    decoded once and held in memory."""

    def __init__(self, files: List[str], seed: int = 0):
        if not files:
            raise FileNotFoundError("No mocap tfrecord shards found")
        self.files = files
        self.rng = np.random.RandomState(seed)
        self._cache: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @staticmethod
    def mocap_files(dataset_dir: str, mocap_datasets: Sequence[str]):
        """{data_dir}/mocap_neutrMosh/neutrSMPL_{ds}_*.tfrecord."""
        files: List[str] = []
        for ds in mocap_datasets:
            files += sorted(glob.glob(os.path.join(
                dataset_dir, "mocap_neutrMosh", f"neutrSMPL_{ds}_*.tfrecord",
            )))
        return files

    def _load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None:
            return self._cache
        poses, shapes = [], []
        for path in self.files:
            for serialized in read_tfrecord(path):
                feats = decode_example(serialized)
                poses.append(np.asarray(feats["pose"], np.float32).reshape(72))
                shapes.append(
                    np.asarray(feats["shape"], np.float32).reshape(10))
        self._cache = (np.stack(poses), np.stack(shapes))
        return self._cache

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        poses, shapes = self._load_all()
        while True:
            for i in self.rng.permutation(len(poses)):
                yield poses[i], shapes[i]


class MocapTemporalStream:
    """Real delta-pose windows for temporal priors, over the records that
    ``datasets.mocap.write_mocap_temporal_records`` writes; the files are
    read in a fresh permutation on every pass."""

    def __init__(self, files: List[str], seed: int = 0):
        if not files:
            raise FileNotFoundError("No temporal mocap shards found")
        self.files = files
        self.rng = np.random.RandomState(seed)

    @staticmethod
    def mocap_files(dataset_dir: str, mocap_datasets: Sequence[str]):
        """{data_dir}/mocap_neutrMosh_temporal_pose/
        neutrSMPL_{ds}_*.tfrecord."""
        files: List[str] = []
        for ds in mocap_datasets:
            files += sorted(glob.glob(os.path.join(
                dataset_dir, "mocap_neutrMosh_temporal_pose",
                f"neutrSMPL_{ds}_*.tfrecord",
            )))
        return files

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (poses (T, 72), delta_poses (T-1, 72))."""
        while True:
            for fi in self.rng.permutation(len(self.files)):
                for serialized in read_tfrecord(self.files[fi]):
                    feats = decode_example(serialized)
                    t = int(np.asarray(feats["T"])[0])
                    pose = np.asarray(feats["pose"], np.float32).reshape(t, 72)
                    deltas = np.asarray(
                        feats["delta_pose"], np.float32).reshape(t - 1, 72)
                    yield pose, deltas


class TrainDataPipeline:
    """Split-balanced batches and the mocap pool, assembled by a prefetch
    thread. Iterating yields ``train.trainer.Batch``es: numpy arrays in phi
    mode; in image mode tensors on ``device`` (None: the CUDA device,
    raising without one), the frames augmented there. ``host_id`` and
    ``num_hosts`` pick this process's shards. ``close`` stops the
    thread."""

    def __init__(self, config, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, device=None):
        from human_dynamics_tpu_torch.train.trainer import fake_pool_size

        self.config = config
        self.pool_size = fake_pool_size(config)

        if config.split_balanced:
            datasets_2d = [d for d in config.datasets
                           if d not in THREED_DATASETS]
            datasets_3d = [d for d in config.datasets if d in THREED_DATASETS]
        else:
            datasets_2d = list(config.datasets)
            datasets_3d = datasets_2d[::-1]
        files_2d = get_all_files(config.data_dir, datasets_2d)
        files_3d = get_all_files(config.data_dir, datasets_3d)

        def split_list(lst):
            mid = len(lst) // 2
            return lst[:mid], lst[mid:]

        if not files_2d:
            files_2d, files_3d = split_list(files_3d)
        elif not files_3d:
            files_2d, files_3d = split_list(files_2d)

        decode_images = not config.precomputed_phi
        # Image tubes ride the buffer encoded; the byte cap bounds the
        # host memory of each stream.
        shuffle_bytes = (1 << 30) if decode_images else None
        self.stream_2d = iter(ExampleStream(
            files_2d, config.T, config.num_kps, config.seed, host_id,
            num_hosts, decode_images=decode_images,
            shuffle_bytes=shuffle_bytes))
        self.stream_3d = iter(ExampleStream(
            files_3d, config.T, config.num_kps, config.seed + 1, host_id,
            num_hosts, decode_images=decode_images,
            shuffle_bytes=shuffle_bytes))
        self.device = None
        if decode_images:
            import torch

            from human_dynamics_tpu_torch.infer.predictor import (
                resolve_device,
            )

            self.device = resolve_device(device)
            self.augment_generator = torch.Generator(
                device=self.device).manual_seed(config.seed * 100003)
        self.mocap = iter(MocapStream(
            MocapStream.mocap_files(config.data_dir, config.mocap_datasets),
            seed=config.seed,
        ))
        self.rng = np.random.RandomState(config.seed + 2)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    def _assemble_batch(self):
        from human_dynamics_tpu_torch.train.trainer import Batch

        b, t = self.config.batch_size, self.config.T
        n2 = b // 2
        examples = [next(self.stream_2d) for _ in range(n2)]
        examples += [next(self.stream_3d) for _ in range(b - n2)]
        self.rng.shuffle(examples)

        def stack(key):
            return np.stack([e[key] for e in examples])

        poses_real = np.stack(
            [next(self.mocap)[0] for _ in range(self.pool_size)])
        if not self.config.precomputed_phi:
            return self._assemble_image_batch(examples, poses_real)
        return Batch(
            phis=stack("phis"),
            kps=stack("kps"),
            poses_gt=stack("poses").reshape(b, t, 24, 3),
            shapes_gt=stack("shape"),
            joints_gt=stack("gt3ds"),
            has_3d_joints=stack("has_3d_joints"),
            has_3d_smpl=stack("has_3d_smpl"),
            poses_real=poses_real.reshape(self.pool_size, 24, 3),
        )

    def _assemble_image_batch(self, examples, poses_real):
        """The batch's frames to the device as uint8 and through one
        batched augmentation call."""
        import torch

        from human_dynamics_tpu_torch.data.augment import (
            augment_batch,
            sample_tube_params,
        )
        from human_dynamics_tpu_torch.train.trainer import Batch

        c = self.config
        b, t = c.batch_size, c.T

        def dev(key, fn=lambda x: x):
            return torch.from_numpy(
                np.stack([fn(e[key]) for e in examples])).to(self.device)

        params = sample_tube_params(
            self.augment_generator, b, t, trans_max=c.trans_max,
            delta_trans_max=c.delta_trans_max, scale_max=c.scale_max,
            delta_scale_max=c.delta_scale_max, rotate_max=c.rotate_max,
            delta_rotate_max=c.delta_rotate_max,
        )
        crops, kps, poses, gt3ds = augment_batch(
            dev("images"), dev("labels_raw"), dev("centers"),
            dev("poses", lambda p: p.reshape(t, 72)), dev("gt3ds"), params,
            output_size=c.img_size, apply_rotation=c.rotate_max != 0,
        )
        return Batch(
            phis=crops,
            kps=kps,
            poses_gt=poses.reshape(b, t, 24, 3),
            shapes_gt=dev("shape"),
            joints_gt=gt3ds,
            has_3d_joints=dev("has_3d_joints"),
            has_3d_smpl=dev("has_3d_smpl"),
            poses_real=torch.from_numpy(
                poses_real.reshape(self.pool_size, 24, 3)).to(self.device),
        )

    def _worker(self):
        # An exception goes to the consumer, which would otherwise wait
        # forever on the queue.
        try:
            while not self._stopping:
                self._queue.put(self._assemble_batch())
        except Exception as exc:  # forwarded to the consumer
            if not self._stopping:
                self._queue.put(_WorkerError(exc))

    def __iter__(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        while True:
            item = self._queue.get()
            if isinstance(item, _WorkerError):
                raise RuntimeError(
                    "training data prefetch worker failed") from item.exc
            yield item

    def close(self):
        """Stop the prefetch thread; idempotent."""
        self._stopping = True
        if self._thread is None:
            return
        # Unblock a worker waiting on a full queue, then let it see
        # _stopping.
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue_mod.Empty:
                pass
            self._thread.join(timeout=0.2)
        self._thread = None


class _WorkerError:
    """Carries an exception across the prefetch queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc
