"""Training input pipeline, phi mode: tfrecord shards -> balanced batches.

Counterpart of the precomputed-phi path of
``human_dynamics_tpu/data/loader.py``, reading records with the port's
pure-Python ``data.tfrecord`` codec, and yielding the same batches as the
JAX pipeline for the same records and seed:

- 2D/3D split balancing: each batch is half in-the-wild 2-D data, half 3-D
  (h36m) data, shuffled.
- A random contiguous T-window per tube; short tubes are zero-padded to T.
- A mocap real-pose pool sized exactly to the discriminator's fake pool.
- A background thread assembles numpy batches ahead of the consumer.

One process reads every shard. Image-mode records (decoded frames for
training the ResNet) are not ported.
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

_IMAGE_MODE = (
    "image-mode training data (decoded frames) is not ported: the port "
    "trains on precomputed phi (the image-mode training slice is ROADMAP "
    "Queue 1 item 4b)"
)


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


def shuffle_buffered(iterator: Iterator, rng: np.random.RandomState,
                     capacity: int = 300) -> Iterator:
    """Items in random order from a rolling buffer of ``capacity`` items,
    decorrelating consecutive tubes of one shard."""
    if capacity <= 1:
        yield from iterator
        return
    buf: List = []
    for item in iterator:
        while len(buf) >= capacity:
            idx = rng.randint(len(buf))
            out = buf[idx]
            buf[idx] = buf[-1]
            buf.pop()
            yield out
        buf.append(item)
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
    """Infinite shuffled stream of per-tube training examples (phi
    records)."""

    def __init__(self, files: List[str], t: int, num_kps: int = 25,
                 seed: int = 0, decode_images: bool = False,
                 shuffle_buffer: int = 300):
        if decode_images:
            raise NotImplementedError(_IMAGE_MODE)
        if not files:
            raise FileNotFoundError("No tfrecord shards found")
        self.files = files
        self.t = t
        self.num_kps = num_kps
        self.shuffle_buffer = shuffle_buffer
        self.rng = np.random.RandomState(seed)

    def _raw_stream(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            for fi in self.rng.permutation(len(self.files)):
                for serialized in read_tfrecord(self.files[fi]):
                    ex = parse_temporal_example(serialized)
                    if ex.phis is None:
                        raise ValueError(
                            f"{self.files[fi]}: a record without phis; "
                            f"{_IMAGE_MODE}")
                    window = pick_window(ex.n, self.t, self.rng)
                    yield self._make_example(ex, window)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return shuffle_buffered(self._raw_stream(), self.rng,
                                self.shuffle_buffer)

    def _make_example(self, ex, window) -> Dict[str, np.ndarray]:
        t = self.t
        return {
            "kps": _pad_to_t(ex.kps[window], t)[:, :self.num_kps].astype(
                np.float32),
            "poses": _pad_to_t(ex.poses[window], t).astype(np.float32),
            "shape": ex.shape.astype(np.float32),
            "gt3ds": _pad_to_t(ex.gt3ds[window], t).astype(np.float32),
            "has_3d_joints": np.float32(ex.has_3d_joints),
            "has_3d_smpl": np.float32(ex.has_3d),
            "phis": _pad_to_t(ex.phis[window], t).astype(np.float32),
        }


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


class TrainDataPipeline:
    """Split-balanced batches and the mocap pool, assembled by a prefetch
    thread. Iterating yields ``train.trainer.Batch``es of numpy arrays;
    ``close`` stops the thread."""

    def __init__(self, config, prefetch: int = 2):
        from human_dynamics_tpu_torch.train.trainer import fake_pool_size

        if not config.precomputed_phi:
            raise NotImplementedError(_IMAGE_MODE)
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

        self.stream_2d = iter(ExampleStream(
            files_2d, config.T, config.num_kps, config.seed))
        self.stream_3d = iter(ExampleStream(
            files_3d, config.T, config.num_kps, config.seed + 1))
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
