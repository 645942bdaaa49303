"""TensorFlow tensor-bundle checkpoints (``P.index`` + ``P.data-*``) read
without TensorFlow or protobuf.

``load_checkpoint(path)`` is the subset of ``tf.train.load_checkpoint`` that
``utils.checkpoint.convert_tf_checkpoint`` uses: ``get_variable_to_shape_map``
and ``get_tensor``. ``path`` is a checkpoint prefix ``P`` or a directory
whose ``checkpoint`` state file names one.

Format facts used (TensorFlow's ``tensor_bundle`` and its LevelDB-style
table):

- ``P.index`` is a table: data blocks, a metaindex block, an index block
  whose entries point at the data blocks, and a 48-byte footer (two
  ``BlockHandle`` varint pairs padded to 40 bytes, then the little-endian
  magic 0xdb4775248b80fb57). Every block is followed by a 5-byte trailer:
  a compression byte (0: none) and the masked CRC-32C of the block and
  that byte. A block holds prefix-compressed entries (shared, non-shared
  and value-length varints, the key's new bytes, the value), then a
  uint32 restart array and its count.
- Key ``""`` holds a ``BundleHeaderProto`` {1: num_shards, 2: endianness
  (0 little), 3: version}. Every other key is a variable name whose value
  is a ``BundleEntryProto`` {1: dtype, 2: shape (``TensorShapeProto``,
  ``dim`` = field 2 {1: size}), 3: shard_id, 4: offset, 5: size,
  6: crc32c (fixed32, masked), 7: slices}.
- A value is ``size`` raw little-endian bytes at ``offset`` of
  ``P.data-{shard_id:05d}-of-{num_shards:05d}``.
- A partitioned variable's entry lists its slices (field 7); each slice
  is stored under a binary key that starts with a 0 byte.

What the reader cannot return whole it refuses with ``BundleError``: a
compressed block, a bad magic or block CRC, big-endian data or a missing
shard when the checkpoint is opened; a sliced (partitioned) variable, a
string or other unsupported dtype, or a value whose CRC does not match
when that variable is read.
"""

from __future__ import annotations

import codecs
import os
import re
import struct
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np

from human_dynamics_tpu_torch.data.tfrecord import masked_crc32c

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48
_TRAILER_LEN = 5

# tensorflow/core/framework/types.proto DataType -> little-endian numpy.
_DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("u1"),     # DT_UINT8
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("?"),     # DT_BOOL
    19: np.dtype("<f2"),   # DT_HALF
}
_DT_STRING = 7


class BundleError(ValueError):
    """A tensor bundle this reader refuses: corrupt or unsupported."""


class _Entry(NamedTuple):
    dtype: int
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc32c: int
    sliced: bool


# ---------------------------------------------------------------------------
# Protobuf wire format
# ---------------------------------------------------------------------------


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of each field of a message: an int for
    varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            (value,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            (value,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        else:
            raise BundleError(f"unsupported protobuf wire type {wire}")
        yield field, value


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, value in _fields(buf):
        if field == 2:
            size = 0
            for f, v in _fields(value):
                if f == 1:
                    size = v
            dims.append(size)
    return tuple(dims)


def _parse_entry(buf: bytes) -> _Entry:
    kw = dict(dtype=0, shape=(), shard_id=0, offset=0, size=0, crc32c=0,
              sliced=False)
    for field, value in _fields(buf):
        if field == 1:
            kw["dtype"] = value
        elif field == 2:
            kw["shape"] = _parse_shape(value)
        elif field == 3:
            kw["shard_id"] = value
        elif field == 4:
            kw["offset"] = value
        elif field == 5:
            kw["size"] = value
        elif field == 6:
            kw["crc32c"] = value
        elif field == 7:
            kw["sliced"] = True
    return _Entry(**kw)


# ---------------------------------------------------------------------------
# The index table
# ---------------------------------------------------------------------------


def _read_block(data: bytes, handle: Tuple[int, int], path: str) -> bytes:
    offset, size = handle
    end = offset + size
    if end + _TRAILER_LEN > len(data):
        raise BundleError(f"{path}: block at {offset} runs past the file")
    block, kind = data[offset:end], data[end]
    if kind != 0:
        raise BundleError(
            f"{path}: block at {offset} is compressed (type {kind}); only "
            "uncompressed tables are read")
    (crc,) = struct.unpack_from("<I", data, end + 1)
    if masked_crc32c(data[offset:end + 1]) != crc:
        raise BundleError(f"{path}: CRC mismatch in the block at {offset}")
    return block


def _block_entries(block: bytes, path: str) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise BundleError(f"{path}: truncated block")
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 * (n_restarts + 1)
    if limit < 0:
        raise BundleError(f"{path}: bad restart count {n_restarts}")
    key, pos = b"", 0
    while pos < limit:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + n_value]
        pos += n_value


def _read_table(path: str) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of a table file, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_LEN:
        raise BundleError(f"{path}: too short for a table footer")
    footer = data[-_FOOTER_LEN:]
    (magic,) = struct.unpack_from("<Q", footer, _FOOTER_LEN - 8)
    if magic != _TABLE_MAGIC:
        raise BundleError(f"{path}: bad table magic {magic:#018x}")
    _, pos = _varint(footer, 0)          # metaindex offset
    _, pos = _varint(footer, pos)        # metaindex size
    index_offset, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)
    index = _read_block(data, (index_offset, index_size), path)
    entries = []
    for _, handle in _block_entries(index, path):
        offset, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        entries.extend(_block_entries(
            _read_block(data, (offset, size), path), path))
    return entries


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class BundleReader:
    """The variables of one tensor bundle, read on demand."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = prefix + ".index"
        if not os.path.exists(index):
            raise FileNotFoundError(f"no tensor bundle at {prefix!r}: "
                                    f"{index} does not exist")
        num_shards = 1
        self._entries: Dict[str, _Entry] = {}
        for key, value in _read_table(index):
            if key.startswith(b"\x00"):
                continue    # a slice of a partitioned variable
            if key == b"":
                for field, v in _fields(value):
                    if field == 1:
                        num_shards = v
                    elif field == 2 and v != 0:
                        raise BundleError(
                            f"{index}: big-endian bundle; only "
                            "little-endian data is read")
            else:
                self._entries[key.decode("utf-8")] = _parse_entry(value)
        self._shards = [f"{prefix}.data-{i:05d}-of-{num_shards:05d}"
                        for i in range(num_shards)]
        for shard in self._shards:
            if not os.path.exists(shard):
                raise BundleError(f"{prefix}: missing data shard {shard}")

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: list(e.shape) for k, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        """The variable ``name`` as a numpy array, its CRC checked."""
        if name not in self._entries:
            raise KeyError(f"{name!r} not found in checkpoint {self.prefix}")
        e = self._entries[name]
        if e.sliced:
            raise BundleError(f"{name!r} is a sliced (partitioned) variable; "
                              "only whole variables are read")
        if e.dtype not in _DTYPES:
            kind = "string" if e.dtype == _DT_STRING else f"enum {e.dtype}"
            raise BundleError(f"{name!r} has unsupported dtype {kind}")
        dtype = _DTYPES[e.dtype]
        if e.shard_id >= len(self._shards):
            raise BundleError(f"{name!r}: shard {e.shard_id} out of range")
        n = int(np.prod(e.shape, dtype=np.int64))
        if e.size != n * dtype.itemsize:
            raise BundleError(f"{name!r}: {e.size} bytes for shape {e.shape}")
        with open(self._shards[e.shard_id], "rb") as f:
            f.seek(e.offset)
            raw = f.read(e.size)
        if len(raw) != e.size:
            raise BundleError(f"{name!r}: data shard truncated")
        if masked_crc32c(raw) != e.crc32c:
            raise BundleError(f"{name!r}: CRC mismatch in "
                              f"{self._shards[e.shard_id]}")
        return np.frombuffer(raw, dtype).reshape(e.shape).astype(
            dtype.newbyteorder("="))


def latest_checkpoint(checkpoint_dir: str) -> str:
    """The prefix that ``checkpoint_dir``'s ``checkpoint`` state file names
    (its ``model_checkpoint_path``, relative to the directory unless
    absolute)."""
    state = os.path.join(checkpoint_dir, "checkpoint")
    if not os.path.exists(state):
        raise FileNotFoundError(f"no checkpoint state file in "
                                f"{checkpoint_dir!r}")
    with open(state) as f:
        m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"',
                      f.read(), re.M)
    if m is None:
        raise BundleError(f"{state}: no model_checkpoint_path")
    path = codecs.escape_decode(m.group(1).encode("utf-8"))[0].decode("utf-8")
    return path if os.path.isabs(path) else os.path.join(checkpoint_dir, path)


def load_checkpoint(path: str) -> BundleReader:
    """A reader of the bundle at prefix ``path``, or of the one that the
    directory ``path``'s ``checkpoint`` file names."""
    if os.path.isdir(path):
        path = latest_checkpoint(path)
    return BundleReader(path)
