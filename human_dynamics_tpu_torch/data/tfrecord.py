"""TFRecord + tf.train.Example IO without TensorFlow.

A copy of ``human_dynamics_tpu/data/tfrecord.py``: the port
imports nothing of the JAX package.

The training/eval data path must read the *released* InstaVariety / test
tfrecords (SURVEY.md §7 hard part 7) but the runtime should not depend on
the TF runtime. This module implements:

- the TFRecord framing (length + masked crc32c + payload + masked crc32c),
- a minimal protobuf codec for tf.train.Example
  (Features/Feature/BytesList/FloatList/Int64List), handling both packed
  and unpacked repeated encodings on parse.

CRC32C uses the C-accelerated ``google_crc32c`` when it is installed,
else ``crc32c_lanes`` (numpy, all of a record's 256-byte blocks at once;
``crc32c_bytewise``, a Python loop over the bytes, is its plain version).

Wire-format facts used (protobuf encoding spec):
    Example.features = field 1 (LEN); Features.feature = field 1 (LEN,
    map<string, Feature> -> repeated entry {1: key, 2: value});
    Feature oneof: bytes_list=1, float_list=2, int64_list=3 (all LEN);
    *List.value = field 1 (bytes: LEN; float: I32, packed; int64: VARINT,
    packed).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

import numpy as np

_CRC_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_LANE = 256             # bytes of a block in crc32c_lanes


def _crc_byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_CRC_POLY), t >> 1)
    return t.astype(np.uint32)


_CRC_TABLE = _crc_byte_table()
_CRC_TABLE_LIST = _CRC_TABLE.tolist()


def _crc_update(crc: int, data: bytes) -> int:
    """The CRC-32C register after ``data``, one byte at a time."""
    table = _CRC_TABLE_LIST
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def crc32c_bytewise(data: bytes) -> int:
    """CRC-32C of ``data``, a table lookup per byte (the plain version)."""
    return _crc_update(0xFFFFFFFF, data) ^ 0xFFFFFFFF


def _gf2_apply(cols: np.ndarray, x) -> np.ndarray:
    """The GF(2) 32x32 matrix with columns ``cols`` (the images of bits
    0-31) applied to each uint32 of ``x``."""
    x = np.asarray(x, np.uint32)
    out = np.zeros_like(x)
    for k in range(32):
        out ^= np.where((x >> k) & 1, cols[k], np.uint32(0))
    return out


def _zero_shift_cols(nbytes_log2: int) -> np.ndarray:
    """Columns of the linear map that runs a CRC register over
    2**nbytes_log2 zero bytes."""
    bits = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    cols = _CRC_TABLE[bits & 0xFF] ^ (bits >> 8)    # one zero byte
    for _ in range(nbytes_log2):
        cols = _gf2_apply(cols, cols)
    return cols


_LANE_SHIFT = _zero_shift_cols(_LANE.bit_length() - 1)


def crc32c_lanes(data: bytes) -> int:
    """CRC-32C of ``data`` with numpy: the bytes before a whole number of
    _LANE-byte blocks one at a time, then every block's register from 0
    at once (one table lookup per byte column), then the blocks' registers
    combined pairwise. The register is affine in its start: running it
    over a block B from s gives Z_B(s) ^ (the register over B from 0),
    with Z_B the linear map of len(B) zero bytes."""
    buf = np.frombuffer(data, np.uint8)
    n_blocks = len(buf) // _LANE
    head = len(buf) - n_blocks * _LANE
    state = _crc_update(0xFFFFFFFF, buf[:head].tobytes())
    if n_blocks:
        regs = np.zeros(n_blocks, np.uint32)
        for column in np.ascontiguousarray(
                buf[head:].reshape(n_blocks, _LANE).T):
            regs = _CRC_TABLE[(regs ^ column) & 0xFF] ^ (regs >> 8)
        shift, acc = _LANE_SHIFT, np.uint32(state)
        while len(regs):
            if len(regs) % 2:
                acc = _gf2_apply(shift, acc) ^ regs[0]
                regs = regs[1:]
            regs = _gf2_apply(shift, regs[0::2]) ^ regs[1::2]
            shift = _gf2_apply(shift, shift)
        state = int(acc)
    return state ^ 0xFFFFFFFF


try:
    import google_crc32c

    def _crc32c(data: bytes) -> int:
        return google_crc32c.value(data)

except ImportError:  # pragma: no cover - fallback
    _crc32c = crc32c_lanes


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecord(path: str, check_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if check_crc and _masked_crc(header) != len_crc:
                raise IOError(f"Corrupt length CRC in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"Truncated record in {path}")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if check_crc and _masked_crc(data) != data_crc:
                raise IOError(f"Corrupt data CRC in {path}")
            yield data


# ---------------------------------------------------------------------------
# Protobuf primitives
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out.extend(payload)


# ---------------------------------------------------------------------------
# Feature (de)serialization
# ---------------------------------------------------------------------------

FeatureValue = Union[np.ndarray, List[bytes]]


def _encode_feature(value: FeatureValue) -> bytes:
    """Python value -> serialized tf.train.Feature."""
    inner = bytearray()
    if isinstance(value, (list, tuple)) and (
        len(value) == 0 or isinstance(value[0], (bytes, str))
    ):
        # BytesList (field 1), value = repeated bytes (field 1).
        blist = bytearray()
        for v in value:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_len_delimited(blist, 1, v)
        _write_len_delimited(inner, 1, bytes(blist))
    else:
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating):
            # FloatList (field 2), packed floats (field 1, I32).
            payload = arr.astype("<f4").ravel().tobytes()
            flist = bytearray()
            _write_len_delimited(flist, 1, payload)
            _write_len_delimited(inner, 2, bytes(flist))
        elif np.issubdtype(arr.dtype, np.integer):
            ilist = bytearray()
            packed = bytearray()
            for v in arr.ravel().tolist():
                _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
            _write_len_delimited(ilist, 1, bytes(packed))
            _write_len_delimited(inner, 3, bytes(ilist))
        else:
            raise TypeError(f"Unsupported feature dtype: {arr.dtype}")
    return bytes(inner)


def _decode_list_message(data: bytes, kind: int) -> FeatureValue:
    """Decode BytesList/FloatList/Int64List payload."""
    pos = 0
    if kind == 1:
        out_b: List[bytes] = []
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            assert tag >> 3 == 1
            length, pos = _read_varint(data, pos)
            out_b.append(data[pos:pos + length])
            pos += length
        return out_b
    if kind == 2:
        floats: List[float] = []
        chunks = []
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            wire = tag & 7
            if wire == 2:  # packed
                length, pos = _read_varint(data, pos)
                chunks.append(np.frombuffer(
                    data, dtype="<f4", count=length // 4, offset=pos
                ))
                pos += length
            elif wire == 5:  # unpacked single float
                floats.append(
                    struct.unpack_from("<f", data, pos)[0]
                )
                pos += 4
            else:
                raise IOError("Bad FloatList wire type")
        if chunks and not floats:
            return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        if floats:
            chunks.append(np.asarray(floats, np.float32))
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if kind == 3:
        vals: List[int] = []
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            wire = tag & 7
            if wire == 2:  # packed varints
                length, pos = _read_varint(data, pos)
                end = pos + length
                while pos < end:
                    v, pos = _read_varint(data, pos)
                    vals.append(v)
            elif wire == 0:
                v, pos = _read_varint(data, pos)
                vals.append(v)
            else:
                raise IOError("Bad Int64List wire type")
        arr = np.asarray(vals, np.uint64).astype(np.int64)
        return arr
    raise IOError(f"Unknown list kind {kind}")


def _decode_feature(data: bytes) -> FeatureValue:
    pos = 0
    result: FeatureValue = np.zeros(0, np.float32)
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field = tag >> 3
        length, pos = _read_varint(data, pos)
        result = _decode_list_message(data[pos:pos + length], field)
        pos += length
    return result


# ---------------------------------------------------------------------------
# Example (de)serialization
# ---------------------------------------------------------------------------


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """{name: value} -> serialized tf.train.Example.

    Values: numpy int/float arrays (any shape; flattened) or lists of
    bytes/str.
    """
    feats = bytearray()
    for name in sorted(features):
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, _encode_feature(features[name]))
        _write_len_delimited(feats, 1, bytes(entry))
    example = bytearray()
    _write_len_delimited(example, 1, bytes(feats))
    return bytes(example)


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    """Serialized tf.train.Example -> {name: np.ndarray | list[bytes]}."""
    pos = 0
    features: Dict[str, FeatureValue] = {}
    # Example message.
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        if tag >> 3 != 1:
            raise IOError("Not an Example proto")
        length, pos = _read_varint(data, pos)
        fdata = data[pos:pos + length]
        pos += length
        # Features message: repeated map entries (field 1).
        fpos = 0
        while fpos < len(fdata):
            ftag, fpos = _read_varint(fdata, fpos)
            assert ftag >> 3 == 1
            flen, fpos = _read_varint(fdata, fpos)
            entry = fdata[fpos:fpos + flen]
            fpos += flen
            # Map entry: key (1), value (2).
            epos = 0
            key = None
            value = None
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                elen, epos = _read_varint(entry, epos)
                payload = entry[epos:epos + elen]
                epos += elen
                if etag >> 3 == 1:
                    key = payload.decode("utf-8")
                else:
                    value = _decode_feature(payload)
            if key is not None:
                features[key] = value
    return features
