"""A reader of TF1 checkpoints (the V2 tensor bundle) that needs no TensorFlow.

A checkpoint `<prefix>` (say `model.ckpt`) is two kinds of file:

  <prefix>.index                 a LevelDB-format table (sorted keys, each
                                 block's keys prefix-compressed, a restart
                                 array, a 5-byte trailer; a 48-byte footer
                                 ending in the magic 0xdb4775248b80fb57). The
                                 empty key holds the BundleHeaderProto
                                 (num_shards, endianness); every other key
                                 is a tensor's name, its value a
                                 BundleEntryProto (dtype, shape, shard_id,
                                 offset, size, crc32c, slices).
  <prefix>.data-<s>-of-<n>       each tensor's bytes at its entry's offset
                                 in its shard, little-endian, row-major.

The protobuf messages are decoded here by hand (varints and length-delimited
fields). What this reader does not read raises NotImplementedError naming
it: a compressed table block, a big-endian bundle, a tensor stored as
slices, a string or other non-numeric tensor. The blocks' and tensors'
crc32c checksums are not verified.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48

# tensorflow/core/framework/types.proto: the numeric DataType values
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16, 6: np.int8, 9: np.int64,
    10: np.bool_, 17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
}
_DTYPE_NAMES = {7: "DT_STRING", 8: "DT_COMPLEX64", 14: "DT_BFLOAT16", 18: "DT_COMPLEX128", 20: "DT_RESOURCE",
                21: "DT_VARIANT"}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, position after it) of the base-128 varint at `pos`."""
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes) -> List[Tuple[int, object]]:
    """The (field number, value) pairs of a protobuf message: an int for a
    varint or fixed field, bytes for a length-delimited one."""
    out, pos = [], 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not read")
        out.append((field, value))
    return out


def _block(data: bytes, offset: int, size: int) -> List[Tuple[bytes, bytes]]:
    """The (key, value) entries of the table block at (offset, size)."""
    compression = data[offset + size]
    if compression != 0:
        raise NotImplementedError(f"table block at {offset} is compressed (type {compression}): only uncompressed "
                                  "bundle indexes are read")
    blk = data[offset:offset + size]
    n_restarts = struct.unpack_from("<I", blk, len(blk) - 4)[0]
    end = len(blk) - 4 - 4 * n_restarts
    entries, pos, key = [], 0, b""
    while pos < end:
        shared, pos = _varint(blk, pos)
        unshared, pos = _varint(blk, pos)
        vlen, pos = _varint(blk, pos)
        key = key[:shared] + blk[pos:pos + unshared]
        pos += unshared
        entries.append((key, blk[pos:pos + vlen]))
        pos += vlen
    return entries


def _handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


def read_index(path: str) -> Dict[str, bytes]:
    """Every (key, value) of the LevelDB-format table at `path`."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER or struct.unpack_from("<Q", data, len(data) - 8)[0] != _MAGIC:
        raise ValueError(f"{path}: not a LevelDB-format table (no magic in its footer)")
    footer = data[len(data) - _FOOTER:]
    _, _, pos = _handle(footer)  # the metaindex block, which bundles leave empty
    index_offset, index_size, _ = _handle(footer, pos)
    out = {}
    for _, handle in _block(data, index_offset, index_size):
        offset, size, _ = _handle(handle)
        out.update((k.decode(), v) for k, v in _block(data, offset, size))
    return out


class TF1Checkpoint:
    """The tensors of a TF1 checkpoint `prefix` (or of a directory's latest,
    named by its `checkpoint` file), read as numpy arrays."""

    def __init__(self, prefix: str):
        if os.path.isdir(prefix):
            with open(os.path.join(prefix, "checkpoint")) as f:
                line = next(l for l in f if l.startswith("model_checkpoint_path:"))
            name = line.split(":", 1)[1].strip().strip('"')
            prefix = name if os.path.isabs(name) else os.path.join(prefix, name)
        self.prefix = prefix
        entries = read_index(prefix + ".index")
        header = dict(_fields(entries.pop("", b"")))
        self.num_shards = header.get(1, 1)
        if header.get(2, 0) != 0:
            raise NotImplementedError(f"{prefix}: a big-endian bundle is not read")
        self._entries = {}
        for name, value in entries.items():
            f = _fields(value)
            dims = [dict(_fields(d)).get(1, 0) for n, s in f if n == 2 for k, d in _fields(s) if k == 2]
            e = dict(f)
            self._entries[name] = {"dtype": e.get(1, 0), "shape": tuple(dims), "shard": e.get(3, 0),
                                   "offset": e.get(4, 0), "size": e.get(5, 0), "sliced": 7 in e}

    def shapes(self) -> Dict[str, tuple]:
        """{name: shape} of every tensor (`get_variable_to_shape_map`)."""
        return {k: e["shape"] for k, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        e = self._entries[name]
        if e["sliced"]:
            raise NotImplementedError(f"{self.prefix}: tensor {name!r} is stored as slices (not read)")
        if e["dtype"] not in _DTYPES:
            what = _DTYPE_NAMES.get(e["dtype"], f"DataType {e['dtype']}")
            raise NotImplementedError(f"{self.prefix}: tensor {name!r} is {what} (only numeric tensors are read)")
        dtype = np.dtype(_DTYPES[e["dtype"]]).newbyteorder("<")
        n = int(np.prod(e["shape"], dtype=np.int64))
        if n * dtype.itemsize != e["size"]:
            raise ValueError(f"{self.prefix}: tensor {name!r} has {e['size']} bytes for shape {e['shape']}")
        shard = f"{self.prefix}.data-{e['shard']:05d}-of-{self.num_shards:05d}"
        with open(shard, "rb") as f:
            f.seek(e["offset"])
            buf = f.read(e["size"])
        return np.frombuffer(buf, dtype=dtype, count=n).reshape(e["shape"]).astype(dtype.newbyteorder("="))
