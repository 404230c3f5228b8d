"""A decoder for flax's msgpack checkpoints, in Python and numpy.

The JAX package writes its ``.ckpt`` files with
``flax.serialization.msgpack_serialize`` (``training/checkpoint.py``).  The
port reads them without flax and without the ``msgpack`` package; the
decoder covers what ``msgpack_serialize`` writes:

- the msgpack types nil, bool, the positive and negative fixints, int and
  uint 8-64, float 32 and 64, str, bin, array and map (fix, 16 and 32
  forms), and ext (fixext 1-16, ext 8-32);
- flax's ext code 1, an ndarray: its payload is itself msgpack,
  ``(shape, dtype name, C-order bytes)``; it becomes a CPU tensor of that
  dtype (``bfloat16`` through a uint16 view, the bits unchanged);
- ext code 3, a numpy scalar: a 0-d tensor;
- ext code 2, a Python complex: ``complex(real, imag)``;
- the chunked leaves flax writes for arrays over its ``MAX_CHUNK_SIZE``,
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
  {"0": .., "1": ..}}``, joined back into one tensor where
  ``msgpack_restore`` joins them (a map's values and the top level).

As ``flax.serialization.msgpack_restore``: str is decoded as UTF-8, bin
stays bytes, an array becomes a list, a map a dict whose keys are str or
bytes (another key type raises, as msgpack's ``strict_map_key``), and bytes
left after the object raise.  Another ext code becomes ``ExtType(code,
data)``, as msgpack leaves it.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# numpy dtype names -> torch dtypes (flax writes ``arr.dtype.name``)
_TORCH_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64, "complex64": torch.complex64,
    "complex128": torch.complex128,
}

# fixed-width scalars: first byte -> (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class ExtType(NamedTuple):
    """An ext object of a code flax does not write (msgpack's ``ExtType``)."""

    code: int
    data: bytes


class _Reader:
    """One msgpack object at a time from ``data``; ``raw`` keeps str as
    bytes (flax decodes an ndarray's own payload so)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, n: int) -> int:
        return self.unpack({1: ">B", 2: ">H", 4: ">I"}[n], n)

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.obj() for _ in range(self.length(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.length(2 << (b - 0xDE)))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self.ext(self.length(1 << (b - 0xC7)))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no object")

    def str(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack: map key {key!r} is not str or bytes")
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = _unpackb(payload)
            return complex(real, imag)
        return ExtType(code, payload)


def _unpackb(data: bytes, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    out = reader.obj()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} bytes after the object")
    return out


def _ndarray(payload: bytes) -> torch.Tensor:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    shape, name, buf = _unpackb(payload, raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(buf, np.uint16).copy()).view(torch.bfloat16)
    elif name in _TORCH_DTYPES:
        flat = torch.from_numpy(np.frombuffer(buf, np.dtype(name)).copy())
    else:
        raise ValueError(f"flax ndarray of dtype {name!r}: no torch dtype for it")
    return flat.reshape(shape)


def _unchunk(d: dict) -> torch.Tensor:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``: chunked dicts at the top
    and among a dict's values, recursing through dicts only."""
    if not isinstance(d, dict):
        return d
    if _CHUNKED in d:
        return _unchunk(d)
    for k, v in d.items():
        if isinstance(v, dict):
            d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def msgpack_restore(encoded: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns for
    ``encoded``, with tensors for its arrays (see the module docstring)."""
    return _unchunk_leaves(_unpackb(encoded))


def read_tree(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
