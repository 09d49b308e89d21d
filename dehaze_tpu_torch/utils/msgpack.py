"""A msgpack decoder in pure Python for the files the JAX package writes
(`flax.serialization.msgpack_serialize`), so the port reads them on a
host that has neither `msgpack` nor `flax`.

It decodes the subset flax emits: nil, bool, ints, floats, str, bin,
array and map, and flax's ext types
  1  ndarray: a nested msgpack of (shape, dtype name, C-order bytes);
  2  complex: a nested msgpack of (real, imag);
  3  numpy scalar: an ndarray of shape ();
and flax's chunked form of an array over its MAX_CHUNK_SIZE bytes (a map
`{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": ...}}`). flax's `to_state_dict` has already turned lists and tuples
into maps keyed "0", "1", ...; they come back as such maps. Arrays are
numpy arrays, except bfloat16 ones, which numpy cannot hold: their raw
bytes are viewed as uint16 and then as a `torch.bfloat16` tensor.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """Objects decoded one by one from a buffer, from `pos` on."""

    def __init__(self, data, pos: int = 0):
        self.buf = memoryview(data)
        self.pos = pos

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _head(self) -> Tuple[str, Any]:
        """(kind, size or value) of the next object, its header read."""
        b = self._take(1)[0]
        if b <= 0x7F:
            return "value", b
        if b >= 0xE0:
            return "value", b - 0x100
        if 0x80 <= b <= 0x8F:
            return "map", b & 0x0F
        if 0x90 <= b <= 0x9F:
            return "array", b & 0x0F
        if 0xA0 <= b <= 0xBF:
            return "str", b & 0x1F
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return "value", fixed[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"),
                 0xC6: ("bin", ">I"), 0xD9: ("str", ">B"),
                 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"),
                 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            return kind, self._unpack(fmt)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return "value", self._unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return "ext", 1 << (b - 0xD4)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def read(self) -> Any:
        kind, n = self._head()
        if kind == "value":
            return n
        if kind == "str":
            return str(self._take(n), "utf-8")
        if kind == "bin":
            return bytes(self._take(n))
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                k = self.read()
                out[k] = self.read()
            return out
        code = self._unpack(">b")
        return _ext(code, self._take(n))

    def skip(self) -> None:
        """Step over the next object without building it."""
        kind, n = self._head()
        if kind in ("str", "bin"):
            self._take(n)
        elif kind == "ext":
            self._take(n + 1)
        elif kind in ("array", "map"):
            for _ in range(n * (2 if kind == "map" else 1)):
                self.skip()


def _ndarray(data: memoryview):
    r = _Reader(data)
    kind, n = r._head()
    if kind != "array" or n != 3:
        raise ValueError("msgpack: an ndarray record is not (shape, dtype, "
                         "bytes)")
    shape = tuple(r.read())
    name = r.read()
    name = name.decode() if isinstance(name, bytes) else name
    buf = r.read()
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(buf, np.uint16).copy())
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        a = _ndarray(data)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(data).read()
        return complex(re, im)
    raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    """flax's `_unchunk_array_leaves_in_place`: chunked maps anywhere in a
    tree of maps become arrays."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_tree(v)
    return d


def unpackb(data) -> Any:
    """The object that `data` (a whole msgpack buffer) holds, as
    `flax.serialization.msgpack_restore` gives it."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         "object")
    return _unchunk_tree(out)


def read_map(data, skip=()) -> dict:
    """The top-level map of `data`; the values of the keys in `skip` are
    stepped over unread (and left out)."""
    r = _Reader(data)
    kind, n = r._head()
    if kind != "map":
        raise ValueError("msgpack: the top-level object is not a map")
    out = {}
    for _ in range(n):
        k = r.read()
        if k in skip:
            r.skip()
        else:
            out[k] = _unchunk_tree(r.read())
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the map")
    return out
