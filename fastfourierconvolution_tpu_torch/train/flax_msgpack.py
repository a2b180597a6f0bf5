"""Read the flax msgpack files the JAX package writes (its ``.ckpt``
checkpoints), with numpy alone.

``restore(data)`` gives what ``flax.serialization.msgpack_restore`` gives
for bytes that ``msgpack_serialize`` wrote: nested dicts with str keys;
lists; str, bytes, int, float, bool and None; ndarrays (ext type 1, a
packed ``(shape, dtype name, C-order bytes)``), complex numbers (ext type
2, a packed ``(real, imag)``) and numpy scalars (ext type 3, a 0-d ndarray
packed as type 1 is); arrays over flax's 2^30-byte chunk size, which flax
writes as maps under the key ``__msgpack_chunked_array__``, are joined
back. numpy has no ``bfloat16``: a leaf of that dtype is read as its
uint16 bits shifted into float32, which holds every bfloat16 value
exactly.

The arrays are read-only. A truncated or malformed input raises
``ValueError`` naming the byte offset.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# first byte -> (struct format, size) of the fixed-size scalars
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
            0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
# first byte -> bytes of the length field, for str (0xd9-0xdb), bin
# (0xc4-0xc6), array (0xdc, 0xdd), map (0xde, 0xdf) and ext (0xc7-0xc9)
_LENGTHS = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4, 0xDC: 2, 0xDD: 4,
            0xDE: 2, 0xDF: 4, 0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """msgpack objects from ``buf``, whose first byte is at offset ``base``
    of the file (ext payloads are read by a reader of their own)."""

    def __init__(self, buf: memoryview, base: int = 0):
        self.buf, self.pos, self.base = buf, 0, base

    def fail(self, what: str, at: int) -> ValueError:
        return ValueError(f"flax msgpack: {what} at byte offset {self.base + at}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise self.fail(f"truncated: {n} bytes wanted, {len(self.buf) - self.pos} left",
                            self.pos)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        at = self.pos
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            fmt, size = _SCALARS[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _LENGTHS:
            n = self.uint(_LENGTHS[b])
            if b in (0xD9, 0xDA, 0xDB):
                return self.text(n, at)
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n, at)
            return self.ext(n, at)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        raise self.fail(f"byte 0x{b:02x} starts no msgpack object", at)

    def text(self, n: int, at: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError:
            raise self.fail("a str that is not UTF-8", at) from None

    def map(self, n: int, at: int) -> Any:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if isinstance(key, (list, dict)):
                raise self.fail("a map key that is a list or a map", key_at)
            out[key] = self.value()
        return _unchunk(out, self, at) if CHUNKED in out else out

    def ext(self, n: int, at: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        start = self.pos
        inner = _Reader(self.take(n), self.base + start)
        if code == EXT_NDARRAY:
            out = inner.ndarray(at)
        elif code == EXT_NPSCALAR:
            out = inner.ndarray(at)[()]
        elif code == EXT_COMPLEX:
            parts = inner.value()
            if (not isinstance(parts, list) or len(parts) != 2
                    or not all(isinstance(p, (int, float)) for p in parts)):
                raise self.fail("a complex number that is no (real, imag) pair", at)
            out = complex(parts[0], parts[1])
        else:
            raise self.fail(f"ext type {code}, which flax does not write", at)
        inner.end()
        return out

    def ndarray(self, at: int) -> np.ndarray:
        triple = self.value()
        if not (isinstance(triple, list) and len(triple) == 3):
            raise self.fail("an ndarray that is no (shape, dtype, bytes) triple", at)
        shape, name, data = triple
        if (not isinstance(shape, list) or not all(isinstance(s, int) and s >= 0 for s in shape)
                or not isinstance(name, str) or not isinstance(data, bytes)):
            raise self.fail("an ndarray that is no (shape, dtype, bytes) triple", at)
        try:
            dtype = np.dtype("<u2" if name == "bfloat16" else name)
        except TypeError:
            raise self.fail(f"an ndarray of dtype {name!r}, which numpy does not know",
                            at) from None
        if dtype.hasobject or len(data) != int(np.prod(shape)) * dtype.itemsize:
            raise self.fail(f"an ndarray of {len(data)} bytes for shape {tuple(shape)} of "
                            f"{name}", at)
        arr = np.frombuffer(data, dtype=dtype).reshape(shape)
        if name == "bfloat16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise self.fail(f"{len(self.buf) - self.pos} bytes after the object", self.pos)


def _unchunk(d: dict, reader: _Reader, at: int) -> np.ndarray:
    """The array of a chunked-array map: ``shape`` and ``chunks`` as maps
    from "0", "1", ... to the dimensions and to the flat chunks."""
    try:
        shape = _indexed(d["shape"])
        chunks = _indexed(d["chunks"])
        return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
    except (KeyError, TypeError, ValueError) as e:
        raise reader.fail(f"a chunked array that does not join ({e})", at) from None


def _indexed(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def restore(data: bytes) -> Any:
    """The tree of a flax msgpack file's bytes."""
    reader = _Reader(memoryview(data))
    out = reader.value()
    reader.end()
    return out


def read(path: str) -> Any:
    """The tree of the flax msgpack file at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())
