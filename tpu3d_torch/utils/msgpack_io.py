"""The msgpack subset that tpu3d's checkpoints are written in, by hand.

tpu3d saves a checkpoint with ``flax.serialization.to_bytes`` and reads it
with ``msgpack_restore``. The port imports no flax, and the card's host has
no JAX, so this module encodes and decodes exactly what those two write for
a checkpoint, the same way on every host:

- maps with str keys, in the tree's own key order (map16 / map32 above 15
  entries);
- Python ints, packed as msgpack-python packs them (the shortest form);
- numpy arrays as flax's ext type 1 and numpy scalars as its ext type 3,
  each holding the msgpack array ``(shape, dtype name, C-order bytes)``.

Encoding an object that flax would write gives its bytes exactly, and
decoding gives what ``msgpack_restore`` gives (read-only arrays from the
buffer, numpy scalars for ext 3); ``tests/test_torch_checkpoint.py`` holds
both. flax splits an array above ``MAX_CHUNK_SIZE`` bytes into chunks; no
checkpoint of this model comes near it, so the encoder refuses such an
array instead.
"""

from __future__ import annotations

import struct

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization's chunking threshold, bytes
EXT_NDARRAY, EXT_NPSCALAR = 1, 3  # flax's _MsgpackExtType


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for tag, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                              (0xce, ">I", 0xffffffff),
                              (0xcf, ">Q", 0xffffffffffffffff)):
            if x <= top:
                return bytes([tag]) + struct.pack(fmt, x)
    else:
        for tag, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                              (0xd2, ">i", -0x80000000),
                              (0xd3, ">q", -0x8000000000000000)):
            if x >= low:
                return bytes([tag]) + struct.pack(fmt, x)
    raise OverflowError(x)


def _sized(n: int, fix: int | None, fix_max: int, tags) -> bytes:
    """A header for ``n`` items or bytes: the fix form below ``fix_max``,
    else the first of (tag, format, top) whose top holds ``n``."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for tag, fmt, top in tags:
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items do not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xa0, 31, ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                                     (0xdb, ">I", 0xffffffff))) + b


def _bin(b: bytes) -> bytes:
    return _sized(len(b), None, 0, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                                    (0xc6, ">I", 0xffffffff))) + b


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff)))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff)))


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        return bytes([fixed[len(data)], code]) + data
    return _sized(len(data), None, 0, ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                                       (0xc9, ">I", 0xffffffff))) \
        + bytes([code]) + data


def _ndarray(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack array (shape, dtype name,
    bytes)."""
    assert arr.nbytes <= MAX_CHUNK_SIZE, (
        f"an array of {arr.nbytes} bytes would need flax's chunked form")
    assert not (arr.dtype.hasobject or arr.dtype.isalignedstruct), arr.dtype
    return (_array_header(3)
            + _array_header(len(arr.shape))
            + b"".join(_int(int(d)) for d in arr.shape)
            + _str(arr.dtype.name) + _bin(arr.tobytes("C")))


def _encode(x, out: list) -> None:
    if isinstance(x, dict):
        out.append(_map_header(len(x)))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            out.append(_str(k))
            _encode(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray(np.asarray(x))))
    elif type(x) is int:
        out.append(_int(x))
    else:
        raise TypeError(f"{type(x).__name__} is not in the checkpoint subset")


def encode(tree) -> bytes:
    """A tree of str-keyed dicts, ints, numpy scalars and arrays -> the bytes
    ``flax.serialization.msgpack_serialize`` gives for it."""
    out: list = []
    _encode(tree, out)
    return b"".join(out)


_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        chunk = self.data[self.pos:self.pos + n]
        if len(chunk) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(chunk)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map(tag & 0x0f, raw)
        if 0x90 <= tag <= 0x9f:
            return [self.value(raw) for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return self.text(tag & 0x1f, raw)
        if tag in _INTS:
            return self.unpack(_INTS[tag])
        if tag in _FIXEXT:
            return self.ext(_FIXEXT[tag])
        if tag not in _SIZED:
            raise ValueError(f"msgpack type 0x{tag:02x} is not in the "
                             "checkpoint subset")
        kind, fmt = _SIZED[tag]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.text(n, raw)
        if kind == "array":
            return [self.value(raw) for _ in range(n)]
        if kind == "map":
            return self.map(n, raw)
        return self.ext(n)

    def text(self, n: int, raw: bool):
        b = self.take(n)
        return b if raw else b.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not in the "
                             "checkpoint subset")
        inner = _Reader(data)
        shape, dtype, buf = inner.value(raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode()), count=-1,
                            offset=0).reshape(shape, order="C")
        return arr if code == EXT_NDARRAY else arr[()]


def decode(data: bytes):
    """The inverse of ``encode``: what ``flax.serialization.msgpack_restore``
    gives for a checkpoint's bytes."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree
