"""A reader for the JAX package's checkpoints (flax msgpack state dicts,
``plnerf/checkpoint/io.py``: ``{step:06d}.ckpt`` and its ``.occ`` grid
sidecar), in plain Python and numpy: the port reads them without
``flax`` or ``msgpack``, which the card's machine does not have.

``msgpack_restore`` decodes what ``flax.serialization.msgpack_serialize``
writes: maps, arrays (as lists), str, bin, ints, floats, nil and bool,
with flax's extension types ext 1 (an ndarray: a packed ``(shape, dtype
name, C-order buffer)``), ext 2 (a complex) and ext 3 (a numpy scalar,
packed as an ndarray).  Lengths and numbers are big-endian.  numpy has no
bfloat16, so a ``"bfloat16"`` buffer is read as uint16 and returned as a
``torch.bfloat16`` tensor.  flax splits an array of more than 2^30 bytes
into a chunked form, which no checkpoint of this model reaches; it is
refused.

``read_state`` also turns flax's digit-keyed dicts (``"0"``, ``"1"``, ...,
how it stores lists and tuples) back into lists.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
# fixed-width codes: (struct format, byte count)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        b = self.uint(1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.uint(1 << (b - 0xc4))))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.uint(1 << (b - 0xc7))
            return self.ext(n)
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in (0xd9, 0xda, 0xdb):
            return str(self.take(self.uint(1 << (b - 0xd9))), "utf-8")
        if b in (0xdc, 0xdd):
            return self.array(self.uint(2 if b == 0xdc else 4))
        if b in (0xde, 0xdf):
            return self.map(self.uint(2 if b == 0xde else 4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at "
                         f"{self.pos - 1}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise ValueError(
                "flax chunked array (a leaf over 2^30 bytes): not supported")
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        data = bytes(self.take(n))
        if code == 1:
            return _ndarray(data)
        if code == 2:
            re, im = _unpack(data)
            return complex(re, im)
        if code == 3:
            a = _ndarray(data)
            return a if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"msgpack: unknown extension type {code}")


def _unpack(data: bytes) -> Any:
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def _ndarray(data: bytes):
    shape, name, buf = _unpack(data)
    if isinstance(name, bytes):
        name = name.decode()
    shape: Tuple[int, ...] = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").view(np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns for
    ``data`` (bfloat16 leaves as torch tensors)."""
    return _unpack(data)


def digitlist(d: Any) -> Any:
    """flax stores lists and tuples as dicts keyed '0', '1', ...: back to
    lists, recursively."""
    if isinstance(d, dict):
        if d and all(isinstance(k, str) and k.isdigit() for k in d):
            return [digitlist(d[str(i)]) for i in range(len(d))]
        return {k: digitlist(v) for k, v in d.items()}
    return d


def read_state(path: str) -> Any:
    """A JAX package checkpoint or sidecar file as a tree of dicts, lists
    and arrays."""
    with open(path, "rb") as f:
        return digitlist(msgpack_restore(f.read()))


def is_flax_file(path: str) -> bool:
    """A flax state dict starts with a msgpack map; a ``torch.save`` file
    is a zip archive (``PK\\x03\\x04``)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return False
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))
