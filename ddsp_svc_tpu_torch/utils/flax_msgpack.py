"""A reader of flax's msgpack checkpoints, in pure Python and numpy.

The JAX package writes its checkpoints (`train/checkpoint.py`, `.ckpt`)
with `flax.serialization.msgpack_serialize`: a msgpack map of nested string
-keyed maps whose array leaves are ext type 1, (shape, dtype name, C-order
bytes) packed as msgpack; numpy scalars ext type 3 in the same form, complex
numbers ext type 2, and arrays over 2^30 bytes split into a
`__msgpack_chunked_array__` map. The card's machine has no `msgpack`
package, so the port decodes the format itself. `read_msgpack` returns what
`flax.serialization.msgpack_restore` returns: nested dicts of numpy arrays.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), self.take(n))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.unpack(">" + "BHI"[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack: unused type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if out.get("__msgpack_chunked_array__"):
            shape = tuple(out["shape"][str(i)] for i in range(len(out["shape"])))
            chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return out

    @staticmethod
    def ext(code: int, payload: memoryview) -> Any:
        if code == _EXT_COMPLEX:
            re, im = _Reader(bytes(payload)).value()
            return complex(re, im)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown ext type {code}")
        shape, dtype, buf = _Reader(bytes(payload)).value()
        if dtype == "bfloat16":
            raise NotImplementedError("bfloat16 arrays in a flax checkpoint "
                                      "are not read; save the weights fp32")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the whole buffer)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def read_msgpack(path: str) -> Any:
    """The nested dict of numpy arrays a flax msgpack file holds."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def read_flax_checkpoint(path: str) -> Tuple[int, dict]:
    """A JAX-package `.ckpt` ({global_step, model, constants, optimizer}) ->
    (step, variables {'params': ..., 'constants': ...})."""
    payload = read_msgpack(path)
    variables = {"params": payload["model"]}
    if payload.get("constants"):
        variables["constants"] = payload["constants"]
    return int(payload["global_step"]), variables
