"""A small MessagePack codec for the checkpoint layout.

It covers the types a checkpoint holds: maps, arrays, str, bin and ints
of either sign (and nil and bool). Each value is written in the smallest
form the format allows, the form ``msgpack.packb(obj, use_bin_type=True)``
picks, so a file written here is byte for byte the one that library
writes for the same object, and either reads the other's files.
"""
from __future__ import annotations

import struct
from typing import Any, Iterator

_U8, _U16, _U32, _U64 = (struct.Struct(">B"), struct.Struct(">H"),
                         struct.Struct(">I"), struct.Struct(">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(">b"), struct.Struct(">h"),
                         struct.Struct(">i"), struct.Struct(">q"))


def _sized(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    """The header of a str, bin, array or map of ``n`` elements: the fixed
    form where ``fix_base`` is not None and n <= fix_max, else the 8-, 16-
    or 32-bit length form of ``codes`` (None where the form is absent)."""
    if fix_base is not None and n <= fix_max:
        return bytes((fix_base | n,))
    for code, limit, st in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF),
                               (_U8, _U16, _U32)):
        if code is not None and n <= limit:
            return bytes((code,)) + st.pack(n)
    raise ValueError(f"object of {n} elements is too large for msgpack")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes((v,))
    if -32 <= v < 0:
        return bytes((v & 0xFF,))
    if v > 0:
        for code, limit, st in ((0xCC, 0xFF, _U8), (0xCD, 0xFFFF, _U16),
                                (0xCE, 0xFFFFFFFF, _U32),
                                (0xCF, 0xFFFFFFFFFFFFFFFF, _U64)):
            if v <= limit:
                return bytes((code,)) + st.pack(v)
    else:
        for code, lo, st in ((0xD0, -0x80, _I8), (0xD1, -0x8000, _I16),
                             (0xD2, -0x80000000, _I32),
                             (0xD3, -0x8000000000000000, _I64)):
            if v >= lo:
                return bytes((code,)) + st.pack(v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def pack_chunks(obj: Any) -> Iterator[bytes]:
    """The encoding of ``obj`` as a stream of byte strings (a bin's
    payload is yielded as it is, never copied into a larger buffer)."""
    if obj is None:
        yield b"\xc0"
    elif obj is True:
        yield b"\xc3"
    elif obj is False:
        yield b"\xc2"
    elif isinstance(obj, int):
        yield _int(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        yield _sized(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        yield raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        yield _sized(n, None, 0, (0xC4, 0xC5, 0xC6))
        yield obj
    elif isinstance(obj, (list, tuple)):
        yield _sized(len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for x in obj:
            yield from pack_chunks(x)
    elif isinstance(obj, dict):
        yield _sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            yield from pack_chunks(k)
            yield from pack_chunks(v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (_U8, self.bin), 0xC5: (_U16, self.bin),
                 0xC6: (_U32, self.bin), 0xD9: (_U8, self.str),
                 0xDA: (_U16, self.str), 0xDB: (_U32, self.str),
                 0xDC: (_U16, self.array), 0xDD: (_U32, self.array),
                 0xDE: (_U16, self.map), 0xDF: (_U32, self.map)}
        if b in sized:
            st, read = sized[b]
            return read(self.num(st))
        nums = {0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
                0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}
        if b in nums:
            return self.num(nums[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def bin(self, n: int) -> memoryview:
        return self.take(n)

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(buf) -> Any:
    """Decode one object from ``buf``: str as str, bin as a memoryview
    into ``buf`` (no copy)."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         f"the msgpack object")
    return out
