"""The subset of msgpack that checkpoint manifests and chunk bins use, in
pure Python.

Covers maps, arrays, str, bin, ints of every width (a chunk's CRC32 is a
uint32), nil and bool; anything else raises.  :func:`packb` picks the same
(smallest) encoding for each object as ``msgpack.packb`` with its defaults,
so the bytes are equal, and :class:`Unpacker` reads one object at a time
from a file, as ``msgpack.Unpacker`` does.  A file that ends inside an
object raises :class:`OutOfData`.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO


class OutOfData(ValueError):
    """The stream ended inside an object."""


def bin_header(n: int) -> bytes:
    """The header of a bin of ``n`` bytes (its payload follows as is)."""
    if n < 1 << 8:
        return struct.pack(">BB", 0xC4, n)
    if n < 1 << 16:
        return struct.pack(">BH", 0xC5, n)
    if n < 1 << 32:
        return struct.pack(">BI", 0xC6, n)
    raise ValueError(f"bin of {n} bytes exceeds msgpack's 2**32 - 1")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack(">B", v)
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < lim:
                return struct.pack(fmt, code, v)
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                               (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if v >= -lim:
                return struct.pack(fmt, code, v)
    raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a str / array / map of ``n`` items or bytes."""
    if n < fix_max:
        return struct.pack(">B", fix | n)
    for code, fmt, lim in codes:
        if code is not None and n < lim:
            return struct.pack(fmt, code, n)
    raise ValueError(f"{n} items exceed msgpack's 2**32 - 1")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_sized(len(raw), 0xA0, 32,
                          ((0xD9, ">BB", 1 << 8), (0xDA, ">BH", 1 << 16),
                           (0xDB, ">BI", 1 << 32))))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(bin_header(len(raw)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), 0x90, 16,
                          ((0xDC, ">BH", 1 << 16), (0xDD, ">BI", 1 << 32))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), 0x80, 16,
                          ((0xDE, ">BH", 1 << 16), (0xDF, ">BI", 1 << 32))))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack_lite cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (the bytes ``msgpack.packb`` gives)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


class Unpacker:
    """Reads msgpack objects one at a time from a binary file."""

    def __init__(self, f: BinaryIO):
        self._f = f

    def read(self, n: int) -> bytes:
        """Exactly ``n`` raw bytes of the stream."""
        data = self._f.read(n)
        if len(data) != n:
            raise OutOfData(f"stream ended {n - len(data)} bytes short")
        return data

    def readinto(self, buf: memoryview) -> None:
        """Fill ``buf`` with the next ``len(buf)`` raw bytes."""
        got = self._f.readinto(buf)
        if got != len(buf):
            raise OutOfData(f"stream ended {len(buf) - got} bytes short")

    def _uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))[0]

    def bin_size(self) -> int:
        """The length of the next object, which must be a bin; its payload
        is then the next that many bytes of the stream."""
        code = self._uint(">B")
        if code not in _BIN:
            raise ValueError(f"expected a msgpack bin, found type byte "
                             f"{code:#04x}")
        return self._uint(_BIN[code])

    def unpack(self) -> Any:
        code = self._uint(">B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return self.read(code & 0x1F).decode("utf-8")
        if 0x90 <= code <= 0x9F:
            return [self.unpack() for _ in range(code & 0x0F)]
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self._uint(_FIXED[code])
        if code in _STR:
            return self.read(self._uint(_STR[code])).decode("utf-8")
        if code in _BIN:
            return self.read(self._uint(_BIN[code]))
        if code in _ARRAY:
            return [self.unpack() for _ in range(self._uint(_ARRAY[code]))]
        if code in _MAP:
            return self._map(self._uint(_MAP[code]))
        raise ValueError(f"msgpack type byte {code:#04x} is outside the "
                         f"subset checkpoints use")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out


def unpackb(data: bytes) -> Any:
    """The one object ``data`` holds."""
    import io
    buf = io.BytesIO(data)
    obj = Unpacker(buf).unpack()
    if buf.read(1):
        raise ValueError("extra bytes after the msgpack object")
    return obj
