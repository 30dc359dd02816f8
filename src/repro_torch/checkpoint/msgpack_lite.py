"""The subset of MessagePack a checkpoint manifest uses: maps, arrays,
str, int, nil and bool.

``packb`` gives the bytes ``msgpack.packb`` gives for such values (the
smallest encoding of each int, str8 and up for strings, maps in insertion
order); ``unpackb`` reads them back (maps as dicts, arrays as lists). Any
other type raises ``TypeError`` on packing and ``ValueError`` on unpacking.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _head(n: int, fix: int, fix_max: int, c16: int, c32: int) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    if n < 1 << 16:
        return bytes([c16]) + struct.pack(">H", n)
    return bytes([c32]) + struct.pack(">I", n)


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, bot in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
            if v >= bot:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit in 64 bits")


def _pack(v: Any, out: list):
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        out.append(_int(int(v)))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes([0xa0 | n]))
        elif n < 1 << 8:
            out.append(bytes([0xd9, n]))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(v, (list, tuple)):
        out.append(_head(len(v), 0x90, 15, 0xdc, 0xdd))
        for x in v:
            _pack(x, out)
    elif isinstance(v, dict):
        out.append(_head(len(v), 0x80, 15, 0xde, 0xdf))
        for k, x in v.items():
            _pack(k, out)
            _pack(x, out)
    else:
        raise TypeError(f"msgpack_lite cannot pack {type(v).__name__}")


def packb(v: Any) -> bytes:
    out: list = []
    _pack(v, out)
    return b"".join(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _unpack(b: bytes, i: int) -> Tuple[Any, int]:
    c = b[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if c == 0xc0:
        return None, i
    if c in (0xc2, 0xc3):
        return c == 0xc3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, b, i)[0], i + n
    if 0xa0 <= c <= 0xbf or c in (0xd9, 0xda, 0xdb):
        if c <= 0xbf:
            n = c & 0x1f
        else:
            fmt = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[c]
            n = struct.unpack_from(fmt, b, i)[0]
            i += struct.calcsize(fmt)
        return b[i:i + n].decode("utf-8"), i + n
    if 0x80 <= c <= 0x9f or c in (0xdc, 0xdd, 0xde, 0xdf):
        is_map = c <= 0x8f or c >= 0xde
        if c <= 0x9f:
            n = c & 0x0f
        else:
            fmt = ">H" if c in (0xdc, 0xde) else ">I"
            n = struct.unpack_from(fmt, b, i)[0]
            i += struct.calcsize(fmt)
        if is_map:
            d = {}
            for _ in range(n):
                k, i = _unpack(b, i)
                d[k], i = _unpack(b, i)
            return d, i
        items = []
        for _ in range(n):
            x, i = _unpack(b, i)
            items.append(x)
        return items, i
    raise ValueError(f"msgpack_lite: unsupported type byte 0x{c:02x} at {i - 1}")


def unpackb(b: bytes) -> Any:
    v, i = _unpack(bytes(b), 0)
    if i != len(b):
        raise ValueError(f"msgpack_lite: {len(b) - i} trailing bytes")
    return v
