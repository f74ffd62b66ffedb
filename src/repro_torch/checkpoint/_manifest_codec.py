"""The MessagePack subset a checkpoint manifest holds, encoded byte for
byte as ``msgpack.packb`` encodes it by default, and decoded.

A manifest is maps, lists, ``str``, ``int``, ``float`` (the loss), ``bool``
(``preempted``) and ``None``.  The encoder writes each in its smallest
form, as msgpack does: ints as positive or negative fixint, else the
unsigned (non-negative) or signed form of the fewest bytes; floats as
float64 (``0xcb``); strs as UTF-8 in fixstr/str8/str16/str32; maps and
lists (tuples too) in their fix/16/32 forms.  Any other type raises
``TypeError``: nothing is coerced.  The decoder reads every form the
encoder writes, which is every form either package's manifests hold,
and raises ``ValueError`` on any other.

Not named ``msgpack``, so it never shadows the real package.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

__all__ = ["packb", "unpackb"]


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return struct.pack("B", x)
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if x < top:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
            if x >= low:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"int {x} does not fit in 64 bits")


def _head(n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> bytes:
    """A str/array/map header: the fix form below ``fix_max``, else the
    8- (str only), 16- or 32-bit length form."""
    if n < fix_max:
        return bytes([fix | n])
    widths = ((">B", 1 << 8), (">H", 1 << 16), (">I", 1 << 32))[3 - len(codes):]
    for code, (fmt, top) in zip(codes, widths):
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit in 32 bits")


def _pack(x: Any, out: list):
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int) and not isinstance(x, bool):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_head(len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb)) + raw)
    elif isinstance(x, (list, tuple)):
        out.append(_head(len(x), 0x90, 16, (0xdc, 0xdd)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_head(len(x), 0x80, 16, (0xde, 0xdf)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"a manifest cannot hold {type(x).__name__!r} ({x!r})")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack, byte for byte ``msgpack.packb(obj)``."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width forms by first byte: (struct format, byte count)
_SCALARS = {0xcb: (">d", 8),
            0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
            0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# length-prefixed forms: first byte -> (kind, length format, byte count)
_SIZED = {0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2), 0xdb: ("str", ">I", 4),
          0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
          0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4)}


def _take(buf: bytes, i: int, n: int) -> bytes:
    if i + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return buf[i:i + n]


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    b = _take(buf, i, 1)[0]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if b == 0xc0:
        return None, i
    if b in (0xc2, 0xc3):
        return b == 0xc3, i
    if b in _SCALARS:
        fmt, n = _SCALARS[b]
        return struct.unpack(fmt, _take(buf, i, n))[0], i + n
    if 0xa0 <= b < 0xc0:
        kind, n = "str", b & 0x1f
    elif 0x90 <= b < 0xa0:
        kind, n = "array", b & 0x0f
    elif 0x80 <= b < 0x90:
        kind, n = "map", b & 0x0f
    elif b in _SIZED:
        kind, fmt, w = _SIZED[b]
        n = struct.unpack(fmt, _take(buf, i, w))[0]
        i += w
    else:
        raise ValueError(f"MessagePack type byte 0x{b:02x} is not a manifest's")
    if kind == "str":
        return _take(buf, i, n).decode("utf-8"), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    d = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        d[k], i = _unpack(buf, i)
    return d, i


def unpackb(buf: bytes) -> Any:
    """The object one MessagePack value encodes (str as ``str``, arrays as
    lists), as ``msgpack.unpackb(buf)``; raises ``ValueError`` on trailing
    or truncated bytes."""
    obj, i = _unpack(bytes(buf), 0)
    if i != len(buf):
        raise ValueError(f"{len(buf) - i} bytes after the MessagePack value")
    return obj
