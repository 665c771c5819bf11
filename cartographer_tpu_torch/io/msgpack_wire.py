"""The subset of MessagePack that the native state records use.

The JAX package writes its native pbstream records with
`msgpack.packb(obj, use_bin_type=True)` and reads them with
`msgpack.unpackb(data, raw=False)`. The port does not depend on the
`msgpack` package, so it carries this codec for the types those records
hold: nil, bool, int (up to 64 bits), float, str, bytes, list and dict.

`packb` gives the bytes `msgpack.packb(obj, use_bin_type=True)` gives: the
smallest format for every int (unsigned formats for positive values), every
float as float64, str as fixstr/str8/16/32 of its UTF-8 bytes, bytes as
bin8/16/32, tuples as arrays, dicts in their insertion order. Any other
type raises TypeError, as msgpack does: a numpy integer or bool is not
packed. `unpackb` reads every format `packb` writes and float32 too,
returning lists for arrays and dicts for maps.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb"]


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        if v <= 0xFF:
            out.append(b"\xcc" + struct.pack("B", v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + struct.pack(">H", v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + struct.pack(">I", v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + struct.pack(">Q", v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -0x80:
        out.append(b"\xd0" + struct.pack("b", v))
    elif v >= -0x8000:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_length(n: int, fix_tag: int, fix_max: int, tags: Tuple[int, ...],
                 out: List[bytes]) -> None:
    """A container or string header: the fix form below `fix_max`, else
    the 8- (if `tags` has three), 16- or 32-bit length form."""
    if n < fix_max:
        out.append(struct.pack("B", fix_tag | n))
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I")[3 - len(tags):],
                               (0xFF, 0xFFFF, 0xFFFFFFFF)[3 - len(tags):]):
        if n <= limit:
            out.append(struct.pack("B", tag) + struct.pack(fmt, n))
            return
    raise ValueError("object too large to pack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_length(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        if len(data) <= 0xFF:
            out.append(b"\xc4" + struct.pack("B", len(data)))
        elif len(data) <= 0xFFFF:
            out.append(b"\xc5" + struct.pack(">H", len(data)))
        elif len(data) <= 0xFFFFFFFF:
            out.append(b"\xc6" + struct.pack(">I", len(data)))
        else:
            raise ValueError("bytes object too large to pack")
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_length(len(obj), 0x90, 16, (0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_length(len(obj), 0x80, 16, (0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """`msgpack.packb(obj, use_bin_type=True)`."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# Fixed-width formats: tag -> (struct format, size).
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
          0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
          0xD2: (">i", 4), 0xD3: (">q", 8)}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
# Length-prefixed formats: tag -> (kind, length bytes).
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4), 0xD9: ("str", 1),
          0xDA: ("str", 2), 0xDB: ("str", 4), 0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def value(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.container("map", tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.container("array", tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if tag in _FIXED:
            fmt, size = _FIXED[tag]
            return struct.unpack(fmt, self.take(size))[0]
        if tag in _SIZED:
            kind, width = _SIZED[tag]
            n = struct.unpack(_LENGTH[width], self.take(width))[0]
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            return self.container(kind, n)
        raise ValueError(f"unsupported msgpack format 0x{tag:02x}")

    def container(self, kind: str, n: int) -> Any:
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """`msgpack.unpackb(data, raw=False)` for the formats above."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("extra data after the msgpack object")
    return obj
