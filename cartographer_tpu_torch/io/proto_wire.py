"""Minimal protobuf wire-format codec (no generated code, no runtime dep).

Implements the subset of the proto3 encoding needed for interop with the
reference's `.pbstream` payloads (cartographer/mapping/proto/*.proto):
varint / zigzag / fixed64 / fixed32 scalars, length-delimited bytes and
sub-messages, repeated fields (packed and unpacked on decode; packed on
encode for scalars), and enums as ints.

Messages are plain dicts; schemas are declarative tables:

    SCHEMA = {field_number: (name, kind)}           # singular
             {field_number: (name, kind, "repeated")}

kinds: "int32"/"int64"/"uint32"/"uint64"/"bool"/"enum" (varint),
"sint32"/"sint64" (zigzag varint), "double" (fixed64), "float" (fixed32),
"bytes"/"string", or a nested schema dict (sub-message).

Decoding skips unknown fields (forward compatible); proto3 default values
are omitted on encode, and missing fields decode to their defaults via
`dict.get`.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple, Union

Kind = Union[str, Dict[int, tuple]]

_WT_VARINT = 0
_WT_FIXED64 = 1
_WT_LEN = 2
_WT_FIXED32 = 5

_VARINT_KINDS = {"int32", "int64", "uint32", "uint64", "bool", "enum"}
_ZIGZAG_KINDS = {"sint32", "sint64"}


def encode_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # negative int32/int64 encode as 10-byte varints
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _zigzag_encode(value: int) -> int:
    return (value << 1) ^ (value >> 63)


def _zigzag_decode(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def _to_signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _to_signed32(value: int) -> int:
    value &= 0xFFFFFFFFFFFFFFFF
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= (1 << 31) else value


def _encode_scalar(kind: str, value: Any) -> Tuple[int, bytes]:
    """Returns (wire_type, payload)."""
    if kind in _VARINT_KINDS:
        return _WT_VARINT, encode_varint(int(value))
    if kind in _ZIGZAG_KINDS:
        return _WT_VARINT, encode_varint(_zigzag_encode(int(value)))
    if kind == "double":
        return _WT_FIXED64, struct.pack("<d", float(value))
    if kind == "float":
        return _WT_FIXED32, struct.pack("<f", float(value))
    if kind == "string":
        data = value.encode() if isinstance(value, str) else bytes(value)
        return _WT_LEN, encode_varint(len(data)) + data
    if kind == "bytes":
        data = bytes(value)
        return _WT_LEN, encode_varint(len(data)) + data
    raise ValueError(f"unknown scalar kind {kind}")


def _is_default(kind: Kind, value: Any) -> bool:
    if isinstance(kind, dict):
        return value is None
    if kind in ("string", "bytes"):
        return len(value) == 0
    return not value


def encode_message(schema: Dict[int, tuple], msg: Dict[str, Any]) -> bytes:
    out = bytearray()
    for num in sorted(schema):
        entry = schema[num]
        name, kind = entry[0], entry[1]
        repeated = len(entry) > 2 and entry[2] == "repeated"
        if name not in msg:
            continue
        value = msg[name]
        if repeated:
            values = list(value)
            if not values:
                continue
            if isinstance(kind, dict):
                for v in values:
                    body = encode_message(kind, v)
                    out += encode_varint((num << 3) | _WT_LEN)
                    out += encode_varint(len(body)) + body
            elif kind in ("string", "bytes"):
                for v in values:
                    wt, payload = _encode_scalar(kind, v)
                    out += encode_varint((num << 3) | wt)
                    out += payload
            else:
                # Packed repeated scalars (proto3 default).
                packed = bytearray()
                for v in values:
                    _, payload = _encode_scalar(kind, v)
                    packed += payload
                out += encode_varint((num << 3) | _WT_LEN)
                out += encode_varint(len(packed)) + bytes(packed)
        else:
            if _is_default(kind, value):
                continue
            if isinstance(kind, dict):
                body = encode_message(kind, value)
                out += encode_varint((num << 3) | _WT_LEN)
                out += encode_varint(len(body)) + body
            else:
                wt, payload = _encode_scalar(kind, value)
                out += encode_varint((num << 3) | wt)
                out += payload
    return bytes(out)


def _decode_scalar(kind: str, wire_type: int, buf: bytes, pos: int):
    if wire_type == _WT_VARINT:
        raw, pos = decode_varint(buf, pos)
        if kind in _ZIGZAG_KINDS:
            return _zigzag_decode(raw), pos
        if kind == "bool":
            return bool(raw), pos
        if kind in ("int32", "enum"):
            return _to_signed32(_to_signed64(raw)), pos
        if kind == "int64":
            return _to_signed64(raw), pos
        return raw, pos
    if wire_type == _WT_FIXED64:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if wire_type == _WT_FIXED32:
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    raise ValueError(f"scalar kind {kind} with wire type {wire_type}")


def _skip(wire_type: int, buf: bytes, pos: int) -> int:
    if wire_type == _WT_VARINT:
        _, pos = decode_varint(buf, pos)
        return pos
    if wire_type == _WT_FIXED64:
        return pos + 8
    if wire_type == _WT_LEN:
        length, pos = decode_varint(buf, pos)
        return pos + length
    if wire_type == _WT_FIXED32:
        return pos + 4
    raise ValueError(f"cannot skip wire type {wire_type}")


def decode_message(schema: Dict[int, tuple], buf: bytes,
                   start: int = 0, end: int = None) -> Dict[str, Any]:
    msg: Dict[str, Any] = {}
    pos = start
    end = len(buf) if end is None else end
    while pos < end:
        tag, pos = decode_varint(buf, pos)
        num = tag >> 3
        wire_type = tag & 7
        entry = schema.get(num)
        if entry is None:
            pos = _skip(wire_type, buf, pos)
            continue
        name, kind = entry[0], entry[1]
        repeated = len(entry) > 2 and entry[2] == "repeated"
        if isinstance(kind, dict):
            length, pos = decode_varint(buf, pos)
            value = decode_message(kind, buf, pos, pos + length)
            pos += length
            if repeated:
                msg.setdefault(name, []).append(value)
            else:
                msg[name] = value
        elif kind in ("string", "bytes"):
            length, pos = decode_varint(buf, pos)
            raw = buf[pos:pos + length]
            pos += length
            value = raw.decode() if kind == "string" else bytes(raw)
            if repeated:
                msg.setdefault(name, []).append(value)
            else:
                msg[name] = value
        elif repeated and wire_type == _WT_LEN:
            # Packed repeated scalars.
            length, pos = decode_varint(buf, pos)
            sub_end = pos + length
            values: List[Any] = msg.setdefault(name, [])
            inner_wt = (_WT_FIXED64 if kind == "double"
                        else _WT_FIXED32 if kind == "float" else _WT_VARINT)
            while pos < sub_end:
                v, pos = _decode_scalar(kind, inner_wt, buf, pos)
                values.append(v)
        else:
            value, pos = _decode_scalar(kind, wire_type, buf, pos)
            if repeated:
                msg.setdefault(name, []).append(value)
            else:
                msg[name] = value
    return msg
