"""pbstream container: the reference's on-disk stream format.

Reference: cartographer/io/proto_stream.cc — a magic u64 (little-endian)
followed by length-prefixed gzip blocks. This implementation is
byte-compatible at the container level (the magic and framing match, so
`pbstream info` can walk real Cartographer files); record payloads are
msgpack-encoded dictionaries (see io/serialization.py) rather than the
reference's protobufs.
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO, Iterator, Optional

MAGIC = 0x7B1D1F7B5BF501DB


class ProtoStreamWriter:
    def __init__(self, fileobj_or_path):
        if isinstance(fileobj_or_path, (str, bytes)):
            self._f: BinaryIO = open(fileobj_or_path, "wb")
            self._owns = True
        else:
            self._f = fileobj_or_path
            self._owns = False
        self._f.write(struct.pack("<Q", MAGIC))

    def write(self, data: bytes) -> None:
        compressed = gzip.compress(data)
        self._f.write(struct.pack("<Q", len(compressed)))
        self._f.write(compressed)

    def close(self) -> None:
        if self._owns:
            self._f.close()


class ProtoStreamReader:
    def __init__(self, fileobj_or_path):
        if isinstance(fileobj_or_path, (str, bytes)):
            self._f: BinaryIO = open(fileobj_or_path, "rb")
            self._owns = True
        else:
            self._f = fileobj_or_path
            self._owns = False
        header = self._f.read(8)
        if len(header) != 8 or struct.unpack("<Q", header)[0] != MAGIC:
            raise ValueError("not a pbstream: bad magic")

    def read(self) -> Optional[bytes]:
        """Next decompressed record, or None at end of stream."""
        header = self._f.read(8)
        if len(header) < 8:
            return None
        (size,) = struct.unpack("<Q", header)
        compressed = self._f.read(size)
        if len(compressed) != size:
            raise EOFError("truncated pbstream record")
        return gzip.decompress(compressed)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            record = self.read()
            if record is None:
                return
            yield record

    def close(self) -> None:
        if self._owns:
            self._f.close()
