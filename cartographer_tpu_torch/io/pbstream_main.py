"""pbstream CLI of the PyTorch port: `info` and `migrate`.

Counterpart of the JAX package's `io/pbstream_main.py` (the reference's
io/pbstream_main.cc with internal/pbstream_info.cc and pbstream_migrate.cc),
printing what it prints. `info` reads native and reference-schema streams
on the host. `migrate` rewrites a native v1 stream at version 2 on the host,
and loads a reference-schema stream into a `MapBuilder` (grids on the card,
a v1 stream's submap histograms rebuilt by kernel K12's rotation) and
writes it back at version 2; `--device cpu` runs that load on the plain
PyTorch path.

Usage:
  python -m cartographer_tpu_torch.io.pbstream_main info map.pbstream
  python -m cartographer_tpu_torch.io.pbstream_main migrate old.pbstream new.pbstream
"""

from __future__ import annotations

import argparse
import sys

from cartographer_tpu_torch.io import carto_protos as cp
from cartographer_tpu_torch.io.carto_pbstream import is_carto_stream
from cartographer_tpu_torch.io.msgpack_wire import packb, unpackb
from cartographer_tpu_torch.io.pbstream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.io.proto_wire import decode_message
from cartographer_tpu_torch.io.serialization import SERIALIZATION_FORMAT_VERSION, _migrate_v1


def info(path: str, verbose: bool = False) -> int:
    reader = ProtoStreamReader(path)
    records = list(reader)
    reader.close()
    counts = {}
    version = None
    if records and is_carto_stream(records[0]):
        # A reference-schema pbstream (pbstream_info.cc counts SerializedData
        # cases the same way).
        version = decode_message(cp.SERIALIZATION_HEADER, records[0]).get("format_version")
        print("schema: cartographer proto")
        for r in records[1:]:
            msg = decode_message(cp.SERIALIZED_DATA, r)
            kind = next(iter(msg), "unknown")
            counts[kind] = counts.get(kind, 0) + 1
    else:
        print("schema: cartographer_tpu native")
        for record in records:
            try:
                msg = unpackb(record)
                kind = msg.get("type", "unknown")
                if kind == "header":
                    version = msg.get("format_version")
            except Exception:
                kind = "opaque"
            counts[kind] = counts.get(kind, 0) + 1
    print(f"format_version: {version}")
    for kind in sorted(counts):
        print(f"{kind}: {counts[kind]}")
    return 0


def _migrate_carto(src: str, dst: str, device: str) -> int:
    """Load a reference-schema pbstream (a v1 stream gets the submap
    histograms of serialization_format_migration.cc) and rewrite it at the
    current version."""
    from cartographer_tpu_torch.core.config import MapBuilderOptions
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    reader = ProtoStreamReader(src)
    records = list(reader)
    reader.close()
    version = decode_message(cp.SERIALIZATION_HEADER, records[0]).get("format_version", 0)
    # 2D or 3D from the first submap payload.
    is_3d = False
    for rec in records[1:]:
        msg = decode_message(cp.SERIALIZED_DATA, rec)
        if "submap" in msg:
            is_3d = "submap_3d" in msg["submap"]
            break
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=not is_3d,
                                      use_trajectory_builder_3d=is_3d), device=device)
    mb.load_state(src, load_frozen_state=False)
    mb.serialize_state(dst, include_unfinished_submaps=True, format="carto")
    print(f"migrated carto v{version} -> v2: {dst}")
    return 0


def migrate(src: str, dst: str, device: str = "cuda") -> int:
    reader = ProtoStreamReader(src)
    raw_records = list(reader)
    reader.close()
    if raw_records and is_carto_stream(raw_records[0]):
        return _migrate_carto(src, dst, device)
    records = [unpackb(r) for r in raw_records]
    if not records or records[0].get("type") != "header":
        print("not a cartographer_tpu pbstream", file=sys.stderr)
        return 1
    version = records[0]["format_version"]
    if version == SERIALIZATION_FORMAT_VERSION:
        print("already at current version")
        return 0
    if version == 1:
        records = _migrate_v1(records)
        records[0]["format_version"] = SERIALIZATION_FORMAT_VERSION
    writer = ProtoStreamWriter(dst)
    for r in records:
        writer.write(packb(r))
    writer.close()
    print(f"migrated v{version} -> v{SERIALIZATION_FORMAT_VERSION}: {dst}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pbstream")
    sub = parser.add_subparsers(dest="command", required=True)
    p_info = sub.add_parser("info")
    p_info.add_argument("file")
    p_info.add_argument("--all_debug_strings", action="store_true")
    p_mig = sub.add_parser("migrate")
    p_mig.add_argument("input")
    p_mig.add_argument("output")
    p_mig.add_argument("--device", default="cuda",
                       help="where a reference-schema stream is loaded (cuda or cpu)")
    args = parser.parse_args(argv)
    if args.command == "info":
        return info(args.file, args.all_debug_strings)
    return migrate(args.input, args.output, args.device)


if __name__ == "__main__":
    sys.exit(main())
