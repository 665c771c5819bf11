"""PCD file reading (ASCII and binary): the port's host copy of the JAX
package's `io/pcd.py:read_pcd`, numpy only. The scan-match testbed
(`io/scan_match_main.py`, after the fork's io/wangtest_main.cc) reads its
two clouds with it."""

from __future__ import annotations

import numpy as np

_NP_TYPES = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 4): "<i4", ("I", 2): "<i2",
             ("I", 1): "<i1", ("U", 4): "<u4", ("U", 2): "<u2", ("U", 1): "<u1"}


def read_pcd(path: str) -> np.ndarray:
    """Read the x/y/z fields of a PCD v0.7 file -> (n, 3) float32."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = list(map(int, header.get("SIZE", "4 4 4").split()))
        types = header.get("TYPE", "F F F").split()
        counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        mode = header["DATA"]

        dtype_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            base = _NP_TYPES[(typ, size)]
            dtype_fields.append((name, base) if count == 1 else (name, base, (count,)))
        dtype = np.dtype(dtype_fields)

        if mode == "ascii":
            rows = np.atleast_2d(np.loadtxt(f, dtype=np.float64, max_rows=n))
            idx = [fields.index(c) for c in ("x", "y", "z")]
            return rows[:, idx].astype(np.float32)
        if mode == "binary":
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            return np.stack([raw["x"], raw["y"], raw["z"]], -1).astype(np.float32)
        raise ValueError(f"unsupported PCD DATA mode {mode!r}")
