"""Lossy point cloud compression for pose-graph node storage.

Reference: sensor/compressed_point_cloud.cc — node clouds held by the pose
graph are block-compressed to ~4 bits/dim. This implementation groups points
into 10 cm blocks and stores 8-bit offsets at ~1/3 mm-class precision
(matching the reference's kPrecision = 0.001 quantization).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PRECISION = 0.001  # meters, reference kPrecision
_BLOCK = 256  # offsets per block edge -> 0.256 m blocks at 1 mm


class CompressedPointCloud:
    """Quantized immutable cloud with iteration/decompression."""

    def __init__(self, points: np.ndarray):
        points = np.asarray(points, np.float64)
        self._num_points = len(points)
        if self._num_points == 0:
            self._block_keys = np.zeros((0, 3), np.int32)
            self._block_starts = np.zeros(0, np.int64)
            self._offsets = np.zeros((0, 3), np.uint8)
            self._order = np.zeros(0, np.int64)
            return
        q = np.round(points / PRECISION).astype(np.int64)
        block = q // _BLOCK
        offset = (q - block * _BLOCK).astype(np.uint8)
        # Sort by block for grouped storage.
        order = np.lexsort((block[:, 2], block[:, 1], block[:, 0]))
        blocks_sorted = block[order]
        new_block = np.any(np.diff(blocks_sorted, axis=0) != 0, axis=1)
        starts = np.concatenate([[0], np.nonzero(new_block)[0] + 1])
        self._block_keys = blocks_sorted[starts].astype(np.int32)
        self._block_starts = starts.astype(np.int32)
        self._offsets = offset[order]
        self._order = order

    def __len__(self) -> int:
        return self._num_points

    def decompress(self) -> np.ndarray:
        """Points in storage order (block-grouped), (n, 3) float64."""
        if self._num_points == 0:
            return np.zeros((0, 3))
        block_of_point = np.zeros(self._num_points, np.int64)
        block_of_point[self._block_starts] = 1
        block_idx = np.cumsum(block_of_point) - 1
        q = (self._block_keys[block_idx].astype(np.int64) * _BLOCK
             + self._offsets.astype(np.int64))
        return q.astype(np.float64) * PRECISION

    def decompress_in_input_order(self) -> np.ndarray:
        out = np.zeros((self._num_points, 3))
        out[self._order] = self.decompress()
        return out

    @property
    def num_bytes(self) -> int:
        return (self._block_keys.nbytes + self._block_starts.nbytes
                + self._offsets.nbytes)

    def to_dict(self) -> dict:
        """Serializable payload (block keys + starts + uint8 offsets)."""
        return {
            "n": self._num_points,
            "keys": self._block_keys.tobytes(),
            "starts": self._block_starts.tobytes(),
            "offsets": self._offsets.tobytes(),
            "order": self._order.astype(np.int32).tobytes(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CompressedPointCloud":
        out = cls.__new__(cls)
        out._num_points = d["n"]
        out._block_keys = np.frombuffer(d["keys"], np.int32).reshape(-1, 3).copy()
        out._block_starts = np.frombuffer(d["starts"], np.int32).copy()
        out._offsets = np.frombuffer(d["offsets"], np.uint8).reshape(-1, 3).copy()
        out._order = np.frombuffer(d["order"], np.int32).astype(np.int64).copy()
        return out


def compress_cloud(points: np.ndarray) -> dict:
    """Compress an (n, 2) or (n, 3) cloud to a serializable dict.

    Used by io/serialization.py for node clouds, matching the reference's
    storage of pose-graph nodes as CompressedPointCloud
    (trajectory_node.h / mapping_state_serialization.cc). 2D clouds are
    embedded at z=0 and the original dimensionality recorded.
    """
    points = np.asarray(points, np.float64)
    dim = points.shape[1] if points.ndim == 2 and len(points) else (
        points.shape[1] if points.ndim == 2 else 3)
    if dim == 2:
        points = np.concatenate([points, np.zeros((len(points), 1))], axis=1)
    d = CompressedPointCloud(points).to_dict()
    d["dim"] = dim
    return d


def decompress_cloud(d: dict) -> np.ndarray:
    """Inverse of compress_cloud, restoring input order and dimensionality."""
    pts = CompressedPointCloud.from_dict(d).decompress_in_input_order()
    return pts[:, : d.get("dim", 3)]


# --- Reference-exact proto stream codec (compressed_point_cloud.cc) ---------

_CARTO_BITS = 10  # kBitsPerCoordinate
_CARTO_MASK = (1 << _CARTO_BITS) - 1


def to_carto_point_data(points: np.ndarray) -> np.ndarray:
    """Encode (n, 3) points as the reference's CompressedPointCloud
    point_data int32 stream (compressed_point_cloud.cc:109-146): per block
    [count, bx, by, bz] then count words (z << 20) + (y << 10) + x of
    block-relative offsets at 1 mm precision. Point order becomes
    block-grouped (the reference iterator also loses input order)."""
    points = np.asarray(points, np.float64)
    if len(points) == 0:
        return np.zeros(0, np.int32)
    raster = np.round(points / PRECISION).astype(np.int64)
    block = raster >> _CARTO_BITS  # arithmetic shift = floor for negatives
    off = (raster & _CARTO_MASK).astype(np.int64)
    order = np.lexsort((block[:, 2], block[:, 1], block[:, 0]))
    bs = block[order]
    offs = off[order]
    new_block = np.concatenate(
        [[True], np.any(np.diff(bs, axis=0) != 0, axis=1)])
    starts = np.nonzero(new_block)[0]
    counts = np.diff(np.concatenate([starts, [len(bs)]]))
    words = (offs[:, 2] << (2 * _CARTO_BITS)) + (offs[:, 1] << _CARTO_BITS) \
        + offs[:, 0]
    out = []
    for s, c in zip(starts, counts):
        out.extend([int(c), int(bs[s, 0]), int(bs[s, 1]), int(bs[s, 2])])
        out.extend(int(w) for w in words[s:s + c])
    return np.asarray(out, np.int32)


def from_carto_point_data(num_points: int, point_data) -> np.ndarray:
    """Decode the reference point_data stream to (num_points, 3) float64."""
    data = np.asarray(point_data, np.int64)
    pts = np.zeros((num_points, 3), np.float64)
    i = 0
    k = 0
    while k < num_points and i < len(data):
        count = int(data[i])
        bx, by, bz = (int(data[i + 1]) << _CARTO_BITS,
                      int(data[i + 2]) << _CARTO_BITS,
                      int(data[i + 3]) << _CARTO_BITS)
        i += 4
        words = data[i:i + count]
        i += count
        pts[k:k + count, 0] = (bx + (words & _CARTO_MASK)) * PRECISION
        pts[k:k + count, 1] = (by + ((words >> _CARTO_BITS) & _CARTO_MASK)) * PRECISION
        pts[k:k + count, 2] = (bz + (words >> (2 * _CARTO_BITS))) * PRECISION
        k += count
    return pts[:k]
