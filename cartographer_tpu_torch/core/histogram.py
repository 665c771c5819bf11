"""Text histograms for match-score logging.

Equivalent of the reference `cartographer/common/histogram.{h,cc}`.
"""

from __future__ import annotations

import math
from typing import List


class Histogram:
    def __init__(self) -> None:
        self._values: List[float] = []

    def add(self, value: float) -> None:
        self._values.append(float(value))

    def to_string(self, buckets: int) -> str:
        if buckets <= 0:
            raise ValueError("buckets must be > 0")
        if not self._values:
            return "Count: 0"
        vmin = min(self._values)
        vmax = max(self._values)
        mean = sum(self._values) / len(self._values)
        out = [f"Count: {len(self._values)}  Min: {vmin:f}  Max: {vmax:f}  Mean: {mean:f}"]
        if vmin == vmax:
            return "\n".join(out)
        delta = (vmax - vmin) / buckets
        counts = [0] * buckets
        for v in self._values:
            i = min(buckets - 1, int((v - vmin) / delta))
            counts[i] += 1
        total = len(self._values)
        cum = 0.0
        for i, c in enumerate(counts):
            lo, hi = vmin + i * delta, vmin + (i + 1) * delta
            frac = c / total
            cum += frac
            bar = "#" * int(math.ceil(frac * 20))
            out.append(f"[{lo:f}, {hi:f})\t{cum * 100:5.1f}%\t{bar}")
        return "\n".join(out)
