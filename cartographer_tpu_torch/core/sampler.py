"""Deterministic fixed-ratio sampling.

Equivalent of the reference `cartographer/common/fixed_ratio_sampler.{h,cc}`:
`pulse()` returns True for a fixed fraction of calls, deterministically and
evenly spread (the first call always samples, matching the reference which
counts samples/pulses and samples whenever samples/pulses < ratio).
"""

from __future__ import annotations


class FixedRatioSampler:
    def __init__(self, ratio: float):
        if not (0.0 <= ratio <= 1.0):
            raise ValueError(f"ratio must be in [0, 1], got {ratio}")
        self.ratio = ratio
        self.num_pulses = 0
        self.num_samples = 0

    def pulse(self) -> bool:
        self.num_pulses += 1
        if self.num_pulses * self.ratio > self.num_samples:
            self.num_samples += 1
            return True
        return False

    def debug_string(self) -> str:
        if self.num_pulses == 0:
            return "0 (0.00%)"
        return f"{self.num_samples} ({100.0 * self.num_samples / self.num_pulses:.2f}%)"
