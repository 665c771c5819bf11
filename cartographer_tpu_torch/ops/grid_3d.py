"""Dense 3D occupancy grid: the window the 3D matcher reads.

Counterpart of `Grid3D` in the JAX package's `ops/grid_3d.py`: a cubic
log-odds volume with a known mask; cell (i, j, k) covers
[origin + idx * resolution, + resolution). The port fills it by cropping a
paged grid (`ops/paged_grid_3d.py:crop_dense`); the dense inserter and the
intensity grid of the JAX module are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cartographer_tpu_torch.core.tensor import to_device, true_div
from cartographer_tpu_torch.ops.probability import UNKNOWN_PROBABILITY, log_odds_to_probability


@dataclasses.dataclass(frozen=True)
class Grid3D:
    log_odds: torch.Tensor  # (S, S, S) float32
    known: torch.Tensor  # (S, S, S) bool
    origin: torch.Tensor  # (3,) float32
    resolution: float

    @staticmethod
    def create(size: int, resolution: float, center, device) -> "Grid3D":
        origin = np.asarray(center, np.float32) - np.float32(0.5 * size * resolution)
        return Grid3D(
            log_odds=torch.zeros((size, size, size), dtype=torch.float32, device=device),
            known=torch.zeros((size, size, size), dtype=torch.bool, device=device),
            origin=to_device(origin.astype(np.float32), device), resolution=float(resolution))

    @property
    def size(self) -> int:
        return self.log_odds.shape[0]

    def world_to_cell_continuous(self, points: torch.Tensor) -> torch.Tensor:
        return true_div(points - self.origin, self.resolution)

    def world_to_cell(self, points: torch.Tensor) -> torch.Tensor:
        return torch.floor(self.world_to_cell_continuous(points)).to(torch.int32)

    def probability_at(self, ii, jj, kk) -> torch.Tensor:
        """Probability of the cells (ii, jj, kk): UNKNOWN where not known."""
        lo = self.log_odds[ii, jj, kk]
        return torch.where(self.known[ii, jj, kk], log_odds_to_probability(lo),
                           torch.full_like(lo, UNKNOWN_PROBABILITY))

    def probability(self) -> torch.Tensor:
        return torch.where(self.known, log_odds_to_probability(self.log_odds),
                           torch.full_like(self.log_odds, UNKNOWN_PROBABILITY))
