"""Probability <-> log-odds encoding for occupancy grids.

Counterpart of the JAX package's `ops/probability.py`
(mapping/probability_values.h): cells hold float32 log-odds clamped to
[logit(0.1), logit(0.9)].
"""

from __future__ import annotations

import math

import torch

MIN_PROBABILITY = 0.1
MAX_PROBABILITY = 1.0 - MIN_PROBABILITY
# Unknown cells score as kMinProbability when matching.
UNKNOWN_PROBABILITY = MIN_PROBABILITY


def logit(p: float) -> float:
    return math.log(p / (1.0 - p))


MIN_LOG_ODDS = logit(MIN_PROBABILITY)
MAX_LOG_ODDS = logit(MAX_PROBABILITY)


def probability_to_log_odds(p: float) -> float:
    """log(p) - log1p(-p) evaluated in float32, as the JAX package does."""
    t = torch.tensor(p, dtype=torch.float32)
    return float(torch.log(t) - torch.log1p(-t))


def log_odds_to_probability(lo: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-lo))


def clamp_log_odds(lo: torch.Tensor) -> torch.Tensor:
    return lo.clamp(MIN_LOG_ODDS, MAX_LOG_ODDS)
