"""Small tensor helpers shared by the port's modules."""

from __future__ import annotations

import numpy as np
import torch


def true_div(x: torch.Tensor, divisor) -> torch.Tensor:
    """x / divisor with IEEE division in x's dtype.

    On CUDA, PyTorch divides by a Python (CPU) scalar as a multiply by its
    reciprocal, which rounds differently from JAX and from the kernels; a
    divisor that lives on x's device takes the true division path."""
    if not isinstance(divisor, torch.Tensor):
        divisor = torch.full((), divisor, dtype=x.dtype, device=x.device)
    return x / divisor


def f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak-typed scalar."""
    return float(np.float32(x))


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """Host numpy -> tensor on `device` without waiting for the copy."""
    array = np.require(array, requirements=["C", "W"])
    return torch.from_numpy(array).to(device, non_blocking=True)


def index_add_in_order_(out: torch.Tensor, lin: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[lin[i]] += values[i] along dim 0, in place, each index's values
    added in input order (the order of XLA's scatter-add on the CPU, and of
    the kernels that sort (index, position) keys): the r-th value of every
    index at once, for r = 0, 1, ..., so that no two adds of one
    `index_add_` meet in an index. Returns `out`."""
    if lin.numel() == 0:
        return out
    order = torch.sort(lin, stable=True).indices
    keys = lin[order]
    pos = torch.arange(keys.shape[0], device=lin.device)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    by_rank = torch.sort(rank, stable=True).indices  # rank-major, then index
    keys, values = keys[by_rank], values[order[by_rank]]
    start = 0
    for end in torch.bincount(rank).cumsum(0).tolist():
        out.index_add_(0, keys[start:end], values[start:end])
        start = end
    return out
