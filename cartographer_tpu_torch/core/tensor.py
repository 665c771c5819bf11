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
