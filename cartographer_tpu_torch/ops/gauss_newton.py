"""Levenberg-Marquardt for small pose problems (plain PyTorch).

Counterpart of the JAX package's `ops/gauss_newton.py:lm_solve`, taking the
residuals together with their Jacobian instead of differentiating a
residual function; `retract_fn` and `tangent_dim` carry manifold updates as
in the JAX solver. The JAX while_loop exits early at `function_tolerance`;
here the loop freezes every quantity once converged, which gives the same
result without reading the flag on the host; on the CPU, where reading it
costs nothing, the loop also stops there. The CUDA kernel of the 2D matcher
(csrc/scan_matcher_2d.cu) runs this same loop on the card.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def lm_solve(
    residual_and_jacobian: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    retract_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    tangent_dim: Optional[int] = None,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
    lambda_up: float = 4.0,
    lambda_down: float = 0.5,
    min_diagonal: float = 1e-6,
    function_tolerance: float = 1e-6,
    nonmonotonic: bool = False,
):
    """Minimize 0.5 * ||r(x)||^2 over x.

    x is a flat vector updated by x + delta, or, with `retract_fn(x, delta)`
    (a boxplus on a manifold, e.g. a pose with a quaternion), any tensor;
    the Jacobian is then taken with respect to the `tangent_dim` components
    of delta at delta = 0. Returns (x, final_cost, iterations) as tensors on
    x0's device."""
    if retract_fn is None:
        retract_fn = torch.add
        if tangent_dim is None:
            tangent_dim = x0.shape[-1]
    elif tangent_dim is None:
        raise ValueError("tangent_dim required with a custom retract_fn")

    def cost(x):
        r, _ = residual_and_jacobian(x)
        return 0.5 * torch.sum(r * r)

    x = x0
    lam = torch.full((), init_lambda, dtype=torch.float32, device=x0.device)
    current = cost(x0)
    best_x, best_cost = x0, current
    done = torch.zeros((), dtype=torch.bool, device=x0.device)
    iterations = torch.zeros((), dtype=torch.int32, device=x0.device)
    for _ in range(num_iterations):
        if not x0.is_cuda and bool(done):
            break
        r, jac = residual_and_jacobian(x)
        if jac.shape[-1] != tangent_dim:
            raise ValueError(f"Jacobian has {jac.shape[-1]} columns, expected {tangent_dim}")
        h = jac.T @ jac
        g = jac.T @ r
        damped = h + lam * torch.diag(torch.clamp(torch.diagonal(h), min=min_diagonal))
        delta = -torch.linalg.solve_ex(damped, g)[0]
        x_new = retract_fn(x, delta)
        new_cost = cost(x_new)
        finite = torch.isfinite(delta).all() & torch.isfinite(new_cost)
        improved = (new_cost < current) & finite
        accept = finite if nonmonotonic else improved
        improvement = torch.where(
            improved, (current - new_cost) / torch.clamp(current, min=1e-30),
            torch.ones_like(current))
        live = ~done
        take = live & accept
        x = torch.where(take, x_new, x)
        lam = torch.where(live, torch.where(improved, lam * lambda_down, lam * lambda_up),
                          lam)
        current = torch.where(take, new_cost, current)
        is_best = live & finite & (new_cost < best_cost)
        best_x = torch.where(is_best, x_new, best_x)
        best_cost = torch.where(is_best, new_cost, best_cost)
        iterations = iterations + live.to(torch.int32)
        done = done | (accept & (improvement < function_tolerance) & (improvement >= 0))
    if nonmonotonic:
        return best_x, best_cost, iterations
    return x, current, iterations
