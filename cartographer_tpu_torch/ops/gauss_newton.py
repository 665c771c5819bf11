"""Levenberg-Marquardt for small pose problems (plain PyTorch).

Counterpart of the JAX package's `ops/gauss_newton.py:lm_solve`, taking the
residuals together with their Jacobian instead of differentiating a
residual function. The JAX while_loop exits early at `function_tolerance`;
here the loop runs `num_iterations` times and freezes every quantity once
converged, which gives the same result without reading the flag on the
host. The CUDA kernel of the 2D matcher (csrc/scan_matcher_2d.cu) runs this
same loop on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def lm_solve(
    residual_and_jacobian: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
    lambda_up: float = 4.0,
    lambda_down: float = 0.5,
    min_diagonal: float = 1e-6,
    function_tolerance: float = 1e-6,
    nonmonotonic: bool = False,
):
    """Minimize 0.5 * ||r(x)||^2 over the flat vector x.

    Returns (x, final_cost, iterations) as tensors on x0's device."""

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
        r, jac = residual_and_jacobian(x)
        h = jac.T @ jac
        g = jac.T @ r
        damped = h + lam * torch.diag(torch.clamp(torch.diagonal(h), min=min_diagonal))
        delta = -torch.linalg.solve_ex(damped, g)[0]
        x_new = x + delta
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
