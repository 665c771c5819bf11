"""Bicubic (Catmull-Rom) grid interpolation with its analytic gradient.

Counterpart of the JAX package's `ops/interp.py:interp_bicubic`: values sit
at cell centers (cell i at i + 0.5), taps clamp to the grid border. The JAX
package differentiates through the interpolation with jax.jacfwd; here the
gradient is the Catmull-Rom derivative written out, with the floored cell
index carrying no derivative and the fraction carrying it, as under jacfwd.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def catmull_rom_weights(f: torch.Tensor):
    """Cubic Hermite (Catmull-Rom) weights for fraction f in [0, 1)."""
    f2 = f * f
    f3 = f2 * f
    return (0.5 * (-f3 + 2.0 * f2 - f),
            0.5 * (3.0 * f3 - 5.0 * f2 + 2.0),
            0.5 * (-3.0 * f3 + 4.0 * f2 + f),
            0.5 * (f3 - f2))


def catmull_rom_derivatives(f: torch.Tensor):
    """d/df of catmull_rom_weights."""
    f2 = f * f
    return (0.5 * (-3.0 * f2 + 4.0 * f - 1.0),
            0.5 * (9.0 * f2 - 10.0 * f),
            0.5 * (-9.0 * f2 + 8.0 * f + 1.0),
            0.5 * (3.0 * f2 - 2.0 * f))


def bicubic_with_gradient(value_at: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                          shape: Tuple[int, int], coords: torch.Tensor):
    """Bicubic interpolation at `coords` (..., 2) of the grid whose border-
    clamped cell values `value_at(ii, jj)` returns; -> (value (...),
    d value / d coords (..., 2))."""
    s0, s1 = shape
    p = coords - 0.5
    i0 = torch.floor(p[..., 0])
    j0 = torch.floor(p[..., 1])
    fx = p[..., 0] - i0
    fy = p[..., 1] - j0
    i0 = i0.long()
    j0 = j0.long()
    wx, dwx = catmull_rom_weights(fx), catmull_rom_derivatives(fx)
    wy, dwy = catmull_rom_weights(fy), catmull_rom_derivatives(fy)
    taps = torch.arange(-1, 3, device=coords.device)
    ii = (i0[..., None] + taps).clamp(0, s0 - 1)
    jj = (j0[..., None] + taps).clamp(0, s1 - 1)
    g = value_at(ii[..., :, None], jj[..., None, :])  # (..., 4, 4): all 16 taps at once
    # The sums run in the same order as a tap-by-tap loop: over dj within a
    # row, then over the rows di.
    row = torch.zeros_like(g[..., 0])
    drow = torch.zeros_like(g[..., 0])
    for dj in range(4):
        row = row + wy[dj][..., None] * g[..., dj]
        drow = drow + dwy[dj][..., None] * g[..., dj]
    val = torch.zeros_like(fx)
    dfx = torch.zeros_like(fx)
    dfy = torch.zeros_like(fx)
    for di in range(4):
        val = val + wx[di] * row[..., di]
        dfx = dfx + dwx[di] * row[..., di]
        dfy = dfy + wx[di] * drow[..., di]
    return val, torch.stack([dfx, dfy], dim=-1)


def interp_bicubic(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bicubic interpolation of `grid` (S0, S1) at continuous cell
    coordinates `coords` (..., 2)."""
    value, _ = bicubic_with_gradient(lambda ii, jj: grid[ii, jj], grid.shape, coords)
    return value
