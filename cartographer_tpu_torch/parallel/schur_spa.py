"""Schur-complement sparse pose adjustment on one device.

Counterpart of the JAX package's `parallel/schur_spa.py` (l.56-455) with the
mesh of one device: its psums, all_gathers and shard_map are identities. The
SPA normal equations split into submap and node blocks,

    H = [ A   B ]   A: submap diagonal blocks, T: node blocks, tridiagonal
        [ B^T T ]   (consecutive-node terms), B: submap-node coupling,

and each Levenberg-Marquardt iteration solves
(A - B T^-1 B^T) dx_s = -g_s + B T^-1 g_n on the 3S x 3S reduced system
(Cholesky) and dx_n = -(T^-1 g_n + T^-1 B^T dx_s) by one block-Thomas sweep
over the node chain with the 3S + 1 right-hand sides [B^T | g_n]. Huber
IRLS weights apply to the constraints flagged `use_huber`; frozen slots keep
their pose (zero rows and columns, unit diagonal); a step is accepted when it
is finite and does not raise the weighted cost, and lambda shrinks by 3 or
grows by 8 within [1e-8, 1e8].

`solve_spa_2d_schur` runs all iterations in the CUDA kernel
`csrc/schur_spa_2d.cu` (K8) on CUDA tensors, with no host synchronisation
until the caller reads the poses, and the plain twin `solve_plain` on CPU
tensors. Weights are divided by their maximum on the host first (argmin
invariant; the Huber scale rescales with them), as l.428-450 do.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.spa import constraint_jacobians, constraint_residual

_KERNEL = cuda.CudaKernel(
    "schur_spa_2d.cu", "schur_spa_2d",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong])

_EPS = 1e-9  # added to each diagonal block before its 3x3 inverse (l.188)


@dataclasses.dataclass(frozen=True)
class SchurSpaProblem2D:
    """S submap-side slots, N node slots; C submap-node constraints (a_idx in
    [0, S), b_idx in [0, N)); D node-node constraints coupling node j_idx
    with node j_idx + 1."""

    submap_poses: torch.Tensor  # (S, 3) float32
    node_poses: torch.Tensor  # (N, 3) float32
    a_idx: torch.Tensor  # (C,) int32
    b_idx: torch.Tensor  # (C,) int32
    rel: torch.Tensor  # (C, 3)
    trans_weight: torch.Tensor  # (C,)
    rot_weight: torch.Tensor  # (C,)
    use_huber: torch.Tensor  # (C,) bool
    valid: torch.Tensor  # (C,) bool
    j_idx: torch.Tensor  # (D,) int32
    nn_rel: torch.Tensor  # (D, 3)
    nn_trans_weight: torch.Tensor  # (D,)
    nn_rot_weight: torch.Tensor  # (D,)
    nn_valid: torch.Tensor  # (D,) bool
    submap_fixed: torch.Tensor  # (S,) bool
    node_fixed: torch.Tensor  # (N,) bool


def max_weight(p: SchurSpaProblem2D) -> float:
    """The largest valid weight (a host value; reads the weights back)."""
    zero = torch.zeros((), device=p.trans_weight.device)
    parts = [torch.where(p.valid, p.trans_weight, zero), torch.where(p.valid, p.rot_weight, zero),
             torch.where(p.nn_valid, p.nn_trans_weight, zero),
             torch.where(p.nn_valid, p.nn_rot_weight, zero)]
    return max([float(t.max()) for t in parts if t.numel()] + [1e-12])


def normalized(p: SchurSpaProblem2D, wmax: float) -> SchurSpaProblem2D:
    return dataclasses.replace(
        p, trans_weight=p.trans_weight / wmax, rot_weight=p.rot_weight / wmax,
        nn_trans_weight=p.nn_trans_weight / wmax, nn_rot_weight=p.nn_rot_weight / wmax)


# ---------------------------------------------------------------- plain twin


def _huber_weights(r, use_huber, valid, huber_scale):
    s2 = torch.sum(r * r, -1)
    hw = torch.where(use_huber & (s2 > huber_scale**2),
                     torch.sqrt(huber_scale / torch.sqrt(torch.clamp(s2, min=1e-12))),
                     torch.ones_like(s2))
    return torch.where(valid, hw, torch.zeros_like(hw))[:, None]


def _cost(sub, nod, p: SchurSpaProblem2D, huber_scale):
    a, b, j = p.a_idx.long(), p.b_idx.long(), p.j_idx.long()
    r = constraint_residual(sub[a], nod[b], p.rel, p.trans_weight, p.rot_weight)
    r = r * _huber_weights(r, p.use_huber, p.valid, huber_scale)
    rn = constraint_residual(nod[j], nod[torch.clamp(j + 1, max=nod.shape[0] - 1)], p.nn_rel,
                             p.nn_trans_weight, p.nn_rot_weight)
    rn = rn * p.nn_valid.to(rn.dtype)[:, None]
    return torch.sum(r * r) + torch.sum(rn * rn)


def _outer(x, y):
    return torch.einsum("cri,crj->cij", x, y)


def assemble(sub, nod, p: SchurSpaProblem2D, huber_scale):
    """(A, Td, To, g_s, g_n, Bc): submap diagonal blocks (S, 3, 3), node
    diagonal and upper blocks (N, 3, 3), gradients (S, 3), (N, 3), and the
    per-constraint coupling blocks Ja^T Jb (C, 3, 3), before masking and
    damping (`_assemble_local`, l.131)."""
    S, N = sub.shape[0], nod.shape[0]
    a, b, j = p.a_idx.long(), p.b_idx.long(), p.j_idx.long()
    k = torch.clamp(j + 1, max=N - 1)
    pa, pb = sub[a], nod[b]
    r = constraint_residual(pa, pb, p.rel, p.trans_weight, p.rot_weight)
    w = _huber_weights(r, p.use_huber, p.valid, huber_scale)
    r = r * w
    ja, jb = constraint_jacobians(pa, pb, p.trans_weight, p.rot_weight)
    ja, jb = ja * w[:, :, None], jb * w[:, :, None]
    f = sub.new_zeros
    A = f((S, 3, 3)).index_add_(0, a, _outer(ja, ja))
    Td = f((N, 3, 3)).index_add_(0, b, _outer(jb, jb))
    g_s = f((S, 3)).index_add_(0, a, torch.einsum("cri,cr->ci", ja, r))
    g_n = f((N, 3)).index_add_(0, b, torch.einsum("cri,cr->ci", jb, r))
    pj, pk = nod[j], nod[k]
    rn = constraint_residual(pj, pk, p.nn_rel, p.nn_trans_weight, p.nn_rot_weight)
    wn = p.nn_valid.to(rn.dtype)[:, None]
    rn = rn * wn
    jj, jk = constraint_jacobians(pj, pk, p.nn_trans_weight, p.nn_rot_weight)
    jj, jk = jj * wn[:, :, None], jk * wn[:, :, None]
    Td = Td.index_add_(0, j, _outer(jj, jj)).index_add_(0, k, _outer(jk, jk))
    To = f((N, 3, 3)).index_add_(0, j, _outer(jj, jk))
    g_n = (g_n.index_add_(0, j, torch.einsum("cri,cr->ci", jj, rn))
           .index_add_(0, k, torch.einsum("cri,cr->ci", jk, rn)))
    sub_free = (~p.submap_fixed).to(sub.dtype)
    node_free = (~p.node_fixed).to(sub.dtype)
    bw = (sub_free[a] * node_free[b])[:, None, None]
    return A, Td, To, g_s, g_n, _outer(ja * bw, jb)


def _block_tridiag_factor(Td, To):
    """Block LU of T (lower blocks To^T): (Cinv, CinvU), a loop over nodes."""
    N = Td.shape[0]
    eye = torch.eye(3, dtype=Td.dtype, device=Td.device)
    cinv, cinv_u = [], []
    prev = torch.zeros((3, 3), dtype=Td.dtype, device=Td.device)
    for i in range(N):
        c = Td[i] - (To[i - 1].T @ prev if i > 0 else 0.0)
        ci = torch.linalg.inv_ex(c + _EPS * eye)[0]
        prev = ci @ To[i] if i < N - 1 else torch.zeros_like(ci)
        cinv.append(ci)
        cinv_u.append(prev)
    return torch.stack(cinv), torch.stack(cinv_u)


def _tridiag_solve(Cinv, CinvU, To, rhs):
    """Solve T X = rhs (N, 3, K) with the factors: forward, then backward."""
    N = rhs.shape[0]
    ys = []
    y = torch.zeros_like(rhs[0])
    for i in range(N):
        b = rhs[i] - (To[i - 1].T @ y if i > 0 else 0.0)
        y = Cinv[i] @ b
        ys.append(y)
    xs = [None] * N
    x = torch.zeros_like(rhs[0])
    for i in range(N - 1, -1, -1):
        x = ys[i] - CinvU[i] @ x
        xs[i] = x
    return torch.stack(xs)


def reduced_system(A, Bc, X, y, g_s, a_idx, b_idx):
    """(S_red (3S, 3S), rhs (3S,)): A - B T^-1 B^T and -(g_s - B T^-1 g_n)."""
    S = A.shape[0]
    a, b = a_idx.long(), b_idx.long()
    BX = A.new_zeros((S, 3, 3 * S)).index_add_(0, a, torch.einsum("cij,cjk->cik", Bc, X[b]))
    By = A.new_zeros((S, 3)).index_add_(0, a, torch.einsum("cij,cj->ci", Bc, y[b]))
    A_full = torch.block_diag(*A) if S else A.new_zeros((0, 0))
    return A_full - BX.reshape(3 * S, 3 * S), -(g_s - By).reshape(3 * S)


def cholesky_solve(M, rhs):
    """M^-1 rhs by Cholesky; NaN where M is not positive definite, as
    jax.scipy.linalg.cho_factor gives (the step is then rejected)."""
    L, info = torch.linalg.cholesky_ex(M)
    x = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def solve_plain(p: SchurSpaProblem2D, num_iterations: int, huber_scale: float,
                damping: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of K8 on a weight-normalized problem (`solve` of
    `_solver_fn`, l.252-381)."""
    sub, nod = p.submap_poses.clone(), p.node_poses.clone()
    S, N = sub.shape[0], nod.shape[0]
    sub_fixed, node_fixed = p.submap_fixed, p.node_fixed
    sub_free = (~sub_fixed).to(sub.dtype)[:, None]
    node_free = (~node_fixed).to(sub.dtype)[:, None]
    fm_s = sub_free[:, :, None] * sub_free[:, None, :]
    fm_n = node_free[:, :, None] * node_free[:, None, :]
    next_free = torch.cat([node_free[1:], node_free.new_zeros((1, 1))])
    fm_o = node_free[:, :, None] * next_free[:, None, :]  # To_j couples nodes j and j + 1
    lam = torch.tensor(1e-4, dtype=sub.dtype, device=sub.device)
    for _ in range(num_iterations):
        A, Td, To, g_s, g_n, Bc = assemble(sub, nod, p, huber_scale)
        cost0 = _cost(sub, nod, p, huber_scale)
        A, Td, To = A * fm_s, Td * fm_n, To * fm_o
        g_s, g_n = g_s * sub_free, g_n * node_free
        add_s = torch.where(sub_fixed[:, None], torch.ones_like(g_s),
                            lam * torch.abs(torch.diagonal(A, dim1=1, dim2=2)) + damping)
        add_n = torch.where(node_fixed[:, None], torch.ones_like(g_n),
                            lam * torch.abs(torch.diagonal(Td, dim1=1, dim2=2)) + damping)
        A = A + torch.diag_embed(add_s)
        Td = Td + torch.diag_embed(add_n)
        BT = torch.zeros((N, 3, S, 3), dtype=sub.dtype, device=sub.device)
        i3 = torch.arange(3, device=sub.device)
        BT.index_put_((p.b_idx.long()[:, None, None], i3[None, :, None],
                       p.a_idx.long()[:, None, None], i3[None, None, :]),
                      Bc.transpose(1, 2), accumulate=True)
        Cinv, CinvU = _block_tridiag_factor(Td, To)
        sol = _tridiag_solve(Cinv, CinvU, To,
                             torch.cat([BT.reshape(N, 3, 3 * S), g_n[:, :, None]], -1))
        X, y = sol[:, :, :3 * S], sol[:, :, 3 * S]
        M, rhs = reduced_system(A, Bc, X, y, g_s, p.a_idx, p.b_idx)
        dx_s = cholesky_solve(M, rhs)
        dx_n = -(y + torch.einsum("nik,k->ni", X, dx_s))
        cand_sub = sub + dx_s.reshape(S, 3) * sub_free
        cand_nod = nod + dx_n * node_free
        cost1 = _cost(cand_sub, cand_nod, p, huber_scale)
        accept = torch.isfinite(cost1) & (cost1 <= cost0)
        sub = torch.where(accept, cand_sub, sub)
        nod = torch.where(accept, cand_nod, nod)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 8.0), 1e-8, 1e8)
    return sub, nod


# ---------------------------------------------------------------- kernel


def workspace_floats(S: int, N: int, C: int) -> int:
    """Float32 workspace K8 carves its buffers from, in the order of the
    `Workspace` layout of csrc/schur_spa_2d.cu."""
    K = 3 * S + 1
    zeroed = 9 * S + 9 * N + 9 * N + 3 * S + 3 * N + 3 * N * K + 9 * S * S + 3 * S
    return zeroed + 8 + 9 * N + 9 * N + 9 * C + 3 * S + 3 * S + 3 * N


def _solve_kernel(p: SchurSpaProblem2D, num_iterations: int, huber_scale: float,
                  damping: float):
    S, N = p.submap_poses.shape[0], p.node_poses.shape[0]
    C, D = p.a_idx.shape[0], p.j_idx.shape[0]
    for name, t, dtype, shape in (
            ("a_idx", p.a_idx, torch.int32, (C,)), ("b_idx", p.b_idx, torch.int32, (C,)),
            ("rel", p.rel, torch.float32, (C, 3)), ("trans_weight", p.trans_weight,
                                                   torch.float32, (C,)),
            ("rot_weight", p.rot_weight, torch.float32, (C,)),
            ("use_huber", p.use_huber, torch.bool, (C,)), ("valid", p.valid, torch.bool, (C,)),
            ("j_idx", p.j_idx, torch.int32, (D,)), ("nn_rel", p.nn_rel, torch.float32, (D, 3)),
            ("nn_trans_weight", p.nn_trans_weight, torch.float32, (D,)),
            ("nn_rot_weight", p.nn_rot_weight, torch.float32, (D,)),
            ("nn_valid", p.nn_valid, torch.bool, (D,)),
            ("submap_fixed", p.submap_fixed, torch.bool, (S,)),
            ("node_fixed", p.node_fixed, torch.bool, (N,))):
        cuda.check(t, name, dtype, shape)
    device = p.node_poses.device
    sub = p.submap_poses.contiguous().clone()
    nod = p.node_poses.contiguous().clone()
    cuda.check(sub, "submap_poses", torch.float32, (S, 3))
    cuda.check(nod, "node_poses", torch.float32, (N, 3))
    ws = workspace_floats(S, N, C)
    workspace = torch.empty(ws, dtype=torch.float32, device=device)
    _KERNEL(device, sub.data_ptr(), nod.data_ptr(), S, N, p.a_idx.data_ptr(),
            p.b_idx.data_ptr(), p.rel.data_ptr(), p.trans_weight.data_ptr(),
            p.rot_weight.data_ptr(), p.use_huber.data_ptr(), p.valid.data_ptr(), C,
            p.j_idx.data_ptr(), p.nn_rel.data_ptr(), p.nn_trans_weight.data_ptr(),
            p.nn_rot_weight.data_ptr(), p.nn_valid.data_ptr(), D, p.submap_fixed.data_ptr(),
            p.node_fixed.data_ptr(), int(num_iterations), float(huber_scale), float(damping),
            workspace.data_ptr(), ws)
    return sub, nod


def solve_spa_2d_schur(problem: SchurSpaProblem2D, num_iterations: int = 50,
                       huber_scale: float = 1e1, damping: float = 1e-6,
                       wmax: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (submap_poses (S, 3), node_poses (N, 3)) optimized.

    `wmax` is the largest valid weight; the caller that built the problem on
    the host passes it, else it is read back from the problem."""
    if wmax is None:
        wmax = max_weight(problem)
    p = normalized(problem, wmax)
    solve = _solve_kernel if p.node_poses.is_cuda else solve_plain
    return solve(p, num_iterations, huber_scale / wmax, damping)
