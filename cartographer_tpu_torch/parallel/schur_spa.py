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
tensors. The twin solves T by the Thomas chain, as JAX does; the kernel by
block cyclic reduction (`cyclic_reduction_solve` is its plain form, for the
tests, and K16's at 12x12), B X by slot without atomics (`group_by_slot`,
shared with K16) and the reduced system in one thread-block cluster (K16's
Cholesky, `csrc/schur_reduced.cuh`). Weights are
divided by their maximum on the host first (argmin invariant; the Huber
scale rescales with them), as l.428-450 do.
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
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])

_REDUCED_CHOLESKY = cuda.CudaKernel(
    "schur_spa_2d.cu", "schur_spa_2d_reduced_cholesky",
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

_EPS = 1e-9  # added to each diagonal block before its 3x3 inverse (l.188)
_PIECE = 64  # coupling entries per piece of the B X reduction (schur_reduced.cuh kPiece)
_MAX_CLUSTER = 16  # blocks of the reduced Cholesky's cluster at most (kMaxCluster)
_PANEL = 32  # columns per panel step of the reduced Cholesky (kPanel)


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


def cyclic_reduction_solve(Td, To, rhs):
    """T X = rhs by block cyclic reduction, level by level in the order of
    the band launches of K8 (3x3 blocks, csrc/schur_spa_2d.cu `Band`) and
    K16 (12x12, csrc/schur_spa_3d.cu); a plain form for the tests, which
    hold it against JAX's Thomas chain. Td (n, b, b), To (n - 1, b, b) the
    upper blocks (the lower are their transposes), rhs (n, b, K) -> X (n, b,
    K).

    While a level (stride s) holds more than one block, its odd blocks j
    are eliminated: Dinv_j = (D_j + 1e-9 I)^-1, G_j = Dinv_j U_{j-s}^T,
    H_j = Dinv_j U_j, y_j = Dinv_j b_j; each even block i takes
    D_i - U_{i-s}^T H_{i-s} - U_i G_{i+s}, b_i - U_{i-s}^T y_{i-s} -
    U_i y_{i+s} and the coupling -U_i H_{i+s} to i + 2s. The last block's y
    is its x; back up the levels x_j = y_j - G_j x_{j-s} - H_j x_{j+s}. U_k
    couples block k to k + s; a block past the end is zero."""
    n, bs = Td.shape[0], Td.shape[1]
    eye = _EPS * torch.eye(bs, dtype=Td.dtype, device=Td.device)
    zero = Td.new_zeros((1, bs, bs))
    D = Td.clone()
    U = torch.cat([To, zero])
    b = rhs.clone()
    G, H = torch.zeros_like(D), torch.zeros_like(D)
    levels = []
    s = 1
    while s < n:
        odd, even = torch.arange(s, n, 2 * s), torch.arange(0, n, 2 * s)
        right = torch.where(odd + s < n, odd + s, 0)
        ur = torch.where((odd + s < n)[:, None, None], U[odd], zero)
        dinv = torch.linalg.inv(D[odd] + eye)
        G[odd] = dinv @ U[odd - s].transpose(1, 2)
        H[odd] = dinv @ ur
        b[odd] = dinv @ b[odd]
        has_l, has_r = even >= s, even + s < n
        jl, jr = torch.where(has_l, even - s, 0), torch.where(has_r, even + s, 0)
        ml, mr = has_l.to(D.dtype)[:, None, None], has_r.to(D.dtype)[:, None, None]
        ul_t = U[jl].transpose(1, 2) * ml
        ui = U[even] * mr
        D[even] = D[even] - ul_t @ H[jl] - ui @ G[jr]
        b[even] = b[even] - ul_t @ b[jl] - ui @ b[jr]
        U[even] = -(ui @ H[jr])
        levels.append((s, odd, right))
        s *= 2
    b[0] = torch.linalg.inv(D[0] + eye) @ b[0]
    for s, odd, right in reversed(levels):
        b[odd] = b[odd] - G[odd] @ b[odd - s] - H[odd] @ b[right]
    return b


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
                damping: float, history: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of K8 on a weight-normalized problem (`solve` of
    `_solver_fn`, l.252-381). `history`, an (iterations, 4) tensor where
    given, takes per iteration the cost at x, the cost at the candidate, the
    accept flag and the new lambda, as the kernel's does."""
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
    for it in range(num_iterations):
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
        if history is not None:
            history[it] = torch.stack([cost0, cost1, accept.to(sub.dtype), lam])
    return sub, nod


# ---------------------------------------------------------------- kernel


def max_pieces(S: int, E: int) -> int:
    """The pieces of _PIECE entries that grouping E coupling entries by S
    slots makes, at most."""
    return -(-E // _PIECE) + S if E else 0


def group_by_slot(slot: torch.Tensor, S: int):
    """Coupling entries grouped by reduced slot for the B X reduction of K8
    and K16, on the entries' device with no host synchronisation: `slot`
    (E,) each entry's slot in [0, S) -> (order (E,), slot_start (S + 1,),
    piece_start (S + 1,)) int32, the entries by slot in their own order,
    and each slot's first position and first piece of _PIECE."""
    slot = slot.long()
    order = torch.argsort(slot, stable=True)
    counts = torch.zeros(S, dtype=torch.int64, device=slot.device).index_add_(
        0, slot, torch.ones_like(slot))
    zero = counts.new_zeros(1)
    pieces = (counts + _PIECE - 1) // _PIECE
    return tuple(x.to(torch.int32).contiguous() for x in (
        order, torch.cat([zero, counts.cumsum(0)]), torch.cat([zero, pieces.cumsum(0)])))


def workspace_floats(S: int, N: int, C: int) -> int:
    """Float32 workspace K8 carves its buffers from, in the order of the
    `Workspace` and `Band` layout of csrc/schur_spa_2d.cu."""
    K = 3 * S + 1
    zeroed = 9 * S + 9 * N + 9 * N + 3 * S + 3 * N + 3 * N * K + 9 * S * S + 3 * S
    return (zeroed + 8 + 6 * 9 * N + 9 * C + 2 * C + 3 * S + 3 * S + 3 * N
            + _MAX_CLUSTER * _PANEL * (3 * S + 1) + max_pieces(S, C) * 3 * K)


def _solve_kernel(p: SchurSpaProblem2D, num_iterations: int, huber_scale: float,
                  damping: float, history: Optional[torch.Tensor] = None):
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
    order, slot_start, piece_start = group_by_slot(p.a_idx, S)
    ws = workspace_floats(S, N, C)
    workspace = torch.empty(ws, dtype=torch.float32, device=device)
    if history is not None:
        cuda.check(history, "history", torch.float32, (num_iterations, 4))
    _KERNEL(device, sub.data_ptr(), nod.data_ptr(), S, N, p.a_idx.data_ptr(),
            p.b_idx.data_ptr(), p.rel.data_ptr(), p.trans_weight.data_ptr(),
            p.rot_weight.data_ptr(), p.use_huber.data_ptr(), p.valid.data_ptr(), C,
            p.j_idx.data_ptr(), p.nn_rel.data_ptr(), p.nn_trans_weight.data_ptr(),
            p.nn_rot_weight.data_ptr(), p.nn_valid.data_ptr(), D, p.submap_fixed.data_ptr(),
            p.node_fixed.data_ptr(), order.data_ptr(), slot_start.data_ptr(),
            piece_start.data_ptr(), max_pieces(S, C), int(num_iterations), float(huber_scale),
            float(damping), workspace.data_ptr(), ws,
            None if history is None else history.data_ptr())
    return sub, nod


def reduced_cholesky_solve(P: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P^-1 b by the reduced-system Cholesky of K8 and K16 alone
    (`csrc/schur_reduced.cuh`, as an iteration runs it: a cluster of a
    block per 24 rows or so) for a symmetric positive definite P (n, n) on
    the card; NaN where P is not positive definite. For the card's tests and
    timings: the solves run it inside their own launches."""
    n = P.shape[0]
    if tuple(P.shape) != (n, n) or tuple(b.shape) != (n,):
        raise ValueError(f"reduced_cholesky_solve: P {tuple(P.shape)}, b {tuple(b.shape)}")
    cuda.check(P, "P", torch.float32)
    cuda.check(b, "b", torch.float32)
    system = torch.cat([-P, b[None]]).contiguous()
    zeros = P.new_zeros(2 * n)
    panels = P.new_empty(_MAX_CLUSTER * _PANEL * (n + 1))
    x = P.new_empty(n)
    _REDUCED_CHOLESKY(P.device, n, system.data_ptr(), zeros.data_ptr(),
                      panels.data_ptr(), x.data_ptr())
    return x


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
