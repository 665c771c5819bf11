"""SE(3) Schur-complement sparse pose adjustment with IMU terms, on one device.

Counterpart of the JAX package's `parallel/schur_spa_3d.py` (l.79-605) with
the mesh of one device: its psums, all_gathers and shard_map are
identities. The normal equations split into reduced slots (submaps,
fixed-frame origins and the per-trajectory IMU blocks: gravity in t[0], the
calibration quaternion in q) and node slots,

    H = [ A   B ]   A: reduced-slot diagonal blocks (S, 6, 6),
        [ B^T T ]   T: node blocks, banded: consecutive-node chains and gyro
                       terms couple (i, i+1), acceleration triplets (i, i+2),
                    B: the reduced-node coupling, one 6x6 block per entry.

Four residual families feed them: binary reduced-node constraints (Huber on
the flagged ones), node-node chains, gyro rotation terms (nodes i, i+1 and a
trajectory slot) and acceleration triplets (nodes i, i+1, i+2 and a
trajectory slot). Each Levenberg-Marquardt iteration masks the frozen
tangent dims, damps the diagonal by lambda |diag| + damping, pairs the nodes
into 12x12 super-blocks (T becomes block-tridiagonal), factors T by block LU,
sweeps the 6S + 1 right-hand sides [B^T | g_n], solves the reduced 6S x 6S
system by Cholesky, retracts (t + d, q exp(d)), clamps the gravity slots to
be non-negative, and accepts a step that is finite and does not raise the
cost; lambda shrinks by 3 or grows by 8 within [1e-8, 1e8].

`solve_spa_3d_schur` runs all iterations in the CUDA kernel
`csrc/schur_spa_3d.cu` (K16) on CUDA tensors, with no host synchronisation
until the caller reads the poses, and the plain twin `solve_plain` on CPU
tensors. The twin solves T by the Thomas chain, as JAX does; the kernel by
block cyclic reduction (`schur_spa.cyclic_reduction_solve` is its plain
form, for the tests), B X by slot without atomics and the reduced system in
one thread-block cluster (both shared with K8, `csrc/schur_reduced.cuh`). Weights are divided by their maximum on the host first (argmin
invariant; the Huber scale rescales with them), as l.577-600 do. N is padded
to an even count with frozen slots.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.spa_3d import (
    acceleration_jacobians_3d,
    acceleration_residual_3d,
    constraint_jacobians_3d,
    constraint_residual_3d,
    rotation_jacobians_3d,
    rotation_residual_3d,
)
from cartographer_tpu_torch.parallel.schur_spa import (
    _MAX_CLUSTER,
    _PANEL,
    cholesky_solve,
    group_by_slot,
    max_pieces,
)
from cartographer_tpu_torch.transform import quaternion as quat

_KERNEL = cuda.CudaKernel(
    "schur_spa_3d.cu", "schur_spa_3d",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])

_EPS = 1e-9  # added to each 12x12 super-block before its inverse (l.326)


@dataclasses.dataclass(frozen=True)
class SchurSpaProblem3D:
    """S reduced slots, N node slots. Binary constraints (C) couple reduced
    slot a_idx with node b_idx; node-node constraints (D) couple j_idx with
    j_idx + 1; gyro rotation terms (R) nodes rot_i, rot_i + 1 and reduced
    slot rot_traj; acceleration triplets (A) nodes acc_i .. acc_i + 2 and
    reduced slot acc_traj. Free masks are per tangent dim."""

    sub_t: torch.Tensor  # (S, 3)
    sub_q: torch.Tensor  # (S, 4)
    node_t: torch.Tensor  # (N, 3)
    node_q: torch.Tensor  # (N, 4)
    sub_free: torch.Tensor  # (S, 6) bool
    node_free: torch.Tensor  # (N, 6) bool
    grav_clamp: torch.Tensor  # (S,) bool: t[0] projected to >= 0 after a step
    a_idx: torch.Tensor  # (C,) int32
    b_idx: torch.Tensor  # (C,) int32
    rel_t: torch.Tensor  # (C, 3)
    rel_q: torch.Tensor  # (C, 4)
    trans_weight: torch.Tensor  # (C,)
    rot_weight: torch.Tensor  # (C,)
    use_huber: torch.Tensor  # (C,) bool
    valid: torch.Tensor  # (C,) bool
    j_idx: torch.Tensor  # (D,) int32
    nn_rel_t: torch.Tensor  # (D, 3)
    nn_rel_q: torch.Tensor  # (D, 4)
    nn_trans_weight: torch.Tensor  # (D,)
    nn_rot_weight: torch.Tensor  # (D,)
    nn_valid: torch.Tensor  # (D,) bool
    rot_i: torch.Tensor  # (R,) int32
    rot_traj: torch.Tensor  # (R,) int32
    rot_delta_q: torch.Tensor  # (R, 4)
    rot_weight_c: torch.Tensor  # (R,)
    rot_valid: torch.Tensor  # (R,) bool
    acc_i: torch.Tensor  # (A,) int32
    acc_traj: torch.Tensor  # (A,) int32
    acc_delta_v: torch.Tensor  # (A, 3)
    acc_dt1: torch.Tensor  # (A,)
    acc_dt2: torch.Tensor  # (A,)
    acc_weight: torch.Tensor  # (A,)
    acc_valid: torch.Tensor  # (A,) bool


WEIGHTS = (("valid", "trans_weight"), ("valid", "rot_weight"), ("nn_valid", "nn_trans_weight"),
           ("nn_valid", "nn_rot_weight"), ("rot_valid", "rot_weight_c"),
           ("acc_valid", "acc_weight"))


def max_weight(p: SchurSpaProblem3D) -> float:
    """The largest valid weight (a host value; reads the weights back)."""
    best = 1e-12
    for valid, weight in WEIGHTS:
        w = torch.where(getattr(p, valid), getattr(p, weight), 0.0)
        if w.numel():
            best = max(best, float(w.max()))
    return best


def normalized(p: SchurSpaProblem3D, wmax: float) -> SchurSpaProblem3D:
    return dataclasses.replace(p, **{w: getattr(p, w) / wmax for _, w in WEIGHTS})


def pad_even(p: SchurSpaProblem3D) -> SchurSpaProblem3D:
    """N padded to an even count with a frozen identity node (l.553-576)."""
    if p.node_t.shape[0] % 2 == 0:
        return p
    return dataclasses.replace(
        p, node_t=torch.cat([p.node_t, p.node_t.new_zeros((1, 3))]),
        node_q=torch.cat([p.node_q, p.node_q.new_tensor([[1.0, 0.0, 0.0, 0.0]])]),
        node_free=torch.cat([p.node_free, p.node_free.new_zeros((1, 6))]))


# ---------------------------------------------------------------- plain twin


def _huber_weights(r, use_huber, valid, huber_scale):
    s2 = torch.sum(r * r, -1)
    hw = torch.where(use_huber & (s2 > huber_scale**2),
                     torch.sqrt(huber_scale / torch.sqrt(torch.clamp(s2, min=1e-18))),
                     torch.ones_like(s2))
    return torch.where(valid, hw, torch.zeros_like(hw))[:, None]


def _mask(valid, r):
    return valid.to(r.dtype)[:, None]


def _acc_dts(p):
    return torch.clamp(p.acc_dt1, min=1e-6), torch.clamp(p.acc_dt2, min=1e-6)


def cost(s_t, s_q, n_t, n_q, p: SchurSpaProblem3D, huber_scale) -> torch.Tensor:
    """The weighted cost of all four families at a state (`_cost_local`)."""
    a, b, j = p.a_idx.long(), p.b_idx.long(), p.j_idx.long()
    r = constraint_residual_3d(s_t[a], s_q[a], n_t[b], n_q[b], p.rel_t, p.rel_q,
                               p.trans_weight, p.rot_weight)
    c = torch.sum((r * _huber_weights(r, p.use_huber, p.valid, huber_scale)) ** 2)
    rn = constraint_residual_3d(n_t[j], n_q[j], n_t[j + 1], n_q[j + 1], p.nn_rel_t, p.nn_rel_q,
                                p.nn_trans_weight, p.nn_rot_weight)
    c = c + torch.sum((rn * _mask(p.nn_valid, rn)) ** 2)
    if p.rot_i.shape[0]:
        i, t = p.rot_i.long(), p.rot_traj.long()
        rr = rotation_residual_3d(n_q[i], n_q[i + 1], p.rot_delta_q, s_q[t], p.rot_weight_c)
        c = c + torch.sum((rr * _mask(p.rot_valid, rr)) ** 2)
    if p.acc_i.shape[0]:
        i, t = p.acc_i.long(), p.acc_traj.long()
        dt1, dt2 = _acc_dts(p)
        ra = acceleration_residual_3d(n_t[i], n_t[i + 1], n_t[i + 2], n_q[i + 1], p.acc_delta_v,
                                      dt1, dt2, p.acc_weight, s_t[t, 0], s_q[t])
        c = c + torch.sum((ra * _mask(p.acc_valid, ra)) ** 2)
    return c


def _outer(x, y):
    return torch.einsum("cri,crj->cij", x, y)


def _jtr(x, r):
    return torch.einsum("cri,cr->ci", x, r)


def assemble(s_t, s_q, n_t, n_q, p: SchurSpaProblem3D, huber_scale):
    """(A (S,6,6), d0/u1/u2 (N,6,6), g_s (S,6), g_n (N,6), Bc (E,6,6),
    ae (E,), be (E,)) before masking and damping (`_assemble_local`,
    l.198-313): u1[i] couples nodes (i, i+1), u2[i] nodes (i, i+2); the
    entries are the binary constraints, then two per gyro term, then three
    per triplet."""
    S, N = s_t.shape[0], n_t.shape[0]
    f = s_t.new_zeros
    A, d0, u1, u2 = f((S, 6, 6)), f((N, 6, 6)), f((N, 6, 6)), f((N, 6, 6))
    g_s, g_n = f((S, 6)), f((N, 6))
    blocks, ae, be = [], [], []

    a, b = p.a_idx.long(), p.b_idx.long()
    if a.shape[0]:
        r, (ja, jb) = constraint_jacobians_3d(s_t[a], s_q[a], n_t[b], n_q[b], p.rel_t,
                                              p.rel_q, p.trans_weight, p.rot_weight)
        w = _huber_weights(r, p.use_huber, p.valid, huber_scale)
        r, ja, jb = r * w, ja * w[:, :, None], jb * w[:, :, None]
        A.index_add_(0, a, _outer(ja, ja))
        d0.index_add_(0, b, _outer(jb, jb))
        g_s.index_add_(0, a, _jtr(ja, r))
        g_n.index_add_(0, b, _jtr(jb, r))
        blocks.append(_outer(ja, jb))
        ae.append(a)
        be.append(b)

    if p.j_idx.shape[0]:
        j = p.j_idx.long()
        k = j + 1
        rn, (jj, jk) = constraint_jacobians_3d(n_t[j], n_q[j], n_t[k], n_q[k], p.nn_rel_t,
                                               p.nn_rel_q, p.nn_trans_weight, p.nn_rot_weight)
        wn = _mask(p.nn_valid, rn)
        rn, jj, jk = rn * wn, jj * wn[:, :, None], jk * wn[:, :, None]
        d0.index_add_(0, j, _outer(jj, jj)).index_add_(0, k, _outer(jk, jk))
        u1.index_add_(0, j, _outer(jj, jk))
        g_n.index_add_(0, j, _jtr(jj, rn)).index_add_(0, k, _jtr(jk, rn))

    if p.rot_i.shape[0]:
        i, t = p.rot_i.long(), p.rot_traj.long()
        rr, (ji, jn, jt) = rotation_jacobians_3d(n_q[i], n_q[i + 1], s_q[t], p.rot_delta_q,
                                                 p.rot_weight_c)
        wr = _mask(p.rot_valid, rr)
        rr, ji, jn, jt = rr * wr, ji * wr[:, :, None], jn * wr[:, :, None], jt * wr[:, :, None]
        d0.index_add_(0, i, _outer(ji, ji)).index_add_(0, i + 1, _outer(jn, jn))
        u1.index_add_(0, i, _outer(ji, jn))
        A.index_add_(0, t, _outer(jt, jt))
        g_n.index_add_(0, i, _jtr(ji, rr)).index_add_(0, i + 1, _jtr(jn, rr))
        g_s.index_add_(0, t, _jtr(jt, rr))
        blocks += [_outer(jt, ji), _outer(jt, jn)]
        ae += [t, t]
        be += [i, i + 1]

    if p.acc_i.shape[0]:
        i, t = p.acc_i.long(), p.acc_traj.long()
        dt1, dt2 = _acc_dts(p)
        ra, (ji, jj, jk, jt) = acceleration_jacobians_3d(
            n_t[i], n_t[i + 1], n_t[i + 2], n_q[i + 1], s_t[t, 0], s_q[t], p.acc_delta_v,
            dt1, dt2, p.acc_weight)
        wa = _mask(p.acc_valid, ra)
        ra = ra * wa
        ji, jj, jk, jt = (x * wa[:, :, None] for x in (ji, jj, jk, jt))
        d0.index_add_(0, i, _outer(ji, ji)).index_add_(0, i + 1, _outer(jj, jj))
        d0.index_add_(0, i + 2, _outer(jk, jk))
        u1.index_add_(0, i, _outer(ji, jj)).index_add_(0, i + 1, _outer(jj, jk))
        u2.index_add_(0, i, _outer(ji, jk))
        A.index_add_(0, t, _outer(jt, jt))
        g_n.index_add_(0, i, _jtr(ji, ra)).index_add_(0, i + 1, _jtr(jj, ra))
        g_n.index_add_(0, i + 2, _jtr(jk, ra))
        g_s.index_add_(0, t, _jtr(jt, ra))
        for jx, off in ((ji, 0), (jj, 1), (jk, 2)):
            blocks.append(_outer(jt, jx))
            ae.append(t)
            be.append(i + off)
    if not blocks:
        return A, d0, u1, u2, g_s, g_n, f((0, 6, 6)), a, b
    return A, d0, u1, u2, g_s, g_n, torch.cat(blocks), torch.cat(ae), torch.cat(be)


def _block_tridiag_factor(Td, To):
    """Block LU of T (lower blocks To^T, 12x12): (Cinv, CinvU), a loop over
    the super-blocks (l.316-331)."""
    n, bs = Td.shape[0], Td.shape[1]
    eye = torch.eye(bs, dtype=Td.dtype, device=Td.device)
    cinv, cinv_u = [], []
    prev = torch.zeros((bs, bs), dtype=Td.dtype, device=Td.device)
    for i in range(n):
        c = Td[i] - (To[i - 1].T @ prev if i > 0 else 0.0)
        ci = torch.linalg.inv_ex(c + _EPS * eye)[0]
        prev = ci @ To[i] if i < n - 1 else torch.zeros_like(ci)
        cinv.append(ci)
        cinv_u.append(prev)
    return torch.stack(cinv), torch.stack(cinv_u)


def _tridiag_solve(Cinv, CinvU, To, rhs):
    """Solve T X = rhs (n, 12, K) with the factors: forward, then backward."""
    n = rhs.shape[0]
    ys, y = [], torch.zeros_like(rhs[0])
    for i in range(n):
        y = Cinv[i] @ (rhs[i] - (To[i - 1].T @ y if i > 0 else 0.0))
        ys.append(y)
    xs, x = [None] * n, torch.zeros_like(rhs[0])
    for i in range(n - 1, -1, -1):
        x = ys[i] - CinvU[i] @ x
        xs[i] = x
    return torch.stack(xs)


def pair_blocks(d0, u1, u2):
    """The node band paired into 12x12 super-blocks (l.427-437): diagonal
    (N/2, 12, 12) and upper (N/2 - 1, 12, 12)."""
    n2 = d0.shape[0] // 2
    d0r, u1r, u2r = (x.reshape(n2, 2, 6, 6) for x in (d0, u1, u2))
    Td = torch.cat([torch.cat([d0r[:, 0], u1r[:, 0]], 2),
                    torch.cat([u1r[:, 0].transpose(1, 2), d0r[:, 1]], 2)], 1)
    To = torch.cat([torch.cat([u2r[:, 0], torch.zeros_like(u2r[:, 0])], 2),
                    torch.cat([u1r[:, 1], u2r[:, 1]], 2)], 1)[:-1]
    return Td, To


def retract(t, q, d):
    return t + d[:, 0:3], quat.normalize(quat.multiply(q, quat.from_axis_angle(d[:, 3:6])))


def solve_plain(p: SchurSpaProblem3D, num_iterations: int, huber_scale: float,
                damping: float, history: Optional[torch.Tensor] = None):
    """The plain twin of K16 on a weight-normalized problem with N even
    (`solve` of `_solver_fn`, l.372-511). `history`, an (iterations, 4)
    tensor where given, takes per iteration the cost at x, the cost at the
    candidate, the accept flag and the new lambda, as the kernel's does."""
    s_t, s_q, n_t, n_q = p.sub_t.clone(), p.sub_q.clone(), p.node_t.clone(), p.node_q.clone()
    S, N = s_t.shape[0], n_t.shape[0]
    dev, dt = s_t.device, s_t.dtype
    sf, nf = p.sub_free.to(dt), p.node_free.to(dt)
    nf1 = torch.cat([nf[1:], nf.new_zeros((1, 6))])
    nf2 = torch.cat([nf[2:], nf.new_zeros((2, 6))])
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    i6 = torch.arange(6, device=dev)
    for it in range(num_iterations):
        A, d0, u1, u2, g_s, g_n, Bc, ae, be = assemble(s_t, s_q, n_t, n_q, p, huber_scale)
        cost0 = cost(s_t, s_q, n_t, n_q, p, huber_scale)
        A = A * sf[:, :, None] * sf[:, None, :]
        d0 = d0 * nf[:, :, None] * nf[:, None, :]
        u1 = u1 * nf[:, :, None] * nf1[:, None, :]
        u2 = u2 * nf[:, :, None] * nf2[:, None, :]
        g_s, g_n = g_s * sf, g_n * nf
        one = torch.ones_like(g_s)
        A = A + torch.diag_embed(torch.where(
            p.sub_free, lam * torch.abs(torch.diagonal(A, dim1=1, dim2=2)) + damping, one))
        d0 = d0 + torch.diag_embed(torch.where(
            p.node_free, lam * torch.abs(torch.diagonal(d0, dim1=1, dim2=2)) + damping,
            torch.ones_like(g_n)))
        Bc = Bc * sf[ae][:, :, None] * nf[be][:, None, :]
        BT = torch.zeros((N, 6, S, 6), dtype=dt, device=dev)
        BT.index_put_((be[:, None, None], i6[None, :, None], ae[:, None, None],
                       i6[None, None, :]), Bc.transpose(1, 2), accumulate=True)
        Td, To = pair_blocks(d0, u1, u2)
        Cinv, CinvU = _block_tridiag_factor(Td, To)
        rhs = torch.cat([BT.reshape(N, 6, 6 * S), g_n[:, :, None]], -1)
        sol = _tridiag_solve(Cinv, CinvU, To, rhs.reshape(N // 2, 12, 6 * S + 1))
        sol = sol.reshape(N, 6, 6 * S + 1)
        X, y = sol[:, :, :6 * S], sol[:, :, 6 * S]
        BX = A.new_zeros((S, 6, 6 * S)).index_add_(0, ae, torch.einsum("cij,cjk->cik", Bc,
                                                                       X[be]))
        By = A.new_zeros((S, 6)).index_add_(0, ae, torch.einsum("cij,cj->ci", Bc, y[be]))
        M = torch.block_diag(*A) - BX.reshape(6 * S, 6 * S)
        dx_s = cholesky_solve(M, -(g_s - By).reshape(6 * S))
        dx_n = -(y + torch.einsum("nik,k->ni", X, dx_s))
        cand_s_t, cand_s_q = retract(s_t, s_q, dx_s.reshape(S, 6) * sf)
        cand_n_t, cand_n_q = retract(n_t, n_q, dx_n * nf)
        cand_s_t = torch.cat([torch.where(p.grav_clamp, torch.clamp(cand_s_t[:, 0], min=0.0),
                                          cand_s_t[:, 0])[:, None], cand_s_t[:, 1:]], 1)
        cost1 = cost(cand_s_t, cand_s_q, cand_n_t, cand_n_q, p, huber_scale)
        accept = torch.isfinite(cost1) & (cost1 <= cost0)
        s_t = torch.where(accept, cand_s_t, s_t)
        s_q = torch.where(accept, cand_s_q, s_q)
        n_t = torch.where(accept, cand_n_t, n_t)
        n_q = torch.where(accept, cand_n_q, n_q)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 8.0), 1e-8, 1e8)
        if history is not None:
            history[it] = torch.stack([cost0, cost1, accept.to(dt), lam])
    return s_t, s_q, n_t, n_q


# ---------------------------------------------------------------- kernel

# The problem's tensors in the order of the pointer table K16 reads.
_FIELDS = (
    ("a_idx", torch.int32, ()), ("b_idx", torch.int32, ()), ("rel_t", torch.float32, (3,)),
    ("rel_q", torch.float32, (4,)), ("trans_weight", torch.float32, ()),
    ("rot_weight", torch.float32, ()), ("use_huber", torch.bool, ()),
    ("valid", torch.bool, ()),
    ("j_idx", torch.int32, ()), ("nn_rel_t", torch.float32, (3,)),
    ("nn_rel_q", torch.float32, (4,)), ("nn_trans_weight", torch.float32, ()),
    ("nn_rot_weight", torch.float32, ()), ("nn_valid", torch.bool, ()),
    ("rot_i", torch.int32, ()), ("rot_traj", torch.int32, ()),
    ("rot_delta_q", torch.float32, (4,)), ("rot_weight_c", torch.float32, ()),
    ("rot_valid", torch.bool, ()),
    ("acc_i", torch.int32, ()), ("acc_traj", torch.int32, ()),
    ("acc_delta_v", torch.float32, (3,)), ("acc_dt1", torch.float32, ()),
    ("acc_dt2", torch.float32, ()), ("acc_weight", torch.float32, ()),
    ("acc_valid", torch.bool, ()),
    ("sub_free", torch.bool, (6,)), ("node_free", torch.bool, (6,)),
    ("grav_clamp", torch.bool, ()))
_COUNT_OF = {"a_idx": "C", "j_idx": "D", "rot_i": "R", "acc_i": "A", "sub_free": "S",
             "node_free": "N", "grav_clamp": "S"}


def workspace_floats(S: int, N: int, E: int) -> int:
    """Float32 workspace K16 carves its buffers from, in the order of the
    `Workspace` and `Band` layout of csrc/schur_spa_3d.cu."""
    K, N2 = 6 * S + 1, N // 2
    zeroed = 36 * S + 3 * 36 * N + 6 * S + 6 * N + 6 * N * K + 36 * S * S + 6 * S
    return (zeroed + 8 + 6 * 144 * N2 + 36 * E + 2 * E + 6 * S + 7 * S + 7 * N
            + _MAX_CLUSTER * _PANEL * (6 * S + 1) + max_pieces(S, E) * 6 * K)


def slot_groups(p: SchurSpaProblem3D):
    """K16's coupling entries (the binary terms, two per gyro term, three per
    triplet, as `assemble` orders them) grouped by reduced slot
    (`schur_spa.group_by_slot`)."""
    slot = torch.cat([p.a_idx, p.rot_traj.repeat_interleave(2),
                      p.acc_traj.repeat_interleave(3)])
    return group_by_slot(slot, p.sub_t.shape[0])


def _solve_kernel(p: SchurSpaProblem3D, num_iterations: int, huber_scale: float,
                  damping: float, history: Optional[torch.Tensor] = None):
    S, N = p.sub_t.shape[0], p.node_t.shape[0]
    counts = {"S": S, "N": N, "C": p.a_idx.shape[0], "D": p.j_idx.shape[0],
              "R": p.rot_i.shape[0], "A": p.acc_i.shape[0]}
    if N % 2:
        raise ValueError("schur_spa_3d: the node count must be even")
    count = "C"
    ptrs = []
    for name, dtype, tail in _FIELDS:
        count = _COUNT_OF.get(name, count)
        t = getattr(p, name)
        cuda.check(t, name, dtype, (counts[count], *tail))
        ptrs.append(t.data_ptr())
    device = p.node_t.device
    state = [x.contiguous().clone() for x in (p.sub_t, p.sub_q, p.node_t, p.node_q)]
    for name, t, width in zip(("sub_t", "sub_q", "node_t", "node_q"), state, (3, 4, 3, 4)):
        cuda.check(t, name, torch.float32, (S if name.startswith("sub") else N, width))
    ptrs += [t.data_ptr() for t in state]
    groups = slot_groups(p)
    ptrs += [t.data_ptr() for t in groups]
    E = counts["C"] + 2 * counts["R"] + 3 * counts["A"]
    ws = workspace_floats(S, N, E)
    workspace = torch.empty(ws, dtype=torch.float32, device=device)
    table = np.asarray(ptrs, np.uint64)
    dims = np.asarray([counts[k] for k in ("S", "N", "C", "D", "R", "A")]
                      + [max_pieces(S, E)], np.int32)
    if history is not None:
        cuda.check(history, "history", torch.float32, (num_iterations, 4))
    _KERNEL(device, table.ctypes.data, dims.ctypes.data, int(num_iterations),
            float(huber_scale), float(damping), workspace.data_ptr(), ws,
            None if history is None else history.data_ptr())
    return tuple(state)


def solve_spa_3d_schur(problem: SchurSpaProblem3D, num_iterations: int = 50,
                       huber_scale: float = 1e1, damping: float = 1e-6,
                       wmax: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (sub_t, sub_q, node_t, node_q) optimized.

    `wmax` is the largest valid weight; the caller that built the problem on
    the host passes it, else it is read back from the problem."""
    if wmax is None:
        wmax = max_weight(problem)
    n0 = problem.node_t.shape[0]
    p = pad_even(normalized(problem, wmax))
    solve = _solve_kernel if p.node_t.is_cuda else solve_plain
    s_t, s_q, n_t, n_q = solve(p, num_iterations, huber_scale / wmax, damping)
    return s_t, s_q, n_t[:n0], n_q[:n0]
