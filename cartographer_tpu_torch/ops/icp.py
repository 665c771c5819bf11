"""ICP, GICP and NDT scan matching: the fork's alternative matchers.

Counterpart of the JAX package's `ops/icp.py` (the fork's PCL-based
icp_match path and the pclomp GICP and NDT stand-ins).

Point-to-point ICP (`icp_match`): each round pairs every source point,
moved by the current pose, with its nearest target by brute force over the
dense distance matrix in the reference's form |a|^2 + |b|^2 - 2 a.b (kept as
it is: parity depends on it, though it loses some 2e-4 m^2 at 60 m ranges
and can go slightly negative), then takes the Kabsch rotation of the
weighted cross-covariance and composes it on the left of the pose. On CUDA
tensors its rounds run on the device with no host sync: K23
(`csrc/icp.cu` `icp_nearest`) finds the correspondences and K24
(`icp_kabsch`) updates a 7-float pose buffer [t, q] in place; a last K23
and K24's `icp_stats` give the fitness and the RMSE. Both sum the point
axis as the same pairwise halving tree; the twin's 3x3 SVD is
`torch.linalg.svd` in float64, K24's one-sided Jacobi sweeps in double.

GICP (`gicp_match`): the target's normals from its 10 nearest neighbours
(`estimate_normals`, K26 `csrc/gicp.cu` `icp_normals`), then
`max_iterations // 5` rounds of K23's correspondences, each followed by a
10-iteration SE(3) Levenberg-Marquardt solve on the point-to-plane
residuals (K27 `gicp_lm`, on the same pose buffer), and K23 and
`icp_stats` for the fitness and the RMSE.

NDT (`ndt_match`): per-voxel Gaussians of the target on a g^3 grid around
its masked mean (`build_ndt_grid`, K28 `csrc/ndt.cu` `ndt_grid`), then one
SE(3) Levenberg-Marquardt solve on the whitened point-to-mean residuals
(K29 `ndt_lm`).

CPU tensors run the plain twins (`*_plain`); CUDA tensors launch the
kernels. The twins' neighbour lists break distance ties by the lower
index, as lax.top_k; their eigenvectors, inverses and Cholesky factors are
taken in float64, as the kernels take them, and each normal's largest
component is made positive in both (eigh's sign is LAPACK's choice).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from cartographer_tpu_torch.core.tensor import f32, index_add_in_order_, true_div
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.correlative_2d import tree_sum
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.scan_matcher_3d import se3_retract
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid3

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_NEAREST = cuda.CudaKernel("icp.cu", "icp_nearest",
                           [_P, _P, _I, _P, _P, _I, _P, _F, _P, _P, _P])
_KABSCH = cuda.CudaKernel("icp.cu", "icp_kabsch", [_P, _P, _P, _P, _I, _P, _P])
_STATS = cuda.CudaKernel("icp.cu", "icp_stats", [_P, _P, _P, _P, _P, _I, _P])
_NORMALS = cuda.CudaKernel("gicp.cu", "icp_normals", [_P, _P, _I, _I, _P, _P])
_GICP_LM = cuda.CudaKernel("gicp.cu", "gicp_lm",
                           [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F])
_NDT_GRID = cuda.CudaKernel("ndt.cu", "ndt_grid",
                            [_P, _P, _I, _P, _F, _I, _F, _F, _P, _P, _P, _P])
_NDT_LM = cuda.CudaKernel("ndt.cu", "ndt_lm",
                          [_P, _P, _I, _P, _P, _P, _P, _F, _I, _P, _I, _F, _P, _P, _P])

_ROWS = 1024  # source rows per block of the twin's distance matrix
_IDENTITY = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)
_MAX_NEIGHBOURS = 16  # K26 keeps its neighbour list in registers
_FUNCTION_TOLERANCE = 1e-6  # lm_solve's default, which GICP and NDT take


@dataclasses.dataclass(frozen=True)
class IcpParams:
    max_iterations: int = 30
    max_correspondence_distance: float = 1.0
    convergence: float = 1e-6  # kept for config parity (iterations are fixed)


def _sq_norm(a: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) + a[..., 2] * a[..., 2]


def _pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) squared distances |a|^2 + |b|^2 - 2 a.b, elementwise (not a
    matrix product), each sum left to right, as K23 computes them."""
    cross = ((a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1])
             + a[:, None, 2] * b[None, :, 2])
    return (_sq_norm(a)[:, None] + _sq_norm(b)[None, :]) - 2.0 * cross


def transform_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Points (N, 3) moved by the pose vector [t, q] (7,), in K23's order."""
    return quat.rotate_expanded(pose[3:7], points) + pose[0:3]


def _check_clouds(source, source_mask, target, target_mask):
    n, m = source.shape[0], target.shape[0]
    cuda.check(source, "source", torch.float32, (n, 3))
    cuda.check(source_mask, "source mask", torch.bool, (n,))
    cuda.check(target, "target", torch.float32, (m, 3))
    cuda.check(target_mask, "target mask", torch.bool, (m,))
    if n < 1 or m < 1:
        raise ValueError("icp: both clouds need at least one point")
    return n, m


# ---------------------------------------------------------------- K23


def nearest_plain(source, source_mask, target, target_mask, pose: torch.Tensor,
                  max_dist: float):
    """The plain twin of K23: -> (nn (N,) int32, world (N, 3), valid (N,)).
    The first of equal minima wins, as jnp.argmin; masked targets are +inf."""
    world = transform_points(pose, source)
    nn, nn_d2 = [], []
    inf = torch.full((), float("inf"), device=source.device)
    for r in range(0, source.shape[0], _ROWS):
        d2 = torch.where(target_mask[None, :], _pairwise_sq_dist(world[r:r + _ROWS], target),
                         inf)
        i = torch.argmin(d2, dim=1)
        nn.append(i)
        nn_d2.append(d2.gather(1, i[:, None])[:, 0])
    nn_d2 = torch.cat(nn_d2)
    valid = source_mask & (nn_d2 <= f32(max_dist ** 2)) & torch.isfinite(nn_d2)
    return torch.cat(nn).to(torch.int32), world, valid


def nearest(source, source_mask, target, target_mask, pose: torch.Tensor, max_dist: float):
    """Each source point moved by `pose` [t, q] (7,) and its nearest
    unmasked target: -> (nn (N,) int32, world (N, 3), valid (N,)), valid
    where the source point is masked in and its match lies within
    `max_dist`."""
    if not source.is_cuda:
        return nearest_plain(source, source_mask, target, target_mask, pose, max_dist)
    n, m = _check_clouds(source, source_mask, target, target_mask)
    cuda.check(pose, "pose", torch.float32, (7,))
    dev = source.device
    nn = torch.empty(n, dtype=torch.int32, device=dev)
    world = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    _NEAREST(dev, source.data_ptr(), source_mask.data_ptr(), n, target.data_ptr(),
             target_mask.data_ptr(), m, pose.data_ptr(), f32(max_dist ** 2), nn.data_ptr(),
             world.data_ptr(), valid.data_ptr())
    return nn, world, valid


def _correspondences(src_world, src_mask, target, target_mask, max_dist):
    """The JAX signature: the source already in the target's frame ->
    (nn, valid)."""
    identity = torch.tensor(_IDENTITY, dtype=torch.float32, device=src_world.device)
    nn, _, valid = nearest(src_world, src_mask, target, target_mask, identity, max_dist)
    return nn, valid


# ---------------------------------------------------------------- K24


def _padded(x: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (K, P) with zero columns up to the power of two P >= N."""
    n = x.shape[-1]
    return F.pad(x, (0, (1 << max(n - 1, 0).bit_length()) - n))


def _rotation_matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Matrix -> quaternion (w, x, y, z): of the four candidates the one with
    the largest diagonal term (the first of equal ones), normalized."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = (m00 + m11) + m22
    floor = torch.full((), 1e-12, dtype=R.dtype, device=R.device)
    qw = torch.sqrt(torch.maximum(1.0 + tr, floor)) / 2
    qx = torch.sqrt(torch.maximum(((1.0 + m00) - m11) - m22, floor)) / 2
    qy = torch.sqrt(torch.maximum(((1.0 - m00) + m11) - m22, floor)) / 2
    qz = torch.sqrt(torch.maximum(((1.0 - m00) - m11) + m22, floor)) / 2
    case = torch.argmax(torch.stack([qw, qx, qy, qz]))
    q = torch.stack([
        torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)]),
        torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)]),
        torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)]),
        torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz]),
    ])[case]
    return q / torch.sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3])


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """R = V diag(1, 1, sign det(V U^T)) U^T of H = U S V^T (float64 SVD,
    the result in H's dtype); sign 0 at a zero determinant, as jnp.sign."""
    U, _, Vh = torch.linalg.svd(H.double())
    V = Vh.T
    d = torch.sign(torch.linalg.det(V @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    return (V @ D @ U.T).to(H.dtype)


def kabsch_plain(world, target, nn, valid, pose: torch.Tensor):
    """The plain twin of K24: one round's update -> (new pose (7,), R (3, 3),
    t (3,)) from the correspondences (nn, valid) of the moved source `world`."""
    matched = target[nn.long()]
    w = valid.to(torch.float32)
    first = tree_sum(_padded(torch.cat([w[None], (world * w[:, None]).T,
                                        (matched * w[:, None]).T])))
    wsum = torch.clamp(first[0], min=1.0)
    mu_s, mu_t = first[1:4] / wsum, first[4:7] / wsum
    h = ((world - mu_s) * w[:, None])[:, :, None] * (matched - mu_t)[:, None, :]
    H = tree_sum(_padded(h.reshape(-1, 9).T)).reshape(3, 3)
    R = kabsch_rotation(H)
    t = mu_t - ((R[:, 0] * mu_s[0] + R[:, 1] * mu_s[1]) + R[:, 2] * mu_s[2])
    q = _rotation_matrix_to_quat(R)
    moved = quat.rotate_expanded(q, pose[0:3]) + t
    mq = quat.multiply(q, pose[3:7])
    mq = mq / torch.sqrt(((mq[0] * mq[0] + mq[1] * mq[1]) + mq[2] * mq[2]) + mq[3] * mq[3])
    return torch.cat([moved, mq]), R, t


def kabsch(world, target, nn, valid, pose: torch.Tensor):
    """One round's Kabsch update of the pose vector: -> (new pose (7,), R
    (3, 3), t (3,)), the left factor delta = (R, t) of new = delta * pose."""
    if not world.is_cuda:
        return kabsch_plain(world, target, nn, valid, pose)
    n, m = world.shape[0], target.shape[0]
    cuda.check(world, "world", torch.float32, (n, 3))
    cuda.check(target, "target", torch.float32, (m, 3))
    cuda.check(nn, "nn", torch.int32, (n,))
    cuda.check(valid, "valid", torch.bool, (n,))
    cuda.check(pose, "pose", torch.float32, (7,))
    out = pose.clone()
    rt = torch.empty(12, dtype=torch.float32, device=world.device)
    _KABSCH(world.device, world.data_ptr(), target.data_ptr(), nn.data_ptr(), valid.data_ptr(),
            n, out.data_ptr(), rt.data_ptr())
    return out, rt[0:9].reshape(3, 3), rt[9:12]


def stats_plain(world, source_mask, target, nn, valid):
    """-> (fitness, rmse): the inlier share of the masked source and the RMS
    of the direct distances |world - target[nn]| over the inliers."""
    e = world - target[nn.long()]
    zero = torch.zeros((), dtype=torch.float32, device=world.device)
    sums = tree_sum(_padded(torch.stack([
        torch.where(valid, (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2], zero),
        valid.to(torch.float32), source_mask.to(torch.float32)])))
    return sums[1] / torch.clamp(sums[2], min=1.0), torch.sqrt(sums[0] / torch.clamp(sums[1],
                                                                                      min=1.0))


def stats(world, source_mask, target, nn, valid):
    """K24's closing form on CUDA tensors, `stats_plain` on CPU tensors:
    -> (fitness, rmse) as 0-d tensors."""
    if not world.is_cuda:
        return stats_plain(world, source_mask, target, nn, valid)
    n, m = world.shape[0], target.shape[0]
    cuda.check(world, "world", torch.float32, (n, 3))
    cuda.check(source_mask, "source mask", torch.bool, (n,))
    cuda.check(target, "target", torch.float32, (m, 3))
    cuda.check(nn, "nn", torch.int32, (n,))
    cuda.check(valid, "valid", torch.bool, (n,))
    out = torch.empty(2, dtype=torch.float32, device=world.device)
    _STATS(world.device, world.data_ptr(), source_mask.data_ptr(), target.data_ptr(),
           nn.data_ptr(), valid.data_ptr(), n, out.data_ptr())
    return out[0], out[1]


# ---------------------------------------------------------------- icp_match


def icp_match_plain(source, source_mask, target, target_mask, x0: torch.Tensor,
                    params: IcpParams):
    pose = x0
    for _ in range(params.max_iterations):
        nn, world, valid = nearest_plain(source, source_mask, target, target_mask, pose,
                                         params.max_correspondence_distance)
        pose, _, _ = kabsch_plain(world, target, nn, valid, pose)
    nn, world, valid = nearest_plain(source, source_mask, target, target_mask, pose,
                                     params.max_correspondence_distance)
    fitness, rmse = stats_plain(world, source_mask, target, nn, valid)
    return pose, fitness, rmse


def _icp_kernel(source, source_mask, target, target_mask, x0: torch.Tensor,
                params: IcpParams):
    n, m = _check_clouds(source, source_mask, target, target_mask)
    cuda.check(x0, "initial pose", torch.float32, (7,))
    dev = source.device
    pose = x0.clone()  # updated in place by every round
    nn = torch.empty(n, dtype=torch.int32, device=dev)
    world = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    max_d2 = f32(params.max_correspondence_distance ** 2)
    nearest_args = (source.data_ptr(), source_mask.data_ptr(), n, target.data_ptr(),
                    target_mask.data_ptr(), m, pose.data_ptr(), max_d2, nn.data_ptr(),
                    world.data_ptr(), valid.data_ptr())
    for _ in range(params.max_iterations):
        _NEAREST(dev, *nearest_args)
        _KABSCH(dev, world.data_ptr(), target.data_ptr(), nn.data_ptr(), valid.data_ptr(), n,
                pose.data_ptr(), None)
    _NEAREST(dev, *nearest_args)
    return (pose, *stats(world, source_mask, target, nn, valid))


def icp_match_vector(source, source_mask, target, target_mask, x0: torch.Tensor,
                     params: IcpParams = IcpParams()):
    """icp_match on the pose vector x0 = [t, q] (7,): -> (pose (7,), fitness,
    rmse), on the clouds' device."""
    match = _icp_kernel if source.is_cuda else icp_match_plain
    return match(source, source_mask, target, target_mask, x0.contiguous(), params)


def icp_match(source: torch.Tensor, source_mask: torch.Tensor, target: torch.Tensor,
              target_mask: torch.Tensor, initial_pose: Rigid3, params: IcpParams = IcpParams()
              ) -> Tuple[Rigid3, torch.Tensor, torch.Tensor]:
    """Point-to-point ICP with Kabsch updates, `params.max_iterations`
    rounds from `initial_pose` (source frame -> target frame).

    Returns (pose, fitness = inlier fraction, rmse over inliers)."""
    x0 = torch.cat([initial_pose.translation, initial_pose.rotation]).to(torch.float32)
    pose, fitness, rmse = icp_match_vector(source, source_mask, target, target_mask, x0, params)
    return Rigid3(pose[0:3], pose[3:7]), fitness, rmse


# ---------------------------------------------------------------- K26


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, one operation at a time, as the kernels."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _nearest_k_plain(points, mask, k: int) -> torch.Tensor:
    """(N, k) int64: each point's k nearest columns by the reference's
    distance form, nearest first and the lower index first among equal
    distances (lax.top_k of -d2); masked columns count as +inf, so where
    fewer than k are masked in they fill the list in index order."""
    inf = torch.full((), float("inf"), device=points.device)
    out = []
    for r in range(0, points.shape[0], _ROWS):
        d2 = torch.where(mask[None, :], _pairwise_sq_dist(points[r:r + _ROWS], points), inf)
        # Rows with exactly k distances up to the k-th smallest: those k
        # columns in index order, then a stable sort by distance. Rows
        # with ties at the k-th: a stable sort of the whole row.
        kth = torch.topk(d2, k, dim=1, largest=False).values.amax(1, keepdim=True)
        candidates = d2 <= kth
        exact = candidates.sum(1) == k
        idx = torch.empty((d2.shape[0], k), dtype=torch.int64, device=points.device)
        if bool(exact.any()):
            cols = torch.nonzero(candidates[exact])[:, 1].reshape(-1, k)
            order = torch.sort(d2[exact].gather(1, cols), dim=1, stable=True).indices
            idx[exact] = cols.gather(1, order)
        if not bool(exact.all()):
            idx[~exact] = torch.sort(d2[~exact], dim=1, stable=True).indices[:, :k]
        out.append(idx)
    return torch.cat(out)


def _sign_rule(v: torch.Tensor) -> torch.Tensor:
    """Each row's largest component (the first of equal ones) made positive."""
    big = torch.argmax(v.abs(), dim=-1, keepdim=True)
    return torch.where(v.gather(-1, big) < 0, -v, v)


def normals_plain(points, mask, k: int = 10):
    """The plain twin of K26: -> (normals (N, 3), neighbours (N, k) int32).
    The mean and the covariance of each point's k neighbours are summed in
    list order in float32; the eigenvector of the smallest eigenvalue is
    taken in float64 (`torch.linalg.eigh`) with K26's sign rule. Rows of
    masked points are zero."""
    idx = _nearest_k_plain(points, mask, k)
    nbrs = points[idx]  # (N, k, 3)
    mu = nbrs[:, 0]
    for j in range(1, k):
        mu = mu + nbrs[:, j]
    mu = true_div(mu, float(k))
    e = nbrs - mu[:, None, :]
    entries = []
    for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        acc = torch.zeros_like(mu[:, 0])
        for j in range(k):
            acc = acc + e[:, j, a] * e[:, j, b]
        entries.append(true_div(acc, float(k)))
    xx, xy, xz, yy, yz, zz = entries
    cov = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], -1).reshape(-1, 3, 3)
    # Ascending eigenvalues; batches of _ROWS (cuSOLVER's batched eigh
    # refuses 32,768 at once).
    vecs = torch.cat([torch.linalg.eigh(c).eigenvectors[:, :, 0]
                      for c in cov.double().split(_ROWS)])
    normals = _sign_rule(vecs).to(torch.float32)
    return torch.where(mask[:, None], normals, torch.zeros_like(normals)), idx.to(torch.int32)


def normals_with_neighbours(points, mask, k: int = 10):
    """The normals (N, 3) of the cloud from its k-NN PCA and the neighbour
    lists (N, k) int32 they come from; K26 on CUDA tensors."""
    if not points.is_cuda:
        return normals_plain(points, mask, k)
    n = points.shape[0]
    cuda.check(points, "points", torch.float32, (n, 3))
    cuda.check(mask, "mask", torch.bool, (n,))
    if not 1 <= k <= min(n, _MAX_NEIGHBOURS):
        raise ValueError(f"estimate_normals: k = {k} must lie in 1..min(points, "
                         f"{_MAX_NEIGHBOURS})")
    normals = torch.empty((n, 3), dtype=torch.float32, device=points.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=points.device)
    _NORMALS(points.device, points.data_ptr(), mask.data_ptr(), n, k, normals.data_ptr(),
             idx.data_ptr())
    return normals, idx


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, k: int = 10) -> torch.Tensor:
    """Per-point normals (N, 3) from k-NN PCA (the smallest eigenvector)."""
    return normals_with_neighbours(points, mask, k)[0]


# ---------------------------------------------------------------- K27


def gicp_residuals(source, target, normals, nn, valid, pose: torch.Tensor):
    """Point-to-plane residuals (N,) ((R p + t) - target[nn]) . normal[nn]
    where valid (else 0) and their Jacobian (N, 6) on the tangent [dt, so3]:
    [n, p x (R^T n)]."""
    nn = nn.long()
    e = transform_points(pose, source) - target[nn]
    nv = normals[nn]
    r = (e[:, 0] * nv[:, 0] + e[:, 1] * nv[:, 1]) + e[:, 2] * nv[:, 2]
    jac = torch.cat([nv, _cross(source, quat.rotate_expanded(quat.conjugate(pose[3:7]), nv))],
                    -1)
    return (torch.where(valid, r, torch.zeros_like(r)),
            torch.where(valid[:, None], jac, torch.zeros_like(jac)))


def gicp_lm_plain(source, target, normals, nn, valid, pose: torch.Tensor, iterations: int):
    """The plain twin of K27: one round's LM -> (pose (7,), cost, iterations)."""
    return lm_solve(lambda x: gicp_residuals(source, target, normals, nn, valid, x), pose,
                    retract_fn=se3_retract, tangent_dim=6, num_iterations=iterations)


def gicp_lm(source, target, normals, nn, valid, pose: torch.Tensor, iterations: int):
    """One GICP round's `iterations`-step LM from `pose` [t, q] (7,) on the
    round's correspondences: -> (pose (7,), cost, iterations), K27 on CUDA
    tensors."""
    if not source.is_cuda:
        return gicp_lm_plain(source, target, normals, nn, valid, pose, iterations)
    n, m = source.shape[0], target.shape[0]
    cuda.check(source, "source", torch.float32, (n, 3))
    cuda.check(target, "target", torch.float32, (m, 3))
    cuda.check(normals, "normals", torch.float32, (m, 3))
    cuda.check(nn, "nn", torch.int32, (n,))
    cuda.check(valid, "valid", torch.bool, (n,))
    cuda.check(pose, "pose", torch.float32, (7,))
    dev = source.device
    out = torch.empty(7, dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    its = torch.empty((), dtype=torch.int32, device=dev)
    _GICP_LM(dev, source.data_ptr(), n, target.data_ptr(), normals.data_ptr(), nn.data_ptr(),
             valid.data_ptr(), pose.data_ptr(), out.data_ptr(), cost.data_ptr(), its.data_ptr(),
             iterations, _FUNCTION_TOLERANCE)
    return out, cost, its


# ---------------------------------------------------------------- gicp_match


def _gicp_rounds(params: IcpParams) -> int:
    return max(1, params.max_iterations // 5)


def gicp_match_plain(source, source_mask, target, target_mask, x0: torch.Tensor,
                     params: IcpParams, gn_iterations: int = 10):
    normals, _ = normals_plain(target, target_mask)
    pose = x0
    for _ in range(_gicp_rounds(params)):
        nn, _, valid = nearest_plain(source, source_mask, target, target_mask, pose,
                                     params.max_correspondence_distance)
        pose, _, _ = gicp_lm_plain(source, target, normals, nn, valid, pose, gn_iterations)
    nn, world, valid = nearest_plain(source, source_mask, target, target_mask, pose,
                                     params.max_correspondence_distance)
    fitness, rmse = stats_plain(world, source_mask, target, nn, valid)
    return pose, fitness, rmse


def _gicp_kernel(source, source_mask, target, target_mask, x0: torch.Tensor,
                 params: IcpParams, gn_iterations: int = 10):
    n, m = _check_clouds(source, source_mask, target, target_mask)
    cuda.check(x0, "initial pose", torch.float32, (7,))
    dev = source.device
    normals, _ = normals_with_neighbours(target, target_mask)
    pose = x0.clone()  # updated in place by every round
    nn = torch.empty(n, dtype=torch.int32, device=dev)
    world = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    nearest_args = (source.data_ptr(), source_mask.data_ptr(), n, target.data_ptr(),
                    target_mask.data_ptr(), m, pose.data_ptr(),
                    f32(params.max_correspondence_distance ** 2), nn.data_ptr(),
                    world.data_ptr(), valid.data_ptr())
    for _ in range(_gicp_rounds(params)):
        _NEAREST(dev, *nearest_args)
        _GICP_LM(dev, source.data_ptr(), n, target.data_ptr(), normals.data_ptr(),
                 nn.data_ptr(), valid.data_ptr(), pose.data_ptr(), pose.data_ptr(), None, None,
                 gn_iterations, _FUNCTION_TOLERANCE)
    _NEAREST(dev, *nearest_args)
    return (pose, *stats(world, source_mask, target, nn, valid))


def gicp_match_vector(source, source_mask, target, target_mask, x0: torch.Tensor,
                      params: IcpParams = IcpParams(), gn_iterations: int = 10):
    """gicp_match on the pose vector x0 = [t, q] (7,): -> (pose (7,),
    fitness, rmse), on the clouds' device."""
    match = _gicp_kernel if source.is_cuda else gicp_match_plain
    return match(source, source_mask, target, target_mask, x0.contiguous(), params,
                 gn_iterations)


def gicp_match(source: torch.Tensor, source_mask: torch.Tensor, target: torch.Tensor,
               target_mask: torch.Tensor, initial_pose: Rigid3, params: IcpParams = IcpParams(),
               gn_iterations: int = 10) -> Tuple[Rigid3, torch.Tensor, torch.Tensor]:
    """Plane-based ICP (the pclomp GICP stand-in): point-to-plane residuals
    against the target's normals, solved by LM on the SE(3) tangent with
    the correspondences re-estimated each outer round.

    Returns (pose, fitness = inlier fraction, rmse over inliers)."""
    x0 = torch.cat([initial_pose.translation, initial_pose.rotation]).to(torch.float32)
    pose, fitness, rmse = gicp_match_vector(source, source_mask, target, target_mask, x0,
                                            params, gn_iterations)
    return Rigid3(pose[0:3], pose[3:7]), fitness, rmse


# ---------------------------------------------------------------- K28


@dataclasses.dataclass(frozen=True)
class NdtParams:
    resolution: float = 1.0
    max_iterations: int = 30
    grid_extent: int = 32  # voxels per axis
    min_points_per_cell: int = 3
    regularization: float = 0.01


def ndt_center(target: torch.Tensor, target_mask: torch.Tensor) -> torch.Tensor:
    """The masked mean of the target (3,), summed in the halving tree on
    every device."""
    w = target_mask.to(torch.float32)
    kept = torch.where(target_mask[:, None], target, torch.zeros_like(target))
    s = tree_sum(_padded(torch.cat([kept.T, w[None]])))
    return s[0:3] / torch.clamp(s[3], min=1.0)


def _ndt_cells(points, mask, origin, resolution: float, g: int):
    """-> (lin (N,) int64, inb (N,)): floor((p - origin) / resolution) per
    axis (a true division), flattened as (i g + j) g + k where in bounds
    and masked in."""
    cells = torch.floor(true_div(points - origin, resolution)).to(torch.int32)
    inb = ((cells >= 0) & (cells < g)).all(-1) & mask
    cells = cells.long()
    return (cells[:, 0] * g + cells[:, 1]) * g + cells[:, 2], inb


def _cell_sums(lin: torch.Tensor, values: torch.Tensor, cells: int) -> torch.Tensor:
    """(cells, F): the rows of `values` (N, F) added into their cell `lin`
    from zero in input order (XLA's scatter-add on the CPU, K28's order)."""
    out = torch.zeros((cells, values.shape[1]), dtype=values.dtype, device=values.device)
    return index_add_in_order_(out, lin, values)


def _ndt_origin(center: torch.Tensor, params: NdtParams) -> torch.Tensor:
    return center - f32(0.5 * params.grid_extent * params.resolution)


def build_ndt_grid_plain(target, target_mask, params: NdtParams, center: torch.Tensor):
    """The plain twin of K28: -> (means (C, 3), L (C, 3, 3), valid (C,),
    origin (3,)). Sums in float32 in input order; the inverse and the lower
    Cholesky factor of the inverse in float64."""
    g = params.grid_extent
    C = g ** 3
    origin = _ndt_origin(center, params)
    lin, inb = _ndt_cells(target, target_mask, origin, params.resolution, g)
    p = target[inb]
    outer = (p[:, :, None] * p[:, None, :]).reshape(-1, 9)
    sums = _cell_sums(lin[inb], torch.cat([torch.ones_like(p[:, :1]), p, outer], 1), C)
    counts = sums[:, 0]
    n = torch.clamp(counts, min=1.0)
    means = sums[:, 1:4] / n[:, None]
    cov = sums[:, 4:13].reshape(-1, 3, 3) / n[:, None, None] - means[:, :, None] * means[:, None, :]
    cov = cov + f32(params.regularization) * torch.eye(3, device=target.device)
    inv = torch.linalg.inv(cov.double())
    L = torch.linalg.cholesky_ex(0.5 * (inv + inv.transpose(1, 2))).L.to(torch.float32)
    return means, L, counts >= params.min_points_per_cell, origin


def build_ndt_grid(target: torch.Tensor, target_mask: torch.Tensor, params: NdtParams,
                   center: torch.Tensor):
    """Per-voxel Gaussians (pclomp::VoxelGridCovariance): -> (means (C, 3),
    inv_cov_chol (C, 3, 3), valid (C,), origin (3,)) on the grid of
    `params.grid_extent`^3 voxels centred on `center`; K28 on CUDA tensors."""
    if not target.is_cuda:
        return build_ndt_grid_plain(target, target_mask, params, center)
    m = target.shape[0]
    cuda.check(target, "target", torch.float32, (m, 3))
    cuda.check(target_mask, "target mask", torch.bool, (m,))
    if m < 1:
        raise ValueError("build_ndt_grid: the target needs at least one point")
    g = params.grid_extent
    C = g ** 3
    dev = target.device
    origin = _ndt_origin(center.to(torch.float32), params).contiguous()
    cuda.check(origin, "center", torch.float32, (3,))
    keys = torch.empty(max(2, 1 << (m - 1).bit_length()), dtype=torch.int64, device=dev)
    means = torch.empty((C, 3), dtype=torch.float32, device=dev)
    L = torch.empty((C, 3, 3), dtype=torch.float32, device=dev)
    valid = torch.empty(C, dtype=torch.bool, device=dev)
    _NDT_GRID(dev, target.data_ptr(), target_mask.data_ptr(), m, origin.data_ptr(),
              f32(params.resolution), g, f32(params.regularization),
              float(params.min_points_per_cell), keys.data_ptr(), means.data_ptr(),
              L.data_ptr(), valid.data_ptr())
    return means, L, valid, origin


# ---------------------------------------------------------------- K29


def ndt_residuals(grid, source, source_mask, pose: torch.Tensor, params: NdtParams):
    """Whitened residuals (3N,) L^T (world - mean) of each source point in a
    valid cell (else 0), point-major, and their Jacobian (3N, 6) on the
    tangent: [L[:, a], p x (R^T L[:, a])] for row a."""
    means, L, valid_cells, origin = grid
    world = transform_points(pose, source)
    lin, inb = _ndt_cells(world, source_mask, origin, params.resolution, params.grid_extent)
    lin = torch.where(inb, lin, torch.zeros_like(lin))
    ok = inb & valid_cells[lin]
    d = world - means[lin]
    cols = L[lin].transpose(1, 2)  # (N, a, b) = L[b, a]
    r = (cols[:, :, 0] * d[:, None, 0] + cols[:, :, 1] * d[:, None, 1]) + cols[:, :, 2] * d[:, None, 2]
    gb = quat.rotate_expanded(quat.conjugate(pose[3:7]), cols)
    jac = torch.cat([cols, _cross(source[:, None, :].expand_as(gb), gb)], -1)
    r = torch.where(ok[:, None], r, torch.zeros_like(r))
    jac = torch.where(ok[:, None, None], jac, torch.zeros_like(jac))
    return r.reshape(-1), jac.reshape(-1, 6)


def ndt_lm_plain(grid, source, source_mask, x0: torch.Tensor, params: NdtParams):
    """The plain twin of K29: -> (pose (7,), cost, iterations)."""
    return lm_solve(lambda x: ndt_residuals(grid, source, source_mask, x, params), x0,
                    retract_fn=se3_retract, tangent_dim=6, num_iterations=params.max_iterations)


def ndt_lm(grid, source, source_mask, x0: torch.Tensor, params: NdtParams):
    """NDT's LM from x0 [t, q] (7,) on the grid (means, L, valid, origin):
    -> (pose (7,), cost, iterations), K29 on CUDA tensors."""
    if not source.is_cuda:
        return ndt_lm_plain(grid, source, source_mask, x0, params)
    means, L, valid, origin = grid
    n, g = source.shape[0], params.grid_extent
    C = g ** 3
    cuda.check(source, "source", torch.float32, (n, 3))
    cuda.check(source_mask, "source mask", torch.bool, (n,))
    cuda.check(means, "means", torch.float32, (C, 3))
    cuda.check(L, "inv_cov_chol", torch.float32, (C, 3, 3))
    cuda.check(valid, "valid", torch.bool, (C,))
    cuda.check(origin, "origin", torch.float32, (3,))
    cuda.check(x0, "initial pose", torch.float32, (7,))
    if n < 1:
        raise ValueError("ndt_match: the source needs at least one point")
    dev = source.device
    out = torch.empty(7, dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    its = torch.empty((), dtype=torch.int32, device=dev)
    _NDT_LM(dev, source.data_ptr(), source_mask.data_ptr(), n, means.data_ptr(), L.data_ptr(),
            valid.data_ptr(), origin.data_ptr(), f32(params.resolution), g, x0.data_ptr(),
            params.max_iterations, _FUNCTION_TOLERANCE, out.data_ptr(), cost.data_ptr(),
            its.data_ptr())
    return out, cost, its


# ---------------------------------------------------------------- ndt_match


def ndt_match_vector(source, source_mask, target, target_mask, x0: torch.Tensor,
                     params: NdtParams = NdtParams()):
    """ndt_match on the pose vector x0 = [t, q] (7,): -> (pose (7,), cost),
    on the clouds' device."""
    grid = build_ndt_grid(target, target_mask, params, ndt_center(target, target_mask))
    pose, cost, _ = ndt_lm(grid, source, source_mask, x0.contiguous(), params)
    return pose, cost


def ndt_match(source: torch.Tensor, source_mask: torch.Tensor, target: torch.Tensor,
              target_mask: torch.Tensor, initial_pose: Rigid3, params: NdtParams = NdtParams()
              ) -> Tuple[Rigid3, torch.Tensor]:
    """NDT (pclomp::NormalDistributionsTransform): whitened distances of the
    source to the target's per-voxel Gaussians, minimized by LM on the SE(3)
    tangent from `initial_pose`. Returns (pose, final cost)."""
    x0 = torch.cat([initial_pose.translation, initial_pose.rotation]).to(torch.float32)
    pose, cost = ndt_match_vector(source, source_mask, target, target_mask, x0, params)
    return Rigid3(pose[0:3], pose[3:7]), cost
