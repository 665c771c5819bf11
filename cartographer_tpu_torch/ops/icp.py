"""Point-to-point ICP with Kabsch updates: the fork's alternative matcher.

Counterpart of `IcpParams`, `_pairwise_sq_dist`, `_correspondences`,
`_rotation_matrix_to_quat` and `icp_match` in the JAX package's
`ops/icp.py` (the fork's PCL-based icp_match path). Each round pairs every
source point, moved by the current pose, with its nearest target by brute
force over the dense distance matrix in the reference's form |a|^2 + |b|^2 -
2 a.b (kept as it is: parity depends on it, though it loses some 2e-4 m^2
at 60 m ranges and can go slightly negative), then takes the Kabsch rotation
of the weighted cross-covariance and composes it on the left of the pose.

On CUDA tensors `icp_match` runs its rounds on the device with no host
sync: K23 (`csrc/icp.cu` `icp_nearest`) finds the correspondences and K24
(`icp_kabsch`) updates a 7-float pose buffer [t, q] in place; a last K23
and K24's `icp_stats` give the fitness and the RMSE. CPU tensors run the
plain twins. Both sum the point axis as the same pairwise halving tree;
the twin's 3x3 SVD is `torch.linalg.svd` in float64, K24's one-sided Jacobi
sweeps in double precision. GICP and NDT (`estimate_normals`, `gicp_match`,
`build_ndt_grid`, `ndt_match`) are not ported yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from cartographer_tpu_torch.core.tensor import f32
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.ops.correlative_2d import tree_sum
from cartographer_tpu_torch.transform import quaternion as quat
from cartographer_tpu_torch.transform.rigid import Rigid3

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_NEAREST = cuda.CudaKernel("icp.cu", "icp_nearest",
                           [_P, _P, _I, _P, _P, _I, _P, _F, _P, _P, _P])
_KABSCH = cuda.CudaKernel("icp.cu", "icp_kabsch", [_P, _P, _P, _P, _I, _P, _P])
_STATS = cuda.CudaKernel("icp.cu", "icp_stats", [_P, _P, _P, _P, _P, _I, _P])

_ROWS = 1024  # source rows per block of the twin's distance matrix
_IDENTITY = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


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
