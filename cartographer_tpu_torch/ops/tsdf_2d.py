"""2D truncated signed distance field (TSDF) grids: normals, insertion and
the TSDF scan matcher.

Counterpart of the JAX package's `ops/tsdf_2d.py` (tsdf_2d.cc,
tsdf_range_data_inserter_2d.cc, normal_estimation_2d.cc,
tsdf_match_cost_function_2d.cc). A `TsdfGrid2D` holds per cell a truncated
signed distance and a weight (0: unknown); its score surface
`correspondence_score()` (1 - |tsd| / truncation where known, 0 elsewhere)
is what the correlative search (K5), the precomputation pyramid (K6) and the
loop-closure refine (K3) read in their TSDF forms.

Three kernels, each with its plain PyTorch twin, which CPU tensors take:

  - `estimate_normals_2d` (K20, `csrc/tsdf_2d.cu` `tsdf_normals_2d`):
    normals from the angle-sorted neighbours of each return, one launch
    (a block per robot) up to 8,192 returns;
  - `insert_into_slots_tsdf` (K21, `tsdf_insert_2d`): one scan into every
    active grid of a batch (the two active submaps), in place, each cell's
    samples added in input order (`csrc/in_order_scatter.cuh`), so the card
    equals the twin bit for bit;
  - `lm_match_tsdf_2d` (K22, `csrc/scan_matcher_2d.cu` `lm_match_tsdf_2d`):
    K3's Levenberg-Marquardt solve on the interpolated signed distance.

Each takes R robots' inputs with a leading R (the cross-robot batched
step), one launch for all of them on the card: K20 R scans, K21 R robots'
windows (a list of their grids, which stay where each robot keeps them),
K22 R grids. A robot's results do not depend on R.

The port follows the JAX program with two documented departures: the 16
sample offsets are jnp.linspace's float32 formula evaluated with IEEE
division (XLA's reciprocal moves some by an ulp), and cells the scan does
not touch keep their values (JAX recomputes (w tsd) / w for every cell,
which can re-round an untouched cell by an ulp).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cartographer_tpu_torch.core.tensor import f32, index_add_in_order_, to_device, true_div
from cartographer_tpu_torch.ops import cuda, in_order_scatter, scan_matcher_2d
from cartographer_tpu_torch.ops.gauss_newton import lm_solve
from cartographer_tpu_torch.ops.interp import bicubic_with_gradient
from cartographer_tpu_torch.sensor.point_cloud import RangeData
from cartographer_tpu_torch.transform.rigid import Rigid2

SAMPLES_PER_RAY = 16  # insert_range_data_tsdf's samples_per_ray
NUM_NORMAL_SAMPLES = 4  # estimate_normals_2d's num_samples, as the JAX inserter calls it
_FUNCTION_TOLERANCE = 1e-6  # lm_solve's default, which the JAX TSDF matcher keeps

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NORMALS = cuda.CudaKernel("tsdf_2d.cu", "tsdf_normals_2d", [_P, _P, _P, _I, _I, _P, _P, _P])
_NORMALS_ONE_BLOCK = 8192  # kOneBlockKeys: K20 in one launch up to this many points
_INSERT = cuda.CudaKernel(
    "tsdf_2d.cu", "tsdf_insert_2d",
    [_P, _I, _P, _P, _P, _P, _I, _P, _F, _I, _F, _F, _I, _F, _F, _I, _P, _P, _I, _I, _P])
_LM = cuda.CudaKernel("scan_matcher_2d.cu", "lm_match_tsdf_2d",
                      [_P, _I, _F] + scan_matcher_2d.LM_ARGS)


@dataclasses.dataclass(frozen=True)
class TsdfGrid2D:
    """Per-cell (truncated signed distance, weight); weight 0 = unknown.

    Cell (i, j) covers world [origin + (i, j) * resolution, + resolution),
    as in Grid2D. A batch of grids carries a leading dimension on every
    tensor field.
    """

    tsd: torch.Tensor  # (..., S, S) float32 in [-truncation, truncation]
    weight: torch.Tensor  # (..., S, S) float32 >= 0
    origin: torch.Tensor  # (..., 2) float32
    resolution: float
    truncation_distance: float = 0.3
    max_weight: float = 10.0

    SURFACE = "tsdf"  # the matching kernels' form that reads the score surface

    @staticmethod
    def create(size: int, resolution: float, center, device,
               truncation_distance: float = 0.3, max_weight: float = 10.0) -> "TsdfGrid2D":
        origin = np.asarray(center, np.float32) - np.float32(0.5 * size * resolution)
        return TsdfGrid2D(
            tsd=torch.zeros((size, size), dtype=torch.float32, device=device),
            weight=torch.zeros((size, size), dtype=torch.float32, device=device),
            origin=to_device(origin.astype(np.float32), device), resolution=resolution,
            truncation_distance=truncation_distance, max_weight=max_weight)

    @property
    def size(self) -> int:
        return self.tsd.shape[-1]

    def slot(self, i: int) -> "TsdfGrid2D":
        """Grid i of a batch (views of the batch's tensors)."""
        return dataclasses.replace(self, tsd=self.tsd[i], weight=self.weight[i],
                                   origin=self.origin[i])

    def clone(self) -> "TsdfGrid2D":
        return dataclasses.replace(self, tsd=self.tsd.clone(), weight=self.weight.clone(),
                                   origin=self.origin.clone())

    def world_to_cell_continuous(self, points: torch.Tensor) -> torch.Tensor:
        return true_div(points - self.origin, self.resolution)

    @property
    def known(self) -> torch.Tensor:
        return self.weight > 0

    def known_bounds_numpy(self):
        """(imin, imax, jmin, jmax) of the known cells; (0, -1, 0, -1) if none."""
        known = self.weight.cpu().numpy() > 0
        if not known.any():
            return 0, -1, 0, -1
        ii, jj = np.nonzero(known)
        return int(ii.min()), int(ii.max()), int(jj.min()), int(jj.max())

    def score_at(self, ii: torch.Tensor, jj: torch.Tensor) -> torch.Tensor:
        """The score surface at cells (ii, jj), all inside the grid."""
        tsd = self.tsd[..., ii, jj]
        score = 1.0 - true_div(torch.abs(tsd), f32(self.truncation_distance))
        return torch.where(self.weight[..., ii, jj] > 0, score, torch.zeros_like(score))

    def correspondence_score(self) -> torch.Tensor:
        """(S, S) 1 - |tsd| / truncation, 0 where unknown: the TSDF scoring
        surface (real_time_correlative 2D TSDF branch)."""
        score = 1.0 - true_div(torch.abs(self.tsd), f32(self.truncation_distance))
        return torch.where(self.weight > 0, score, torch.zeros_like(score))

    def probability(self) -> torch.Tensor:
        """The scoring surface under the name the matchers read (JAX l.81)."""
        return self.correspondence_score()

    def surface_row(self) -> tuple:
        """This (S, S) grid's row of the matching kernels' pointer table (the
        TSDF forms of K3 and K5, K22): its tsd, weight and origin."""
        size = self.size
        cuda.check(self.tsd, "tsd", torch.float32, (size, size))
        cuda.check(self.weight, "weight", torch.float32, (size, size))
        cuda.check(self.origin, "grid origin", torch.float32, (2,))
        return self.tsd, self.weight, self.origin

    def surface_args(self) -> tuple:
        """The surface arguments of the matching kernels' TSDF form: the tsd
        and weight pointers of one (S, S) grid and the truncation."""
        size = self.size
        cuda.check(self.tsd, "tsd", torch.float32, (size, size))
        cuda.check(self.weight, "weight", torch.float32, (size, size))
        return self.tsd.data_ptr(), self.weight.data_ptr(), f32(self.truncation_distance)


# ---------------------------------------------------------------- K20


def _normals_plain(points: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor):
    if points.dim() == 3:  # R robots' scans, one after another
        return torch.stack([_normals_plain(points[r], mask[r], origin[r])
                            for r in range(points.shape[0])])
    n = points.shape[0]
    rel = points - origin
    angles = torch.atan2(rel[:, 1], rel[:, 0])
    order = torch.argsort(torch.where(mask, angles, torch.full_like(angles, float("inf"))),
                          stable=True)
    sorted_pts = points[order]
    half = max(1, NUM_NORMAL_SAMPLES // 2)
    offsets = torch.arange(-half, half + 1, device=points.device)
    nbrs = sorted_pts[(torch.arange(n, device=points.device)[:, None] + offsets).clamp(0, n - 1)]
    k = nbrs.shape[1]
    mx = torch.zeros_like(nbrs[:, 0, 0])
    my = torch.zeros_like(mx)
    for q in range(k):
        mx = mx + nbrs[:, q, 0]
        my = my + nbrs[:, q, 1]
    mx, my = true_div(mx, float(k)), true_div(my, float(k))
    a = torch.zeros_like(mx)
    b = torch.zeros_like(mx)
    c = torch.zeros_like(mx)
    for q in range(k):
        cx, cy = nbrs[:, q, 0] - mx, nbrs[:, q, 1] - my
        a = a + cx * cx
        b = b + cx * cy
        c = c + cy * cy
    # The smallest eigenvector in closed form, as the kernel takes it.
    t = 0.5 * (a - c)
    lam = 0.5 * (a + c) - torch.sqrt(t * t + b * b)
    v1 = torch.stack([b, lam - a], -1)
    v2 = torch.stack([lam - c, b], -1)
    n1, n2 = (v1 * v1).sum(-1), (v2 * v2).sum(-1)
    first = (n1 >= n2) & (n1 > 0)
    v = torch.where(first[:, None], v1, v2)
    norm = torch.sqrt(torch.where(first, n1, n2))
    unit = torch.zeros_like(v)
    unit[:, 0] = 1.0
    normal = torch.where((norm > 0)[:, None], v / torch.where(norm > 0, norm, 1.0)[:, None],
                         unit)
    to_origin = origin - sorted_pts
    flip = (normal[:, 0] * to_origin[:, 0] + normal[:, 1] * to_origin[:, 1]) < 0
    normal = torch.where(flip[:, None], -normal, normal)
    out = torch.zeros_like(normal)
    out[order] = normal
    return out


def estimate_normals_2d(points: torch.Tensor, mask: torch.Tensor,
                        origin: torch.Tensor) -> torch.Tensor:
    """Per-point unit normals (N, 2) (normal_estimation_2d.cc): the smallest
    principal direction of each point's 5 neighbours in scan-angle order,
    oriented toward the sensor `origin` (2,). With (R, N, 2) points, (R, N)
    masks and (R, 2) origins: R robots' normals (R, N, 2), one launch."""
    if not points.is_cuda:
        return _normals_plain(points, mask, origin)
    robots = points.shape[0] if points.dim() == 3 else None
    n = points.shape[-2]
    strides = np.array([cuda.robot_stride(t, name, dtype, inner, robots) for t, name, dtype, inner
                        in ((points, "points", torch.float32, (n, 2)),
                            (mask, "mask", torch.bool, (n,)),
                            (origin, "origin", torch.float32, (2,)))], np.int64)
    # The keys' scratch: only above one block's sort, where they go through
    # device memory.
    keys = torch.empty((robots or 1) * max(2, 1 << (n - 1).bit_length())
                       if n > _NORMALS_ONE_BLOCK else 1, dtype=torch.int64, device=points.device)
    normals = torch.empty(points.shape, dtype=torch.float32, device=points.device)
    _NORMALS(points.device, points.data_ptr(), mask.data_ptr(), origin.data_ptr(), n,
             robots or 1, strides.ctypes.data, keys.data_ptr(), normals.data_ptr())
    return normals


# ---------------------------------------------------------------- K21


@dataclasses.dataclass(frozen=True)
class TsdfInserterParams:
    """The options the JAX inserter reads (TsdfRangeDataInserterOptions2D)."""

    update_weight_range_exponent: int = 0
    angle_kernel_bandwidth: float = 0.5
    distance_kernel_bandwidth: float = 0.5
    project_to_normal: bool = True


def sample_offsets(truncation: float, device) -> torch.Tensor:
    """jnp.linspace(-truncation, truncation, 16)'s float32 arithmetic:
    -t (1 - k / 15) + t k / 15, the last exactly t."""
    t = torch.full((), f32(truncation), dtype=torch.float32, device=device)
    h = true_div(torch.arange(SAMPLES_PER_RAY - 1, dtype=torch.float32, device=device),
                 float(SAMPLES_PER_RAY - 1))
    return torch.cat([-t * (1.0 - h) + t * h, t[None]])


def _integer_power(x: torch.Tensor, exponent: int) -> torch.Tensor:
    out = torch.ones_like(x)
    for _ in range(exponent):
        out = out * x
    return out


def _samples(rd: RangeData, normals: torch.Tensor, truncation: float,
             params: TsdfInserterParams):
    """-> (sample points (K, N, 2), sdf (K, N), weights (K, N)), weights 0
    for masked points."""
    hits = rd.returns
    rel = hits.points - rd.origin
    ray_len = torch.clamp(torch.sqrt(rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]), min=1e-6)
    ray_dir = rel / ray_len[:, None]
    ts = sample_offsets(truncation, rel.device)
    sample_pts = hits.points[None] - ts[:, None, None] * ray_dir[None]
    trunc = f32(truncation)
    if params.project_to_normal:
        diff = hits.points[None] - sample_pts
        sdf = diff[..., 0] * (-normals[None, :, 0]) + diff[..., 1] * (-normals[None, :, 1])
    else:
        sdf = ts[:, None].expand(sample_pts.shape[:2])
    sdf = torch.clamp(sdf, -trunc, trunc)
    exponent = params.update_weight_range_exponent
    w_range = (torch.ones_like(ray_len) if exponent == 0
               else 1.0 / _integer_power(ray_len, exponent))
    cos_angle = torch.abs(normals[:, 0] * (-ray_dir[:, 0]) + normals[:, 1] * (-ray_dir[:, 1]))
    angle = torch.arccos(torch.clamp(cos_angle, -1.0, 1.0))
    w_angle = torch.exp(true_div(-(angle * angle), f32(2 * params.angle_kernel_bandwidth**2)))
    w_dist = torch.exp(true_div(-(ts * ts), f32(2 * params.distance_kernel_bandwidth**2)))
    w = (w_range * w_angle)[None, :] * w_dist[:, None]
    w = torch.where(hits.mask[None, :], w, torch.zeros_like(w))
    return sample_pts, sdf, w


def _insert_plain(grids: TsdfGrid2D, rd: RangeData, normals, active, do_insert,
                  params: TsdfInserterParams) -> None:
    sample_pts, sdf, w = _samples(rd, normals, grids.truncation_distance, params)
    s = grids.size
    flat = s * s
    for b in range(grids.tsd.shape[0]):
        g = grids.slot(b)
        cells = torch.floor(true_div(sample_pts - g.origin, g.resolution))
        inb = ((cells >= 0) & (cells < s)).all(-1)
        cells = torch.where(inb[..., None], cells, torch.zeros_like(cells)).long()
        lin = torch.where(inb, cells[..., 0] * s + cells[..., 1],
                          torch.full_like(cells[..., 0], flat)).reshape(-1)
        # Each cell's samples in input order, as XLA's scatter-add on the
        # CPU and K21 add them (index_add_ on the card adds by atomics).
        wsum = index_add_in_order_(torch.zeros(flat + 1, device=w.device), lin,
                                   w.reshape(-1))[:flat]
        wtsd = index_add_in_order_(torch.zeros(flat + 1, device=w.device), lin,
                                   (w * sdf).reshape(-1))[:flat]
        old_w, old_t = g.weight.reshape(-1), g.tsd.reshape(-1)
        touched = wsum > 0
        new_w = old_w + wsum
        new_t = torch.where(touched & (new_w > 0),
                            (old_w * old_t + wtsd) / torch.clamp(new_w, min=1e-9), old_t)
        new_w = torch.where(touched, torch.clamp(new_w, max=f32(grids.max_weight)), old_w)
        gate = active[b] & do_insert
        g.tsd.copy_(torch.where(gate, new_t, old_t).reshape(s, s))
        g.weight.copy_(torch.where(gate, new_w, old_w).reshape(s, s))


def insert_into_slots_tsdf(grids, rd: RangeData, active: torch.Tensor,
                           do_insert: torch.Tensor, params: TsdfInserterParams,
                           normals: Optional[torch.Tensor] = None) -> None:
    """TSDFRangeDataInserter2D::Insert of one scan (in the grids' frame)
    into every grid of the batch `grids` whose `active` flag is set, when
    `do_insert` (0-d bool) holds; in place. `normals` (N, 2) default to
    estimate_normals_2d of the returns. With (R, N, 2) returns, (R, 2)
    origin, (R, slots) `active` and (R,) `do_insert`, `grids` is a list of
    R robots' batches: one launch of K20 and one of K21 for all R."""
    hits = rd.returns
    robots = hits.points.shape[0] if hits.points.dim() == 3 else None
    if normals is None:
        normals = estimate_normals_2d(hits.points, hits.mask, rd.origin)
    if not hits.points.is_cuda:
        jobs = ([(grids, rd, normals, active, do_insert)] if robots is None else
                [(grids[r], rd.robot(r), normals[r], active[r], do_insert[r])
                 for r in range(robots)])
        for g, one, nr, a, d in jobs:
            _insert_plain(g, one, nr, a, d, params)
        return
    if robots is None:
        grids = [grids]
    g0 = grids[0]
    n = hits.points.shape[-2]
    size, res = cuda.robot_grids(grids, robots or 1)
    slots = g0.tsd.shape[0]
    if any(g.truncation_distance != g0.truncation_distance or g.max_weight != g0.max_weight
           for g in grids):
        raise ValueError("the robots' grids must share their truncation and maximum weight")
    rows = []
    for g in grids:
        cuda.check(g.tsd, "tsd", torch.float32, (slots, size, size))
        cuda.check(g.weight, "weight", torch.float32, (slots, size, size))
        cuda.check(g.origin, "grid origin", torch.float32, (slots, 2))
        rows.append((g.tsd, g.weight, g.origin))
    inputs = ((hits.points, "returns", torch.float32, (n, 2)),
              (hits.mask, "returns mask", torch.bool, (n,)),
              (normals, "normals", torch.float32, (n, 2)),
              (rd.origin, "origin", torch.float32, (2,)),
              (active, "active", torch.bool, (slots,)),
              (do_insert, "do_insert", torch.bool, ()))
    strides = np.array([cuda.robot_stride(t, name, dtype, inner, robots)
                        for t, name, dtype, inner in inputs], np.int64)
    # Items of more than one launch add to running sums, applied once after.
    sums = (torch.zeros(((robots or 1) * slots * size * size, 2), device=hits.points.device)
            if in_order_scatter.launches(SAMPLES_PER_RAY * n * slots) > 1 else None)
    _INSERT(hits.points.device, cuda.pointer_table(rows), robots or 1,
            *(t.data_ptr() for t, _, _, _ in inputs[:4]), n, strides.ctypes.data, f32(res),
            size, f32(g0.truncation_distance), f32(g0.max_weight),
            int(params.update_weight_range_exponent),
            f32(2 * params.angle_kernel_bandwidth**2),
            f32(2 * params.distance_kernel_bandwidth**2), int(params.project_to_normal),
            active.data_ptr(), do_insert.data_ptr(), slots,
            in_order_scatter.radix_passes(slots * size * size),
            None if sums is None else sums.data_ptr())


def insert_range_data_tsdf(grid: TsdfGrid2D, range_data: RangeData,
                           update_weight_range_exponent: int = 0,
                           angle_kernel_bandwidth: float = 0.5,
                           distance_kernel_bandwidth: float = 0.5,
                           project_to_normal: bool = True) -> TsdfGrid2D:
    """Insert one scan (in the grid frame) into a copy of the grid, with
    the JAX function's signature."""
    device = grid.tsd.device
    batch = dataclasses.replace(grid, tsd=grid.tsd[None].clone(),
                                weight=grid.weight[None].clone(),
                                origin=grid.origin[None].clone())
    params = TsdfInserterParams(update_weight_range_exponent, angle_kernel_bandwidth,
                                distance_kernel_bandwidth, project_to_normal)
    insert_into_slots_tsdf(batch, range_data, torch.ones(1, dtype=torch.bool, device=device),
                           torch.ones((), dtype=torch.bool, device=device), params)
    return batch.slot(0)


# ---------------------------------------------------------------- K22


def tsdf_residuals_and_jacobian(grid: TsdfGrid2D, points: torch.Tensor, mask: torch.Tensor,
                                pose_vec: torch.Tensor, weight: float):
    """Residuals (M,) w / sqrt(n) * bicubic(tsd)(T p) * 0.8 / resolution (0
    where masked; tsdf_residuals, JAX l.210) and their Jacobian (M, 3) with
    respect to pose_vec = [x, y, theta]."""
    c, s = torch.cos(pose_vec[2]), torch.sin(pose_vec[2])
    x, y = points[..., 0], points[..., 1]
    rx = c * x - s * y
    ry = s * x + c * y
    world = torch.stack([rx, ry], dim=-1) + pose_vec[0:2]
    coords = grid.world_to_cell_continuous(world)
    val, dval = bicubic_with_gradient(lambda ii, jj: grid.tsd[ii, jj], grid.tsd.shape, coords)
    k = f32(0.8 / grid.resolution)
    n = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    scale = torch.full_like(n, weight) / torch.sqrt(n)
    dval = true_div(dval, grid.resolution)
    jac = torch.stack([dval[..., 0], dval[..., 1], dval[..., 1] * rx - dval[..., 0] * ry], -1)
    residuals = torch.where(mask, scale * (val * k), torch.zeros_like(val))
    jac = torch.where(mask[:, None], (scale * k) * jac, torch.zeros_like(jac))
    return residuals, jac


def _match_plain(grid, points, mask, x0, target_translation, params):
    target_rotation = x0[2]
    w_t, w_r = params.translation_weight, params.rotation_weight
    penalty_jac = torch.tensor([[w_t, 0.0, 0.0], [0.0, w_t, 0.0], [0.0, 0.0, w_r]],
                               dtype=torch.float32).to(x0.device, non_blocking=True)

    def residual_and_jacobian(x):
        r, jac = tsdf_residuals_and_jacobian(grid, points, mask, x, params.occupied_space_weight)
        r_t = w_t * (x[0:2] - target_translation)
        r_r = w_r * (x[2:3] - target_rotation)
        return torch.cat([r, r_t, r_r]), torch.cat([jac, penalty_jac])

    return lm_solve(residual_and_jacobian, x0, num_iterations=params.num_iterations,
                    function_tolerance=_FUNCTION_TOLERANCE)


def _launch(grids, points, mask, x0, target_translation, params):
    return scan_matcher_2d.launch_lm(_LM, (f32(0.8 / grids[0].resolution),), grids, points, mask,
                                     x0, target_translation, params, False)


def lm_match_tsdf_2d(grid: TsdfGrid2D, points: torch.Tensor, mask: torch.Tensor,
                     x0: torch.Tensor, target_translation: torch.Tensor, params
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TSDF solve on pose vectors (`params` a GaussNewtonMatcherParams2D;
    its use_nonmonotonic_steps is not read, as in JAX): -> (pose (3,),
    final cost, LM iterations). With (R, M, 2) points, R grids and a
    leading R on the rest: R robots' solves, one launch on the card."""
    return scan_matcher_2d.per_robot(_launch, _match_plain, grid, points, mask, x0,
                                     target_translation, params)


def gauss_newton_match_tsdf(grid: TsdfGrid2D, points: torch.Tensor, mask: torch.Tensor,
                            initial_pose, params, target_translation=None):
    """CeresScanMatcher2D on a TSDF grid (tsdf_match_cost_function_2d.cc):
    the probability matcher's anchors, its occupied-space term replaced by
    the interpolated signed distance. Returns (refined Rigid2, final cost)."""
    if target_translation is None:
        target_translation = initial_pose.translation
    x, cost, _ = lm_match_tsdf_2d(grid, points, mask, initial_pose.to_vector(),
                                  target_translation, params)
    return Rigid2.from_vector(x), cost
