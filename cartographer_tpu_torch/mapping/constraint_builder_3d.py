"""3D loop-closure constraint search.

Counterpart of the JAX package's `mapping/constraint_builder_3d.py`
(constraint_builder_3d.cc) on one device: gated and sampled (node, submap)
requests, a per-submap matcher cache (the precomputation stack of K14, the
dense crops, the low grid's probabilities and the submap histogram), and
per pair the branch-and-bound match (K13, K15) followed by the SE(3)
Gauss-Newton refine (K11) that produces an INTER_SUBMAP constraint for
every match above `min_score`. Local requests of a batch run back to back
on the device and their rows come back in one blocking copy; full-submap
(global localization) requests widen beam and yaw budget until certified,
one blocking copy per round. The mesh path of the JAX module waits for the
multi-GPU port.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.core.config import ConstraintBuilderOptions
from cartographer_tpu_torch.core.histogram import Histogram
from cartographer_tpu_torch.core.sampler import FixedRatioSampler
from cartographer_tpu_torch.core.tensor import to_device
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.ops.bnb_3d import (
    FastCorrelativeMatcherParams3D,
    PrecomputationStack3D,
    build_precomputation_stack_3d,
    fast_correlative_match_3d,
    match_full_submap_3d_exact,
)
from cartographer_tpu_torch.ops.grid_3d import Grid3D
from cartographer_tpu_torch.ops.scan_matcher_3d import (
    GaussNewtonMatcherParams3D,
    gauss_newton_match_3d,
)
from cartographer_tpu_torch.transform.rigid import Rigid3

# Point capacities of the matcher clouds: the first points of the filtered
# clouds are kept (the JAX module's pinned capacities).
HIGH_CAP = 256
LOW_CAP = 512


@dataclasses.dataclass
class Matcher3D:
    """A finished submap's loop-closure state, built once
    (DispatchScanMatcherConstruction, constraint_builder_3d.cc:150-176)."""

    stack: PrecomputationStack3D
    high_grid: Grid3D
    low_grid: Grid3D
    low_probability: torch.Tensor
    histogram: torch.Tensor


@dataclasses.dataclass
class MatchResult3D:
    """One accepted match: the node pose in the grid (local) frame and the
    scores the reference logs."""

    submap_id: SubmapId
    node_id: NodeId
    grid_t: np.ndarray  # (3,)
    grid_q: np.ndarray  # (4,)
    score: float
    rotational_score: float
    low_resolution_score: float


@dataclasses.dataclass
class MatchRequest3D:
    """One gated (node, submap) candidate. A `match_full` request searches
    the whole submap over the full yaw circle; `init_q` then holds the
    node's rotation relative to the submap and `init_t` is unused."""

    submap_id: SubmapId
    node_id: NodeId
    matcher: Matcher3D
    high_points: np.ndarray  # (n, 3)
    low_points: np.ndarray  # (m, 3)
    scan_histogram: np.ndarray
    init_t: np.ndarray  # (3,) node translation estimate in the grid frame
    init_q: np.ndarray  # (4,)
    match_full: bool = False


def _pad_cloud(cloud: np.ndarray, cap: int):
    pts = np.zeros((cap, 3), np.float32)
    n = min(len(cloud), cap)
    pts[:n] = cloud[:n]
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pts, mask


def _unit(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return q / max(np.linalg.norm(q), 1e-12)


class ConstraintBuilder3D:
    def __init__(self, options: ConstraintBuilderOptions, device="cuda"):
        self._options = options
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ConstraintBuilder3D: no CUDA device is available; "
                               "pass device='cpu' to run the plain PyTorch path")
        fcsm = options.fast_correlative_scan_matcher_3d
        self.bnb_params = FastCorrelativeMatcherParams3D(
            branch_and_bound_depth=fcsm.branch_and_bound_depth,
            full_resolution_depth=fcsm.full_resolution_depth,
            min_rotational_score=fcsm.min_rotational_score,
            min_low_resolution_score=fcsm.min_low_resolution_score,
            linear_xy_search_window=fcsm.linear_xy_search_window,
            linear_z_search_window=fcsm.linear_z_search_window,
            angular_search_window=fcsm.angular_search_window)
        gn = options.ceres_scan_matcher_3d
        self.gn_params = GaussNewtonMatcherParams3D(
            occupied_space_weight_0=gn.occupied_space_weight_0,
            occupied_space_weight_1=gn.occupied_space_weight_1,
            translation_weight=gn.translation_weight, rotation_weight=gn.rotation_weight,
            only_optimize_yaw=gn.only_optimize_yaw, num_iterations=gn.max_num_iterations)
        self._samplers: Dict[SubmapId, FixedRatioSampler] = {}
        self._matchers: Dict[SubmapId, Matcher3D] = {}
        self.score_histogram = Histogram()
        # Pairs matched and the wall seconds spent on them.
        self.pairs_matched = 0
        self.match_seconds = 0.0
        factory = metrics.GLOBAL_FACTORY
        found = factory.new_counter_family(
            "mapping_constraints_constraint_builder_3d_constraints", "Constraints computed")
        self._metric_found = found.add({"search_region": "local_search", "matcher": "searched"})
        self._metric_found_global = found.add({"search_region": "global_search",
                                               "matcher": "searched"})
        scores = factory.new_histogram_family(
            "mapping_constraints_constraint_builder_3d_scores", "Constraint scores built",
            [0.05 * i for i in range(1, 20)])
        self._metric_scores = scores.add({"search_region": "local_search", "kind": "score"})
        self._metric_scores_global = scores.add({"search_region": "global_search",
                                                 "kind": "score"})
        self._metric_rot_scores = scores.add({"search_region": "local_search",
                                              "kind": "rotational_score"})
        self._metric_low_scores = scores.add({"search_region": "local_search",
                                              "kind": "low_resolution_score"})
        # Guards the samplers and the matcher cache across background threads.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ cache

    def matcher_for(self, submap_id: SubmapId, submap) -> Optional[Matcher3D]:
        """The submap's matcher, built on first use from its dense crops."""
        with self._lock:
            cached = self._matchers.get(submap_id)
            if cached is not None:
                return cached
            high, low = submap.high_grid, submap.low_grid
            if high is None or low is None:
                return None
            matcher = Matcher3D(
                build_precomputation_stack_3d(high, self.bnb_params.branch_and_bound_depth,
                                              self.bnb_params.full_resolution_depth),
                high, low, low.probability(),
                to_device(np.asarray(submap.histogram, np.float32), self._device))
            self._matchers[submap_id] = matcher
            return matcher

    # ------------------------------------------------------------------ gating

    def begin_constraint(self, submap_id: SubmapId, submap, node_id: NodeId,
                         high_points: np.ndarray, low_points: np.ndarray,
                         scan_histogram: np.ndarray, init_t: np.ndarray, init_q: np.ndarray,
                         relative_distance: float = 0.0) -> Optional[MatchRequest3D]:
        """MaybeAddConstraint's gates (constraint_builder_3d.cc:79-103):
        max_constraint_distance and per-submap sampling."""
        if len(high_points) == 0 or relative_distance > self._options.max_constraint_distance:
            return None
        with self._lock:
            sampler = self._samplers.setdefault(
                submap_id, FixedRatioSampler(self._options.sampling_ratio))
            if not sampler.pulse():
                return None
        matcher = self.matcher_for(submap_id, submap)
        if matcher is None:
            return None
        return MatchRequest3D(submap_id, node_id, matcher,
                              np.asarray(high_points, np.float32)[:, :3],
                              np.asarray(low_points, np.float32)[:, :3],
                              np.asarray(scan_histogram, np.float32),
                              np.asarray(init_t, np.float64), np.asarray(init_q, np.float64))

    def begin_global_constraint(self, submap_id: SubmapId, submap, node_id: NodeId,
                                high_points: np.ndarray, low_points: np.ndarray,
                                scan_histogram: np.ndarray, relative_q: np.ndarray
                                ) -> Optional[MatchRequest3D]:
        """Full-submap request (MaybeAddGlobalConstraint,
        constraint_builder_3d.cc:116-148): the pose graph's global sampler is
        the only gate; `relative_q` is the node's rotation relative to the
        submap (yaw arbitrary, gravity shared)."""
        if len(high_points) == 0:
            return None
        matcher = self.matcher_for(submap_id, submap)
        if matcher is None:
            return None
        return MatchRequest3D(submap_id, node_id, matcher,
                              np.asarray(high_points, np.float32)[:, :3],
                              np.asarray(low_points, np.float32)[:, :3],
                              np.asarray(scan_histogram, np.float32), np.zeros(3),
                              np.asarray(relative_q, np.float64), match_full=True)

    # ------------------------------------------------------------------ API

    def compute_constraints(self, requests: List[MatchRequest3D]) -> List[MatchResult3D]:
        """Match the requests: local ones back to back with one blocking copy
        of all their rows, full-submap ones one certified search each."""
        if not requests:
            return []
        t0 = time.monotonic()
        results: List[MatchResult3D] = []
        local = [r for r in requests if not r.match_full]
        if local:
            results += self._results_from_rows(local, self.raw_local(local).cpu().numpy())
        for r in requests:
            if r.match_full:
                res = self._compute_global(r)
                if res is not None:
                    results.append(res)
        with self._lock:
            self.pairs_matched += len(requests)
            self.match_seconds += time.monotonic() - t0
        return results

    def _refine(self, r: MatchRequest3D, clouds, translation: torch.Tensor,
                rotation: torch.Tensor) -> torch.Tensor:
        hp, hm, lp, lm = clouds
        m = r.matcher
        refined, _ = gauss_newton_match_3d(m.high_grid, m.low_grid, hp, hm, lp, lm,
                                           Rigid3(translation, rotation), self.gn_params)
        return torch.cat([refined.translation, refined.rotation])

    def _clouds(self, requests: List[MatchRequest3D]):
        """The requests' clouds padded to the capacities, uploaded in one copy:
        per request (high points, mask, low points, mask)."""
        n = len(requests)
        high = [_pad_cloud(r.high_points, HIGH_CAP) for r in requests]
        low = [_pad_cloud(r.low_points, LOW_CAP) for r in requests]
        packed = np.concatenate([
            np.stack([h[0] for h in high]).reshape(n, -1),
            np.stack([h[1] for h in high]).astype(np.float32),
            np.stack([x[0] for x in low]).reshape(n, -1),
            np.stack([x[1] for x in low]).astype(np.float32),
            np.stack([r.scan_histogram for r in requests]),
            np.stack([np.concatenate([r.init_t, r.init_q]) for r in requests])],
            axis=1).astype(np.float32)
        dev = to_device(packed, self._device)
        o, out = 0, []
        for size, shape in ((3 * HIGH_CAP, (HIGH_CAP, 3)), (HIGH_CAP, bool),
                            (3 * LOW_CAP, (LOW_CAP, 3)), (LOW_CAP, bool),
                            (requests[0].scan_histogram.shape[0], None), (7, None)):
            field = dev[:, o:o + size]
            out.append(field > 0.5 if shape is bool else field if shape is None
                       else field.reshape(n, *shape))
            o += size
        return out

    def raw_local(self, requests: List[MatchRequest3D]) -> torch.Tensor:
        """(B, 10) device rows [score, refined t (3), q (4), rotational score,
        low-resolution score] of local requests, not yet thresholded:
        `_match_impl_3d` (l.60), the BnB then the GN refine of its pose."""
        hp, hm, lp, lm, hist, init = self._clouds(requests)
        rows = []
        for i, r in enumerate(requests):
            m = r.matcher
            clouds = (hp[i].contiguous(), hm[i].contiguous(), lp[i].contiguous(),
                      lm[i].contiguous())
            out = fast_correlative_match_3d(
                m.stack, m.high_grid, m.low_grid, clouds[0], clouds[1], clouds[2], clouds[3],
                hist[i].contiguous(), m.histogram, init[i, 0:3].contiguous(),
                init[i, 3:7].contiguous(), self.bnb_params, self._options.min_score,
                low_probability=m.low_probability)
            refined = self._refine(r, clouds, out[2:5], out[5:9])
            rows.append(torch.cat([out[1:2], refined, out[9:11]]))
        return torch.stack(rows)

    def _compute_global(self, r: MatchRequest3D) -> Optional[MatchResult3D]:
        """One full-submap search (ComputeConstraint with match_full_submap,
        constraint_builder_3d.cc:178-277), thresholded at
        global_localization_min_score, then the GN refine."""
        hp, hm, lp, lm, hist, _ = (x[0].contiguous() for x in self._clouds([r]))
        m = r.matcher
        min_score = float(self._options.global_localization_min_score)
        identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=self._device)
        found, score, t, q, rot, low, _ = match_full_submap_3d_exact(
            m.stack, m.high_grid, m.low_grid, hp, hm, lp, lm, hist, m.histogram,
            to_device(np.asarray(r.init_q, np.float32), self._device), identity,
            self.bnb_params, min_score, low_probability=m.low_probability)
        self.score_histogram.add(score)
        self._metric_scores_global.observe(score)
        if not found or score < min_score:
            return None
        refined = self._refine(r, (hp, hm, lp, lm), to_device(t.astype(np.float32), self._device),
                               to_device(q.astype(np.float32), self._device)).cpu().numpy()
        if not np.all(np.isfinite(refined)):
            return None
        self._metric_found_global.increment()
        return MatchResult3D(r.submap_id, r.node_id, refined[0:3].astype(np.float64),
                             _unit(refined[3:7]), score, rot, low)

    def _results_from_rows(self, requests: List[MatchRequest3D], rows: np.ndarray
                           ) -> List[MatchResult3D]:
        min_score = self._options.min_score
        out = []
        for r, row in zip(requests, rows):
            score = float(row[0])
            self.score_histogram.add(score)
            self._metric_scores.observe(score)
            self._metric_rot_scores.observe(float(row[8]))
            self._metric_low_scores.observe(float(row[9]))
            if score <= min_score or not np.all(np.isfinite(row[1:8])):
                continue
            self._metric_found.increment()
            out.append(MatchResult3D(r.submap_id, r.node_id, row[1:4].astype(np.float64),
                                     _unit(row[4:8]), score, float(row[8]), float(row[9])))
        return out
