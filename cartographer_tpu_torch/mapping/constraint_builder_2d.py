"""Loop-closure constraint search.

Counterpart of the JAX package's `mapping/constraint_builder_2d.py`
(constraint_builder_2d.cc) on one device: gated and sampled (node, submap)
requests, a per-submap cache of the precomputation pyramid (K6), the
branch-and-bound match (K7) followed by a Gauss-Newton refine (K3), and an
INTER_SUBMAP constraint for every match above `min_score`. The local
requests of a batch are one BnB launch and their results come back in one
blocking copy; full-submap (global) requests widen their beam in waves until
each result is certified, one BnB launch and one blocking copy per wave.
"""

from __future__ import annotations

import dataclasses
import math
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
from cartographer_tpu_torch.ops.bnb_2d import (
    FastCorrelativeMatcherParams2D,
    build_precomputation_pyramid,
    fast_correlative_match_2d_batch,
    full_submap_window,
    grid_center_pose,
)
from cartographer_tpu_torch.ops.grid_2d import Grid2D
from cartographer_tpu_torch.ops.scan_matcher_2d import GaussNewtonMatcherParams2D, lm_match_2d

_MAX_GLOBAL_BEAM = 65536


@dataclasses.dataclass
class Constraint:
    """pose_graph_interface.h Constraint: submap i <- node j relative pose."""

    submap_id: SubmapId
    node_id: NodeId
    rel: np.ndarray  # (3,) [x, y, theta]: node pose in submap frame
    translation_weight: float
    rotation_weight: float
    tag: str  # "INTRA_SUBMAP" | "INTER_SUBMAP"
    score: float = 0.0


@dataclasses.dataclass
class MatchRequest:
    """One gated (node, submap) candidate awaiting matching."""

    submap_id: SubmapId
    node_id: NodeId
    grid: Grid2D
    points: np.ndarray  # (n, 2)
    init: np.ndarray  # (3,) node pose estimate in the grid frame
    match_full: bool


def _pow2_points(groups: List[np.ndarray]):
    """Stack point sets (n_i, 2) into (B, P, 2) + mask, P a power of two >= 16."""
    cap = 1 << math.ceil(math.log2(max(max(len(p) for p in groups), 16)))
    pts = np.zeros((len(groups), cap, 2), np.float32)
    mask = np.zeros((len(groups), cap), bool)
    for i, p in enumerate(groups):
        n = min(len(p), cap)
        pts[i, :n] = p[:n]
        mask[i, :n] = True
    return pts, mask


class ConstraintBuilder2D:
    def __init__(self, options: ConstraintBuilderOptions, device="cuda"):
        self._options = options
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ConstraintBuilder2D: no CUDA device is available; "
                               "pass device='cpu' to run the plain PyTorch path")
        fcsm = options.fast_correlative_scan_matcher
        self._bnb_params = FastCorrelativeMatcherParams2D(
            linear_search_window=fcsm.linear_search_window,
            angular_search_window=fcsm.angular_search_window,
            branch_and_bound_depth=fcsm.branch_and_bound_depth,
            beam_width=fcsm.beam_width, max_scan_range=fcsm.max_scan_range)
        gn = options.ceres_scan_matcher
        self._gn_params = GaussNewtonMatcherParams2D(
            occupied_space_weight=gn.occupied_space_weight,
            translation_weight=gn.translation_weight, rotation_weight=gn.rotation_weight,
            num_iterations=gn.max_num_iterations,
            use_nonmonotonic_steps=gn.use_nonmonotonic_steps)
        self._samplers: Dict[SubmapId, FixedRatioSampler] = {}
        # Start beam of full-submap searches, tuned by the last batch's
        # certifying beam (see _raw_globals).
        self._global_beam_hint = self._bnb_params.beam_width
        self._pyramids: Dict[SubmapId, torch.Tensor] = {}
        self.score_histogram = Histogram()
        # Pairs matched and wall seconds spent matching them.
        self.pairs_matched = 0
        self.match_seconds = 0.0
        # Whether each request of the last full-submap batch came back
        # certified optimal, and the beam that certified it (0 if none).
        self.last_global_certified: List[bool] = []
        self.last_global_beams: List[int] = []
        factory = metrics.GLOBAL_FACTORY
        found = factory.new_counter_family(
            "mapping_constraints_constraint_builder_2d_constraints", "Constraints computed")
        self._metric_found = found.add({"search_region": "local_search", "matcher": "searched"})
        self._metric_found_global = found.add({"search_region": "global_search",
                                               "matcher": "searched"})
        scores = factory.new_histogram_family(
            "mapping_constraints_constraint_builder_2d_scores", "Constraint scores built",
            [0.05 * i for i in range(1, 20)])
        self._metric_scores = scores.add({"search_region": "local_search"})
        self._metric_scores_global = scores.add({"search_region": "global_search"})
        # Guards the samplers and the pyramid cache when searches run on
        # the pose graph's background threads.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ cache

    def _pyramid_for(self, submap_id: SubmapId, grid: Grid2D) -> torch.Tensor:
        with self._lock:
            if submap_id not in self._pyramids:
                self._pyramids[submap_id] = build_precomputation_pyramid(
                    grid, self._bnb_params.branch_and_bound_depth)
            return self._pyramids[submap_id]

    # ------------------------------------------------------------------ gating

    def begin_constraint(self, submap_id: SubmapId, grid: Grid2D, node_id: NodeId,
                         node_points: np.ndarray, initial_grid_pose: np.ndarray,
                         relative_distance: float = 0.0) -> Optional[MatchRequest]:
        """Gates of the local-window search (constraint_builder_2d.cc:77-111):
        max_constraint_distance and per-submap sampling."""
        if relative_distance > self._options.max_constraint_distance:
            return None
        with self._lock:
            sampler = self._samplers.setdefault(
                submap_id, FixedRatioSampler(self._options.sampling_ratio))
            if not sampler.pulse():
                return None
        return MatchRequest(submap_id, node_id, grid, np.asarray(node_points)[:, :2],
                            np.asarray(initial_grid_pose, np.float64), match_full=False)

    def begin_global_constraint(self, submap_id: SubmapId, grid: Grid2D, node_id: NodeId,
                                node_points: np.ndarray) -> MatchRequest:
        """Full-submap search request (constraint_builder_2d.cc:114-137); it
        starts at the grid's center."""
        return MatchRequest(submap_id, node_id, grid, np.asarray(node_points)[:, :2],
                            np.zeros(3), match_full=True)

    # ------------------------------------------------------------------ API

    def compute_constraints(self, requests: List[MatchRequest]) -> List[Constraint]:
        requests = [r for r in requests if len(r.points) > 0]
        if not requests:
            return []
        return self._constraints_from_raw(requests, self.raw_results(requests))

    def raw_results(self, requests: List[MatchRequest]) -> np.ndarray:
        """(len(requests), 4) float32 [score, x, y, theta]: refined matches,
        not yet thresholded (the pose is NaN for a global request below
        global_localization_min_score)."""
        t0 = time.monotonic()
        out = np.zeros((len(requests), 4), np.float32)
        local = [i for i, r in enumerate(requests) if not r.match_full]
        globals_ = [i for i, r in enumerate(requests) if r.match_full]
        if globals_:
            out[globals_] = self._raw_globals([requests[i] for i in globals_])
        if local:
            out[local] = self._raw_local([requests[i] for i in local]).cpu().numpy()
        with self._lock:
            self.pairs_matched += len(requests)
            self.match_seconds += time.monotonic() - t0
        return out

    def _constraints_from_raw(self, requests: List[MatchRequest],
                              raw: np.ndarray) -> List[Constraint]:
        constraints: List[Constraint] = []
        for r, row in zip(requests, raw):
            score = float(row[0])
            rel = np.asarray(row[1:], np.float64)
            self.score_histogram.add(score)
            if r.match_full:
                self._metric_scores_global.observe(score)
                min_score = self._options.global_localization_min_score
            else:
                self._metric_scores.observe(score)
                min_score = self._options.min_score
            if score < min_score or not np.all(np.isfinite(rel)):
                continue
            (self._metric_found_global if r.match_full else self._metric_found).increment()
            constraints.append(Constraint(
                submap_id=r.submap_id, node_id=r.node_id, rel=rel,
                translation_weight=self._options.loop_closure_translation_weight,
                rotation_weight=self._options.loop_closure_rotation_weight,
                tag="INTER_SUBMAP", score=score))
        return constraints

    def _refine(self, grid: Grid2D, pts: torch.Tensor, mask: torch.Tensor,
                pose: torch.Tensor) -> torch.Tensor:
        refined, _, _ = lm_match_2d(grid, pts, mask, pose, pose[0:2], self._gn_params)
        return refined

    def _raw_local(self, group: List[MatchRequest]) -> torch.Tensor:
        """(B, 4) device rows for local requests: one BnB launch for the
        group over the configured window, then the GN refine of each pose.
        The inputs go up in one copy and the rows come back in one."""
        pts, mask = _pow2_points([r.points for r in group])
        pts_d = to_device(pts, self._device)
        mask_d = to_device(mask, self._device)
        inits = to_device(np.stack([r.init for r in group]).astype(np.float32), self._device)
        out = fast_correlative_match_2d_batch(
            [self._pyramid_for(r.submap_id, r.grid) for r in group], [r.grid for r in group],
            pts_d, mask_d, inits, self._bnb_params, min_score=0.0)
        rows = [torch.cat([out[i, 0:1], self._refine(r.grid, pts_d[i], mask_d[i], out[i, 1:4])])
                for i, r in enumerate(group)]
        return torch.stack(rows)

    def _raw_globals(self, reqs: List[MatchRequest]) -> np.ndarray:
        """Full-submap searches by certified beam widening
        (fast_correlative_scan_matcher_2d.cc:210): each round runs every
        still-uncertified request at the current beam and fetches their
        [score, certified] in one copy; the rest double their beam. The
        start beam is where the last batch certified (the certificate makes
        any start exact; it only changes the cost)."""
        min_score = self._options.global_localization_min_score
        clouds = [_pow2_points([r.points]) for r in reqs]
        pts_d = [to_device(p[0], self._device) for p, _ in clouds]
        mask_d = [to_device(m[0], self._device) for _, m in clouds]
        # The waves' BnB takes every request's cloud padded to one size
        # (padding adds masked zeros, which change no score).
        all_pts, all_mask = _pow2_points([r.points for r in reqs])
        all_pts_d = to_device(all_pts, self._device)
        all_mask_d = to_device(all_mask, self._device)
        inits = torch.stack([grid_center_pose(r.grid) for r in reqs])
        n = len(reqs)
        scores = np.zeros(n, np.float32)
        poses: List[Optional[torch.Tensor]] = [None] * n
        alive = list(range(n))
        beam = start_beam = min(max(self._bnb_params.beam_width, self._global_beam_hint),
                                _MAX_GLOBAL_BEAM)
        max_certified = 0
        certified, beams = [False] * n, [0] * n
        while alive:
            params = dataclasses.replace(self._bnb_params, beam_width=beam)
            wave = fast_correlative_match_2d_batch(  # one launch per wave
                [self._pyramid_for(reqs[i].submap_id, reqs[i].grid) for i in alive],
                [reqs[i].grid for i in alive], all_pts_d[alive], all_mask_d[alive],
                inits[alive], params, min_score,
                [full_submap_window(reqs[i].grid) for i in alive])
            flat = wave[:, [0, 5]].cpu().numpy()  # one copy per round
            nxt = []
            for i, w, row in zip(alive, wave, flat):
                if row[1] >= 0.5 or beam >= _MAX_GLOBAL_BEAM:
                    scores[i] = row[0]
                    poses[i] = w[1:4]
                    certified[i] = bool(row[1] >= 0.5)
                    beams[i] = beam if certified[i] else 0
                    max_certified = max(max_certified, beam)
                else:
                    nxt.append(i)
            alive = nxt
            beam *= 2
        self.last_global_certified, self.last_global_beams = certified, beams
        if max_certified > start_beam:
            self._global_beam_hint = max_certified
        elif max_certified == start_beam:
            self._global_beam_hint = max(start_beam // 2, self._bnb_params.beam_width)
        out = np.full((n, 4), np.nan, np.float32)
        out[:, 0] = scores
        kept = [i for i in range(n) if scores[i] >= min_score]
        if kept:
            refined = torch.stack([self._refine(reqs[i].grid, pts_d[i], mask_d[i], poses[i])
                                   for i in kept])
            out[kept, 1:] = refined.cpu().numpy()
        return out
