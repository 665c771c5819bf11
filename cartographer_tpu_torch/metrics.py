"""Metric families with null-object defaults.

The subset of the JAX package's `metrics` module that the port's modules
register (the RegisterMetrics of local_trajectory_builder_2d.cc,
local_trajectory_builder_3d.cc, constraint_builder_2d.cc, pose_graph_2d.cc
and global_trajectory_builder.cc):
instrumentation costs nothing until a caller installs a collecting factory.
"""

from __future__ import annotations

from typing import Dict, List


class Counter:
    def increment(self, by: float = 1.0) -> None:
        pass


class Gauge:
    def set(self, value: float) -> None:
        pass


class Histogram:
    def observe(self, value: float) -> None:
        pass


class _Family:
    """Null family: labels -> null metric."""

    def __init__(self, metric_cls):
        self._metric_cls = metric_cls

    def add(self, labels: Dict[str, str]):
        return self._metric_cls()


class FamilyFactory:
    """Null-object default factory (metrics::FamilyFactory)."""

    def new_counter_family(self, name: str, description: str):
        return _Family(Counter)

    def new_gauge_family(self, name: str, description: str):
        return _Family(Gauge)

    def new_histogram_family(self, name: str, description: str, boundaries):
        return _Family(Histogram)


def exponential_boundaries(scale_factor: float, base: float, num: int) -> List[float]:
    return [scale_factor * (base ** i) for i in range(num)]


GLOBAL_FACTORY: FamilyFactory = FamilyFactory()


def set_global_factory(factory: FamilyFactory) -> None:
    global GLOBAL_FACTORY
    GLOBAL_FACTORY = factory
