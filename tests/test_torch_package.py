"""Package-level properties of the PyTorch port: it stands alone (no JAX,
nothing of the JAX package), it never falls back to the CPU silently, and
its options carry across from the JAX package's."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cartographer_tpu.core.config import (
    MapBuilderOptions as JMapBuilderOptions,
    TrajectoryBuilder2DOptions as JOptions,
    TrajectoryBuilderOptions as JTrajectoryOptions,
    apply_overrides,
)
from cartographer_tpu_torch.core.config import (
    MapBuilderOptions,
    TrajectoryBuilder2DOptions,
    TrajectoryBuilderOptions,
)
from cartographer_tpu_torch.interop import (
    UNPORTED_3D_SWITCHES,
    UNPORTED_MAP_BUILDER_SWITCHES,
    UNPORTED_SWITCHES,
    UNPORTED_TRAJECTORY_SWITCHES,
    UNREAD_3D_OPTIONS,
    UNREAD_MAP_BUILDER_OPTIONS,
    UNREAD_OPTIONS,
    UNREAD_TRAJECTORY_OPTIONS,
    map_builder_options_from_dict,
    options_from_dict,
    trajectory_builder_options_from_dict,
)
from cartographer_tpu_torch.ops import cuda
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import LocalTrajectoryBuilder2D

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, cartographer_tpu_torch\n"
        "prefix = 'cartographer_tpu_torch.'\n"
        "for m in pkgutil.walk_packages(cartographer_tpu_torch.__path__, prefix):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cartographer_tpu' or m.startswith('cartographer_tpu.')]\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_no_jax():
    source = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in source and "from jax" not in source
    assert "cartographer_tpu." not in source.replace("cartographer_tpu_torch", "")


def test_builder_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalTrajectoryBuilder2D(TrajectoryBuilder2DOptions(), ["laser"])


def _flat(d, prefix=""):
    out = {}
    for key, value in d.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def test_options_carry_across():
    jopts = apply_overrides(JOptions(), {"submaps.num_range_data": 7, "tpu.ray_samples": 64,
                                         "adaptive_voxel_filter.max_length": 0.4})
    port = _flat(dataclasses.asdict(options_from_dict(dataclasses.asdict(jopts))))
    jax = _flat(dataclasses.asdict(jopts))
    assert port == {key: jax[key] for key in port}
    dropped = tuple(UNPORTED_SWITCHES) + UNREAD_OPTIONS
    for key in set(jax) - set(port):
        assert any(key == p or key.startswith(p + ".") for p in dropped), key
    assert options_from_dict(dataclasses.asdict(JOptions())) == TrajectoryBuilder2DOptions()


@pytest.mark.parametrize("path,value", [
    ("num_accumulated_range_data", 2),
    ("pose_extrapolator.use_imu_based", True),
])
def test_unported_switches_raise(path, value):
    jopts = apply_overrides(JOptions(), {path: value})
    with pytest.raises(NotImplementedError, match=path):
        options_from_dict(dataclasses.asdict(jopts))


def test_tsdf_inserter_switch_is_carried():
    """The TSDF inserter's switch and options, once refused, are carried as
    the JAX options hold them."""
    jopts = apply_overrides(JOptions(), {
        "submaps.grid_type": "TSDF", "submaps.range_data_inserter_type": "TSDF_INSERTER_2D",
        "submaps.tsdf_range_data_inserter.update_weight_range_exponent": 2})
    port = options_from_dict(dataclasses.asdict(jopts))
    assert dataclasses.asdict(port.submaps) == dataclasses.asdict(jopts.submaps)


def test_unported_options_are_not_settable():
    with pytest.raises(TypeError):
        apply_overrides(TrajectoryBuilder2DOptions(), {"num_accumulated_range_data": 2})


def test_2d_builder_refuses_the_imu_based_extrapolator():
    """The pose-extrapolator options are shared with 3D, where the
    IMU-based extrapolator is ported; the 2D builder refuses it (the JAX
    package's 2D builder never reads the switch)."""
    options = apply_overrides(TrajectoryBuilder2DOptions(),
                              {"pose_extrapolator.use_imu_based": True})
    with pytest.raises(NotImplementedError, match="IMU-based"):
        LocalTrajectoryBuilder2D(options, ["laser"], device="cpu")


def _assert_carried(jopts, port, dropped):
    port = _flat(dataclasses.asdict(port))
    jax = _flat(dataclasses.asdict(jopts))
    assert port == {key: jax[key] for key in port}
    for key in set(jax) - set(port):
        assert any(key == p or key.startswith(p + ".") for p in dropped), key


def test_map_builder_options_carry_across():
    jopts = apply_overrides(JMapBuilderOptions(use_trajectory_builder_2d=True), {
        "pose_graph.optimize_every_n_nodes": 12,
        "pose_graph.constraint_builder.fast_correlative_scan_matcher.beam_width": 512,
        "async_constraint_search": False})
    _assert_carried(jopts, map_builder_options_from_dict(dataclasses.asdict(jopts)),
                    tuple(UNPORTED_MAP_BUILDER_SWITCHES) + UNREAD_MAP_BUILDER_OPTIONS)
    jtraj = apply_overrides(JTrajectoryOptions(), {
        "trajectory_builder_2d.use_online_correlative_scan_matching": True,
        "trajectory_builder_2d.real_time_correlative_scan_matcher.linear_search_window": 0.2})
    _assert_carried(jtraj, trajectory_builder_options_from_dict(dataclasses.asdict(jtraj)),
                    tuple(UNPORTED_TRAJECTORY_SWITCHES) + UNREAD_TRAJECTORY_OPTIONS
                    + tuple("trajectory_builder_2d." + p
                            for p in tuple(UNPORTED_SWITCHES) + UNREAD_OPTIONS)
                    + tuple("trajectory_builder_3d." + p
                            for p in tuple(UNPORTED_3D_SWITCHES) + UNREAD_3D_OPTIONS))
    assert map_builder_options_from_dict(
        dataclasses.asdict(JMapBuilderOptions())) == MapBuilderOptions()
    j3d = apply_overrides(JMapBuilderOptions(use_trajectory_builder_3d=True), {
        "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d.branch_and_bound_depth": 6,
        "pose_graph.optimization_problem.fix_z_in_3d": True})
    _assert_carried(j3d, map_builder_options_from_dict(dataclasses.asdict(j3d)),
                    tuple(UNPORTED_MAP_BUILDER_SWITCHES) + UNREAD_MAP_BUILDER_OPTIONS)
    assert trajectory_builder_options_from_dict(
        dataclasses.asdict(JTrajectoryOptions())) == TrajectoryBuilderOptions()


@pytest.mark.parametrize("path,value", [
    ("batch_scan_dispatch", True),
    ("pose_graph.overlapping_submaps_trimmer_2d", {"fresh_submaps_count": 1}),
    ("pose_graph.overlapping_submaps_trimmer_2d", {"min_covered_area": 5.0}),
])
def test_unported_map_builder_switches_raise(path, value):
    jopts = apply_overrides(JMapBuilderOptions(), {path: value})
    with pytest.raises(NotImplementedError, match=path):
        map_builder_options_from_dict(dataclasses.asdict(jopts))


def test_pure_localization_trimmer_raises():
    jtraj = apply_overrides(JTrajectoryOptions(), {"pure_localization_trimmer": {"x": 3}})
    with pytest.raises(NotImplementedError, match="pure_localization_trimmer"):
        trajectory_builder_options_from_dict(dataclasses.asdict(jtraj))


def test_concurrent_first_launches_build_once(monkeypatch, tmp_path):
    import ctypes
    import threading
    import time

    built = []

    def fake_build(sources):
        built.append(tuple(sources))
        time.sleep(0.2)  # a build takes a while: the other threads arrive meanwhile
        (tmp_path / "lib.so").write_bytes(b"")

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(cuda, "library_path", lambda source: tmp_path / "lib.so")
    monkeypatch.setattr(cuda, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    kernel = cuda.CudaKernel("fake.cu", "fake_symbol", [])
    try:
        threads = [threading.Thread(target=kernel._load) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        cuda.KERNELS.pop("fake_symbol", None)
    assert built == [("fake.cu",)]
