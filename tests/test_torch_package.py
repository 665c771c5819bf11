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

from cartographer_tpu.core.config import TrajectoryBuilder2DOptions as JOptions, apply_overrides
from cartographer_tpu_torch.core.config import TrajectoryBuilder2DOptions
from cartographer_tpu_torch.interop import UNPORTED_SWITCHES, UNREAD_OPTIONS, options_from_dict
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
    ("submaps.range_data_inserter_type", "TSDF_INSERTER_2D"),
])
def test_unported_switches_raise(path, value):
    jopts = apply_overrides(JOptions(), {path: value})
    with pytest.raises(NotImplementedError, match=path):
        options_from_dict(dataclasses.asdict(jopts))


def test_unported_options_are_not_settable():
    with pytest.raises(TypeError):
        apply_overrides(TrajectoryBuilder2DOptions(), {"num_accumulated_range_data": 2})
