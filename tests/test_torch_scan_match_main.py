"""The port's scan-match testbed (`io/scan_match_main.py`, plain path) and
its PCD reader against the JAX package's, on two PCD files written here."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartographer_tpu.io.pcd import read_pcd as j_read_pcd
from cartographer_tpu.io.scan_match_main import run as j_run
from cartographer_tpu.transform import Rigid3 as JRigid3, quaternion as jquat
from cartographer_tpu_torch.io import scan_match_main
from cartographer_tpu_torch.io.pcd import read_pcd
from test_ops_3d import make_environment_3d

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def write_pcd(path, points, binary=True, extra_field=False):
    """A PCD v0.7 file of x, y, z (float32), optionally with an intensity
    field between y and z, ASCII or binary."""
    points = np.asarray(points, np.float32)
    n = len(points)
    fields = ["x", "y", "intensity", "z"] if extra_field else ["x", "y", "z"]
    cols = [points[:, 0], points[:, 1]] + ([np.arange(n, dtype=np.float32)]
                                            if extra_field else []) + [points[:, 2]]
    table = np.stack(cols, -1).astype(np.float32)
    header = ("# .PCD v0.7\nVERSION 0.7\n"
              f"FIELDS {' '.join(fields)}\nSIZE {' '.join(['4'] * len(fields))}\n"
              f"TYPE {' '.join(['F'] * len(fields))}\nCOUNT {' '.join(['1'] * len(fields))}\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
              f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(table.tobytes())
        else:
            np.savetxt(f, table, fmt="%.7g")


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("extra_field", [False, True])
def test_read_pcd_matches_jax(tmp_path, binary, extra_field):
    pts = make_environment_3d(num=257, seed=4)
    path = tmp_path / "cloud.pcd"
    write_pcd(path, pts, binary, extra_field)
    got = read_pcd(str(path))
    assert got.dtype == np.float32 and got.shape == (257, 3)
    np.testing.assert_array_equal(got, j_read_pcd(str(path)))
    np.testing.assert_allclose(got, pts, atol=1e-6 * np.abs(pts).max())


def _pair_files(tmp_path, n=700, t=(0.3, -0.2, 0.1), aa=(0.0, 0.0, 0.1)):
    """Target: a room's walls; source: the target seen from the true pose."""
    world = make_environment_3d(num=n, seed=0)
    true = JRigid3(jnp.asarray(t, jnp.float32), jquat.from_axis_angle(jnp.asarray(aa,
                                                                                  jnp.float32)))
    source = np.asarray(true.inverse().apply(jnp.asarray(world)))
    paths = tmp_path / "source.pcd", tmp_path / "target.pcd"
    write_pcd(paths[0], source)
    write_pcd(paths[1], world)
    return [str(p) for p in paths]


def _args(mode, **kw):
    args = dict(mode=mode, init=[0, 0, 0, 0, 0, 0], max_iterations=30, resolution=0.3,
                max_correspondence_distance=1.0)
    args.update(kw)
    return args


@pytest.mark.parametrize("mode", ["icp", "ceres", "gicp", "ndt"])
def test_run_matches_jax(tmp_path, mode):
    """`run` on the plain path against the JAX CLI's `run`: the same keys,
    pose within 1e-4, fitness, RMSE and cost within 1e-4 (`ndt` at
    `NdtParams`' own 1 m cells)."""
    source, target = _pair_files(tmp_path)
    args = _args(mode, init=[0.05, -0.02, 0.0, 0.0, 0.0, 0.02],
                 resolution=1.0 if mode == "ndt" else 0.3)
    ref = j_run(source, target, **args)
    got = scan_match_main.run(source, target, **args, device="cpu")
    assert set(got) == set(ref) and got["mode"] == mode
    np.testing.assert_allclose(got["translation"], ref["translation"], atol=1e-4)
    np.testing.assert_allclose(got["rotation_axis_angle"], ref["rotation_axis_angle"], atol=1e-4)
    for key in set(ref) - {"mode", "translation", "rotation_axis_angle"}:
        assert got[key] == pytest.approx(ref[key], abs=1e-4, rel=1e-4), key
    if mode in ("icp", "gicp"):
        np.testing.assert_allclose(got["translation"], [0.3, -0.2, 0.1], atol=0.08)


def test_unknown_mode_raises(tmp_path):
    source, target = _pair_files(tmp_path, n=50)
    with pytest.raises(ValueError, match="unknown mode"):
        scan_match_main.run(source, target, **_args("lm"), device="cpu")


@pytest.mark.parametrize("mode", ["gicp", "ndt"])
def test_main_runs_gicp_and_ndt(tmp_path, capsys, mode):
    """`main --device cpu` prints the JAX CLI's keys and a pose within 1e-4
    of the JAX `run` on the same flags."""
    source, target = _pair_files(tmp_path, n=400)
    flags = ["--source", source, "--target", target, "--mode", mode, "--max_iterations", "10",
             "--resolution", "1.0", "--device", "cpu"]
    assert scan_match_main.main(flags) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = j_run(source, target, **_args(mode, max_iterations=10, resolution=1.0))
    assert set(printed) == set(ref) and printed["mode"] == mode
    np.testing.assert_allclose(printed["translation"], ref["translation"], atol=1e-4)
    np.testing.assert_allclose(printed["rotation_axis_angle"], ref["rotation_axis_angle"],
                               atol=1e-4)


def test_main_prints_the_json_of_run(tmp_path, capsys):
    source, target = _pair_files(tmp_path, n=300)
    assert scan_match_main.main(["--source", source, "--target", target, "--mode", "icp",
                                 "--max_iterations", "5", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = j_run(source, target, **_args("icp", max_iterations=5))
    assert set(printed) == set(ref)
    np.testing.assert_allclose(printed["translation"], ref["translation"], atol=1e-4)


def test_card_is_the_default(tmp_path, monkeypatch):
    source, target = _pair_files(tmp_path, n=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan_match_main.run(source, target, **_args("icp"))


def test_importing_the_cli_loads_no_jax():
    code = ("import sys, cartographer_tpu_torch.io.scan_match_main\n"
            "print([m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'cartographer_tpu' or m.startswith('cartographer_tpu.')])\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
