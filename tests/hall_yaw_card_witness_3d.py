"""The 3D frontend at its full options on the card with the JAX package's
voxel-filter permutations injected: the card's side of the yaw witness.

`tests/hall_yaw_witness_3d.py` runs the JAX builder and the port's plain
path on the CPU, the plain path with the JAX permutations. `chip_smoke.py`'s
full-frontend phase runs the card with its own permutations (CUDA
`torch.randperm`), which draw other voxel subsets. Run on the card with the
JAX permutations, the phase tells whether the card's kernels (K17, K11)
depart from the plain path or only its permutations differ.

Two steps, since the machine with the card has no JAX:

    JAX_PLATFORMS=cpu python tests/hall_yaw_card_witness_3d.py permutations PERMS.npy
    python tests/hall_yaw_card_witness_3d.py card PERMS.npy [seed ...]

The first writes the permutations the JAX builder's seeds 1..450 draw for
4,096 points (write it into a git-ignored directory such as `_checkout/`);
the second runs the phase's 400 scans of the half-scale hall with
intensities for each seed (default 0 1 2) on the card and prints one JSON
object with each seed's mean yaw and position error; each seed's poses
[x, y, z, yaw] go to `card_est_seed<seed>.npy` beside PERMS.npy.

The other way round, on the card:

    python tests/hall_yaw_card_witness_3d.py card-permutations PERMS.npy

writes the permutations the card draws itself (CUDA `torch.randperm` with
the builder's seeds), which `card` then replays as the smoke's phase does
and `tests/hall_yaw_witness_3d.py 400 SEED PERMS.npy` feeds to the plain
path on the CPU: the card and the plain path on the same inputs.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCANS = 400
SEEDS = 450  # the builder's permutation seeds count from 1, one per scan
POINTS = 4096  # the default 3D scan capacity


def permutations(path: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    perms = np.stack([np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), POINTS))
                      for seed in range(1, SEEDS + 1)]).astype(np.int32)
    np.save(path, perms)


def card_permutations(path: str) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    g = torch.Generator(device="cuda:0")
    perms = []
    for seed in range(1, SEEDS + 1):  # as LocalTrajectoryBuilder3D._permutation
        g.manual_seed(seed)
        perms.append(torch.randperm(POINTS, generator=g, device="cuda:0",
                                    dtype=torch.int32).cpu().numpy())
    np.save(path, np.stack(perms))


def card(path: str, seeds) -> dict:
    import torch

    import chip_smoke
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.ops import cuda

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    cuda.build()
    perms = np.load(path)
    out = {"card": chip_smoke._smi()}
    for seed in seeds:
        events, gt = chip_smoke._events_3d(SCANS, seed=seed, intensities=True)
        builder = LocalTrajectoryBuilder3D(chip_smoke._full_frontend_options(), ["points"],
                                           device=dev,
                                           permutation_fn=lambda s, n: perms[s - 1][:n])
        est, offset, yaw, _, _, _ = chip_smoke._drive_3d(torch, builder, events, gt,
                                                         f"seed {seed}")
        np.save(os.path.join(os.path.dirname(path) or ".", f"card_est_seed{seed}.npy"), est)
        out[str(seed)] = dict(mean_yaw_error_rad=float(yaw.mean()),
                              mean_error_m=float(np.linalg.norm(offset, axis=1).mean()),
                              yaw_error_by_20_scans_rad=[float(yaw[i:i + 20].mean())
                                                         for i in range(0, SCANS, 20)])
    return out


if __name__ == "__main__":
    if sys.argv[1] == "permutations":
        permutations(sys.argv[2])
    elif sys.argv[1] == "card-permutations":
        card_permutations(sys.argv[2])
    else:
        print(json.dumps(card(sys.argv[2], [int(s) for s in sys.argv[3:]] or [0, 1, 2])))
