"""Build, load and launch the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go into `csrc/_build/`, named by a hash
of the source and the flags, and are built at first use; `build()` compiles
every missing library with one `nvcc` process per source, all at once.

`-fmad=false` keeps nvcc from contracting a*b+c into one FMA: the plain
PyTorch twins round after every operation, and a contracted multiply-add
moves ray samples and voxel keys across cell boundaries.

Every kernel launch goes through a `CudaKernel`, which counts its launches,
launches on PyTorch's current stream and raises when the C function returns
a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
KERNELS: Dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(source: str) -> Path:
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(sources: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library among `sources` (default: all of
    `csrc/*.cu`), one nvcc process per source, in parallel. Returns the
    wall seconds spent; raises with nvcc's output on a failed build."""
    if sources is None:
        sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    t0 = time.monotonic()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for source in sources:
            out = library_path(source)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
            procs.append((source, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for source, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{source}:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.monotonic() - t0


class CudaKernel:
    """One exported C function `symbol` of `csrc/<source>`.

    The C function takes its pointers and the stream as `void*` and returns
    `cudaGetLastError()` after the launch. `launches` counts the launches
    made through this object."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self._argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self._fn = None
        self.launches = 0
        KERNELS[symbol] = self

    def _load(self):
        if self._fn is None:
            path = library_path(self.source)
            if not path.exists():
                build([self.source])
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._load()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def reset_launch_counts() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `shape`)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
