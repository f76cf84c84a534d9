"""Build and load the package's CUDA sources.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build runs at first use, writes into
``nerf_simple_tpu_torch/build/``, and is redone only when the source's
hash changes. Nothing here runs at import time: machines without
``nvcc`` import the package and use the plain PyTorch versions on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source name -> nvcc's output of the last build


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives: keyed by the source's
    and the flags' hash."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its build is missing, and load it."""
    if name in _loaded:
        return _loaded[name]
    lib_path = library_path(name)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                capture_output=True, text=True,
            )
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu:\n{build_log[name]}"
                )
            os.replace(tmp, lib_path)  # atomic: no half-written library
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib
