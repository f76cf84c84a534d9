"""Build and load the package's CUDA sources.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build runs at first use, writes into
``nerf_simple_tpu_torch/build/``, and is redone only when the source's
hash (with the shared ``csrc/*.cuh`` headers) changes. ``build`` starts
one ``nvcc`` for each of several sources at once; ``build_copies`` builds
sources of other copies of csrc/ (an earlier commit's, or a variant's)
the same way, for comparisons on the card. Nothing here runs at import time: machines without
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
import time
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
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str) -> dict[str, float]:
    """Compile the named sources whose build is missing, one ``nvcc``
    each, all started together; returns each compile's wall seconds."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, t0 = _nvcc(), time.perf_counter()
    jobs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in jobs.items():
        build_log[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))  # atomic: no half-written library
        else:
            os.remove(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"csrc/{n}.cu:\n{build_log[n]}" for n in failed))
    return seconds


def build_copies(dirs, names) -> dict[str, dict[str, ctypes.CDLL]]:
    """Compile the named sources of other copies of csrc/ (``dirs``) with
    the package's flags, each into ``<dir>/../build/``, one ``nvcc`` each,
    all started together, and load them: ``{dir: {name: library}}``.
    nvcc's output lands in ``build_log`` under ``<dir>/<name>``; raises on
    a failed build."""
    jobs = {}
    for d in dirs:
        out = Path(d).resolve().parent / "build"
        out.mkdir(parents=True, exist_ok=True)
        for name in names:
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(d), "-o", str(out / f"{name}.so"), str(Path(d) / f"{name}.cu")]
            jobs[d, name] = (out / f"{name}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                                 stderr=subprocess.STDOUT, text=True))
    libs: dict[str, dict[str, ctypes.CDLL]] = {d: {} for d in dirs}
    for (d, name), (so, proc) in jobs.items():
        build_log[f"{d}/{name}"] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {d}/{name}.cu:\n{build_log[f'{d}/{name}']}")
        libs[d][name] = ctypes.CDLL(str(so))
    return libs


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel's mangled name, ptxas's line) for each register and spill
    line of an nvcc log built with ``-Xptxas -v``."""
    out, kernel = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            out.append((kernel, line.strip()))
    return out


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its build is missing, and load it."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
