"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ctypes.

Each ``csrc/*.cu`` source has a plain C interface and compiles on its own
into ``build/kernels/<name>-<hash>.so`` under the repository root (the hash
is of the source, so an edited kernel rebuilds).  Nothing is built when a
module is imported: the CPU tests import every module and this machine may
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    """``fold_in`` -> ``kernels/fold_in/csrc/fold_in.cu``."""
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile one kernel source unless its library exists; returns
    ``(library path, nvcc's output)``.  Written to a temporary file and
    renamed, so a concurrent or interrupted build never leaves a partial
    library behind."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source_path(name))],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build_all(names) -> dict[str, str]:
    """Build several kernels at once, one ``nvcc`` per source, all started
    together; returns each one's compiler output."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        results = list(pool.map(build, names))
    return {n: log for n, (_, log) in zip(names, results)}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
