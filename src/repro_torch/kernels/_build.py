"""Build the port's CUDA kernels with ``nvcc`` at first use, load them with
ctypes, and check the tensors handed to them.

Each ``csrc/*.cu`` source has a plain C interface and compiles on its own
into ``build/kernels/<name>-<hash>.so`` under the repository root (the hash
is of the source and of any ``-D`` defines, so an edited kernel rebuilds and
a build variant gets a library of its own).  Nothing is built when a
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

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


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


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    for d in defines:
        h.update(b"\0" + d.encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile one kernel source unless its library exists; returns
    ``(library path, nvcc's output)``.  ``defines`` (``NAME=VALUE``) go to
    nvcc as ``-D``.  Written to a temporary file and renamed, so a
    concurrent or interrupted build never leaves a partial library
    behind."""
    out = library_path(name, defines)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
             str(source_path(name))],
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


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path, _ = build(name, key[1])
            lib = ctypes.CDLL(str(path))
            _loaded[key] = lib
        return lib


def check_tensor(name, t, dtypes, shape, device):
    """Raise ValueError unless ``t`` is a contiguous tensor on ``device`` of
    one of ``dtypes`` (a dtype or a tuple of them) and ``shape``."""
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected "
                         f"{' or '.join(str(d) for d in dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t, kernel: str, plain: str) -> torch.device:
    """The device of ``t``, which must be a CUDA device: the kernels refuse
    CPU tensors (those go to the plain version)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} launches a CUDA kernel; CPU tensors go to "
                         f"{plain}")
    return t.device


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
