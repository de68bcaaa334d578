"""Package rules of the port: repro_torch (and chip_smoke.py) import neither
jax nor anything of the JAX package, and entry points never fall back to
the CPU silently."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax():
    """With jax blocked in sys.modules, every repro_torch module and
    chip_smoke.py import, and no module of the JAX package gets loaded."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(ROOT / "src")!r})
sys.path.insert(0, {str(ROOT)!r})
for name in {_port_modules()!r} + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith("repro.")
                  or m.split(".")[0] in ("jax", "jaxlib")))
assert not bad, bad
print("ok", len({_port_modules()!r}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_repro_imports_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_resolve_device_raises_without_cuda(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_snapshot_defaults_to_cuda(monkeypatch):
    """No device given means the card: without one, loading fails loudly."""
    import numpy as np

    from repro_torch.serve import snapshot_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        snapshot_from_numpy(np.zeros((4, 2), np.int32), np.zeros(2, np.int32),
                            0.1, 0.01, 4)


def test_kernel_build_paths_and_missing_nvcc(monkeypatch):
    from repro_torch.kernels import _build

    src = _build.source_path("fold_in")
    assert src.exists() and src.suffix == ".cu"
    lib = _build.library_path("fold_in")
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith("fold_in-") and lib.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line without a
    card (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
