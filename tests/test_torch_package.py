"""Package rules of the port: repro_torch (and chip_smoke.py,
kernel_probe.py and examples/torch_*.py) import neither jax nor anything
of the JAX package, and entry points never fall back to the CPU
silently."""
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
    the two chip scripts import, and no module of the JAX package gets
    loaded."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(ROOT / "src")!r})
sys.path.insert(0, {str(ROOT)!r})
for name in {_port_modules()!r} + ["chip_smoke", "kernel_probe"]:
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
    + [str(p.relative_to(ROOT))
       for p in (ROOT / "examples").glob("torch_*.py")]
    + ["chip_smoke.py", "kernel_probe.py"]))
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


def test_k1_probe_refuses_without_cuda():
    """kernel_probe.py (k1_probe.py before it timed K2 and K3 too), which
    times build variants of the kernels, needs a card too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, str(ROOT / "kernel_probe.py")],
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=300)
    assert res.returncode != 0
    assert "probe" not in res.stdout


def test_build_variants_get_their_own_library():
    """A source built with -D defines (k1_probe.py's variants) gets a
    library of its own, never the shipped one's."""
    from repro_torch.kernels import _build

    base = _build.library_path("lda_sample")
    probe = _build.library_path("lda_sample", ("LDA_SAMPLE_PROBE=1",))
    assert probe != base and probe.parent == base.parent
    assert probe == _build.library_path("lda_sample", ("LDA_SAMPLE_PROBE=1",))
    assert probe != _build.library_path("lda_sample", ("LDA_SAMPLE_PROBE=2",))
    src = _build.source_path("lda_sample").read_text()
    assert "LDA_SAMPLE_PROBE" in src and "LDA_SAMPLE_TILES_PER_CTA" in src


@pytest.mark.parametrize("name", ["fold_in", "lda_sample", "phi_update",
                                  "ell_select"])
def test_every_kernel_source_is_found(name):
    from repro_torch.kernels import _build

    src = _build.source_path(name)
    assert src.exists() and src.suffix == ".cu"
    assert "extern \"C\"" in src.read_text()
    assert _build.library_path(name).name.startswith(f"{name}-")


def _tiny_training():
    from repro_torch.core.trainer import LDAConfig
    from repro_torch.data.synthetic import lda_corpus

    return (lda_corpus(num_docs=8, num_words=20, num_topics=2,
                       avg_doc_len=10, seed=0),
            LDAConfig(num_topics=4, tile_tokens=8))


def test_fit_defaults_to_cuda(monkeypatch):
    """fit with no device means the card: without one it raises, and runs
    on the CPU only when asked.  A cuda mesh without a card raises the same
    error: no path falls back to gloo or to the CPU."""
    import types

    from repro_torch.train import fit

    corpus, cfg = _tiny_training()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit(corpus, cfg, 1)
    res = fit(corpus, cfg, 1, device="cpu")
    assert res.state.z.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit(corpus, cfg, 1, mesh=types.SimpleNamespace(device_type="cuda"))


def test_launch_train_defaults_to_cuda(monkeypatch, tmp_path):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--iters", "1", "--topics", "4", "--scale", "0.0001",
             "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(flags)
    assert train.main(flags + ["--device", "cpu"]) == 0


def test_training_kernels_refuse_cpu_tensors():
    """No CPU fallback inside a kernel wrapper: CPU tensors go to the plain
    versions through ops.py, never through the wrappers."""
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import kernel as k24

    z = torch.zeros((2, 4), dtype=torch.int16)
    m = torch.ones((2, 4), dtype=torch.bool)
    tw = torch.zeros(2, dtype=torch.int32)
    seg = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k24.phi_update_tiles(seg, tw, z, m, 3, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k24.phi_delta_tiles(tw, z, z, m, 3, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k1.lda_sample_tiles(tw, tw[:, None].expand(2, 4).contiguous(), m, z,
                            torch.zeros((3, 4), dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32),
                            torch.zeros((1, 4), dtype=torch.int32),
                            torch.zeros((1, 4), dtype=torch.int32),
                            torch.zeros((2, 4, 2)),
                            ell_live=torch.zeros(1, dtype=torch.int32),
                            alpha=0.1, beta=0.01, num_words_total=3)


LM_MODULES = ("common", "attention", "moe", "recurrent", "transformer", "zoo",
              "convert")
LM_CONFIGS = ("archs", "recurrentgemma_2b", "qwen3_4b", "gemma2_27b",
              "qwen15_110b", "gemma3_27b", "qwen3_moe_30b_a3b",
              "qwen3_moe_235b_a22b", "mamba2_130m", "whisper_large_v3",
              "internvl2_2b")


def test_lm_zoo_modules_are_in_the_port():
    """The serving slice of the LM zoo: models/* and configs/*, each a
    module the import rules above cover."""
    mods = set(_port_modules())
    for m in LM_MODULES:
        assert f"repro_torch.models.{m}" in mods, m
    for m in LM_CONFIGS:
        assert f"repro_torch.configs.{m}" in mods, m
    assert "repro_torch.launch.serve" in mods


def test_lm_serve_defaults_to_cuda(monkeypatch):
    """launch/serve.py without --device means the card: without one it
    raises; --device cpu runs the decode on the host."""
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-4b", "--gen", "1"])
    out = serve.main(["--arch", "qwen3-4b", "--gen", "2", "--device", "cpu"])
    assert out["device"] == "cpu" and out["finite"] and out["position"] == 3


def test_lm_init_defaults_to_cuda(monkeypatch):
    """Decode states and caches made without a generator or device go to
    cuda:0; without a card that raises."""
    from repro_torch.configs.archs import smoke
    from repro_torch.models import zoo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.init_decode_state(smoke("qwen3-4b"), 1, 8)
    st = zoo.init_decode_state(smoke("qwen3-4b"), 1, 8, device="cpu")
    assert st.position.device == torch.device("cpu")


def test_lm_training_modules_are_in_the_port():
    """The training slice of the LM zoo: the optimizer and the loader are
    modules of the port, each covered by the import rules above, and the
    zoo has its training half."""
    from repro_torch.models import zoo

    mods = set(_port_modules())
    assert {"repro_torch.optim.adamw", "repro_torch.data.loader"} <= mods
    for name in ("loss_fn", "loss_and_grads", "make_train_step",
                 "TrainState", "LOSS_SEQ_CHUNK"):
        assert hasattr(zoo, name), name


def test_lm_training_defaults_to_cuda(monkeypatch):
    """``--workload lm`` and ``PrefetchLoader`` without a device mean the
    card: without one they raise; ``--device cpu`` trains on the host."""
    from repro_torch.data.loader import PrefetchLoader, lm_batches
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--workload", "lm", "--arch", "mamba2-130m", "--iters", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(flags)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefetchLoader(lm_batches(16, 1, 4))
    assert train.main(flags + ["--device", "cpu"]) == 0
