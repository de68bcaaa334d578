"""Each of the ten architectures of configs/archs.py at its smoke() width:
the port's prefill and decode steps (repro_torch.models.zoo) against the
JAX package's, from the same weights and decode state (carried across as
numpy by ``models/convert.py``) on the same tokens made with numpy from a
seed, in float32; and the port's configs against the reference's, field by
field.

Float32 bound: rtol = atol = 1e-4 on the prefill logits, on three decode
steps' logits and on every tensor of the returned decode state (ring
positions and lengths equal).  The bf16 runs are in
``test_torch_lm_bf16.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jarchs
from repro.models import transformer as jtf
from repro.models import zoo as jzoo
from repro.models.common import NO_SHARDING
from repro_torch.configs import archs as tarchs
from repro_torch.models import convert
from repro_torch.models import zoo
from repro_torch.models.common import padded_vocab

ARCH_NAMES = sorted(jarchs.ARCHS)
B, S, PREFILL, MAX_LEN, STEPS = 2, 16, 8, 32, 3
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def flat(tree) -> dict:
    """A JAX pytree as {dotted path: numpy array}, the keys convert.py
    reads."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "idx", None)))
                     for k in path): np.asarray(v) for path, v in leaves}


def as_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float64) if (a.dtype.kind == "f"
                                    or a.dtype.name == "bfloat16") else a


def run_both(name: str, jdtype, tdtype) -> dict:
    """Prefill S tokens, then STEPS decode steps from a stand-in prefilled
    cache of PREFILL tokens (max_len MAX_LEN), in both packages from the
    reference's weights and state.  Returns each output as numpy, both
    sides."""
    jcfg = dataclasses.replace(jarchs.smoke(name), dtype=jdtype)
    tcfg = dataclasses.replace(tarchs.smoke(name), dtype=tdtype)
    jp = jtf.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_numpy(tcfg, flat(jp), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S), np.int32)}
    if jcfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)
    if jcfg.vision_tokens:
        batch["patches"] = rng.standard_normal(
            (B, jcfg.vision_tokens, jcfg.d_model)).astype(np.float32)
    out = {"prefill": (
        jax.jit(jzoo.make_prefill_step(jcfg, NO_SHARDING))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}),
        zoo.make_prefill_step(tcfg)(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}))}
    js = jzoo.init_decode_state(jcfg, B, MAX_LEN, prefill_len=PREFILL,
                                key=jax.random.key(1), dtype=jdtype)
    ts = convert.decode_state_from_numpy(tcfg, flat(js), "cpu")
    jstep = jax.jit(jzoo.make_decode_step(jcfg, NO_SHARDING))
    tstep = zoo.make_decode_step(tcfg)
    for i in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1), np.int32)
        jl, js = jstep(jp, js, jnp.asarray(tok))
        tl, ts = tstep(tp, ts, torch.from_numpy(tok))
        out[f"decode{i}"] = (jl, tl)
    jf, tf_ = flat(js), convert.flatten(ts)
    assert sorted(jf) == sorted(tf_)
    for k in jf:
        out["state." + k] = (jf[k], tf_[k])
    return {k: (as_f64(a), as_f64(b)) for k, (a, b) in out.items()}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_float32_matches_reference(name):
    out = run_both(name, jnp.float32, torch.float32)
    vp = padded_vocab(tarchs.smoke(name).vocab_size)
    assert out["prefill"][1].shape == out["decode0"][1].shape == (B, 1, vp)
    for key, (ref, got) in out.items():
        if key.endswith((".pos", ".length", "position")):
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, err_msg=key, **F32_TOL)


def _config_fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(d["dtype"]).rsplit(".", 1)[-1]      # torch.bfloat16
    d["pattern"] = [(s["kind"], s["window"]) for s in d["pattern"]]
    d["tail"] = [(s["kind"], s["window"]) for s in d["tail"]]
    return d


def _ref_fields(cfg) -> dict:
    d = _config_fields(cfg)
    d["dtype"] = jnp.dtype(cfg.dtype).name
    return d


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_equal_reference(name):
    """The full config and its smoke() reduction, field by field (dtype by
    name), and the derived widths."""
    for full in (True, False):
        j = jarchs.ARCHS[name] if full else jarchs.smoke(name)
        t = tarchs.ARCHS[name] if full else tarchs.smoke(name)
        assert _config_fields(t) == _ref_fields(j)
        assert (t.is_moe, t.num_blocks) == (j.is_moe, j.num_blocks)
        if t.num_heads:                     # mamba2 has no heads, no hd
            assert t.hd == j.hd


def test_arch_grid_equals_reference():
    assert list(tarchs.ARCHS) == list(jarchs.ARCHS)
    assert tarchs.SHAPES == jarchs.SHAPES and tarchs.LONG_OK == jarchs.LONG_OK
    assert tarchs.cells() == jarchs.cells()
    assert tarchs.skipped_cells() == jarchs.skipped_cells()


@pytest.mark.parametrize("module", [
    "recurrentgemma_2b", "qwen3_4b", "gemma2_27b", "qwen15_110b",
    "gemma3_27b", "qwen3_moe_30b_a3b", "qwen3_moe_235b_a22b", "mamba2_130m",
    "whisper_large_v3", "internvl2_2b"])
def test_per_arch_config_files(module):
    import importlib

    j = importlib.import_module(f"repro.configs.{module}")
    t = importlib.import_module(f"repro_torch.configs.{module}")
    assert _config_fields(t.CONFIG) == _ref_fields(j.CONFIG)
    assert _config_fields(t.SMOKE) == _ref_fields(j.SMOKE)
