"""The ten architectures in bf16, their configs' dtype, against the JAX
package (the same weights, state and tokens as the float32 runs of
``test_torch_lm_archs.py``), and the port's own decode-equals-prefill check.

bf16 bound: XLA and torch each accumulate a bf16 product in float32 but
round elementwise chains at other points (XLA fuses them), so through the
layers of a smoke model the logits differ by up to 2.6e-2 of their scale
(gemma3-27b, the deepest smoke model, 8 layers).  The bound is 5e-2 of the
largest reference logit for the prefill and decode logits, and 5e-2 of
each state tensor's largest magnitude for the decode state (ring positions
and lengths equal).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_archs import ARCH_NAMES, run_both

from repro_torch.configs import archs as tarchs
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo

BF16_REL = 5e-2
DECODE_PREFILL_REL = 1e-4


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_bfloat16_matches_reference(name):
    out = run_both(name, jnp.bfloat16, torch.bfloat16)
    vocab = tarchs.smoke(name).vocab_size
    scale = np.abs(out["prefill"][0][..., :vocab]).max()
    for key, (ref, got) in out.items():
        if key.endswith((".pos", ".length", "position")):
            np.testing.assert_array_equal(got, ref, err_msg=key)
        elif key.startswith("state."):
            bound = BF16_REL * max(np.abs(ref).max(), 1e-6)
            assert np.abs(got - ref).max() <= bound, key
        else:
            assert np.abs(got - ref).max() <= BF16_REL * scale, key


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_token_by_token_equals_prefill(name):
    """Float32: a 12-token prompt decoded token by token from an empty state
    gives the prefill's last logits (relative 1e-4).  whisper decodes
    against its encoder's keys and values (``cross_kv_from_encoder``);
    internvl2's prompt is text only.  The MoE archs hold only with a
    capacity that drops nothing (cf = 8): their capacity depends on the
    token count, so at the configs' cf = 1.25 a prefill and a decode drop
    different routings, as in the reference."""
    cfg = dataclasses.replace(tarchs.smoke(name), dtype=torch.float32)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    params = ttf.init_params(cfg, gen)
    Bt, St = 2, 12
    tokens = torch.randint(0, cfg.vocab_size, (Bt, St), generator=gen)
    batch = {"tokens": tokens}
    state = zoo.init_decode_state(cfg, Bt, max_len=16, dtype=torch.float32,
                                  device="cpu")
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(Bt, cfg.encoder_frames, cfg.d_model,
                                      generator=gen)
        enc = ttf.encode(params, cfg, batch["frames"])
        state = state._replace(cross_kv=zoo.cross_kv_from_encoder(
            params, cfg, enc, torch.float32))
    prefill = zoo.make_prefill_step(cfg)(params, batch)
    step = zoo.make_decode_step(cfg)
    for i in range(St):
        logits, state = step(params, state, tokens[:, i:i + 1])
    assert int(state.position) == St
    v = cfg.vocab_size
    scale = prefill[..., :v].abs().max()
    err = (logits[..., :v] - prefill[..., :v]).abs().max()
    assert float(err / scale) <= DECODE_PREFILL_REL, float(err / scale)
