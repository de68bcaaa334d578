"""The 10 assigned architectures — exact configs from the assignment table.

A copy of ``repro.configs.archs`` (the port imports nothing of the
reference).  Each entry is the FULL config (qwen3-4b's runs on the card in
``chip_smoke.py``), and ``smoke()`` reduces one to the same family at tiny
widths for the CPU tests and ``launch/serve.py``.  ``dtype`` is a
``torch.dtype`` (bf16 by default).

Sources per the assignment: [arXiv/hf references in each docstring].
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import LayerSpec, ModelConfig

G = LayerSpec("global")


def L(window: int) -> LayerSpec:
    return LayerSpec("local", window)


R = LayerSpec("rglru")
S = LayerSpec("ssd")


# --------------------------------------------------------------------------
# full configs
# --------------------------------------------------------------------------

RECURRENTGEMMA_2B = ModelConfig(
    # [arXiv:2402.19427; hf] RG-LRU + local attn, cycle (R,R,A); 26 layers
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    pattern=(R, R, L(2048)), tail=(R, R),
    rglru_width=2560, conv1d_width=4, rms_offset=True,
)

QWEN3_4B = ModelConfig(
    # [hf:Qwen/Qwen3-8B family; hf] qk_norm, GQA kv=8
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151_936,
    pattern=(G,), qk_norm=True, rope_theta=1e6,
)

GEMMA2_27B = ModelConfig(
    # [arXiv:2408.00118; hf] local:global 1:1, logit softcaps
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36_864, vocab_size=256_000,
    pattern=(L(4096), G), tail=(),
    attn_softcap=50.0, logit_softcap=30.0, rms_offset=True,
)

QWEN15_110B = ModelConfig(
    # [hf:Qwen/Qwen1.5 family; hf] QKV bias
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=49_152, vocab_size=152_064,
    pattern=(G,), qkv_bias=True, rope_theta=1e6, tie_embeddings=False,
)

GEMMA3_27B = ModelConfig(
    # [hf:google/gemma-3 family; unverified] 5:1 local:global, 128k ctx
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=21_504, vocab_size=262_144,
    pattern=(L(1024),) * 5 + (G,), tail=(L(1024), L(1024)),
    qk_norm=True, rms_offset=True, rope_theta=1e6,
)

QWEN3_MOE_30B = ModelConfig(
    # [hf:Qwen/Qwen3-30B-A3B; hf] 128 experts top-8
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151_936,
    pattern=(G,), qk_norm=True, rope_theta=1e6,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=768,
)

QWEN3_MOE_235B = ModelConfig(
    # [hf:Qwen/Qwen3-30B-A3B scaled per assignment; hf]
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151_936,
    pattern=(G,), qk_norm=True, rope_theta=1e6,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=1536,
)

MAMBA2_130M = ModelConfig(
    # [arXiv:2405.21060; unverified] SSD, attn-free
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    pattern=(S,), ssm_state=128, ssm_head_dim=64, ssm_chunk=64,
)

WHISPER_LARGE_V3 = ModelConfig(
    # [arXiv:2212.04356; unverified] enc-dec; conv frontend STUBBED:
    # input_specs feeds precomputed (B, 1500, D) frame embeddings.
    name="whisper-large-v3", family="encdec",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51_866,
    pattern=(G,), encoder_layers=32, encoder_frames=1500,
)

INTERNVL2_2B = ModelConfig(
    # [arXiv:2404.16821; hf] InternViT STUBBED (precomputed patch embeds) +
    # InternLM2-1.8B backbone
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92_553,
    pattern=(G,), vision_tokens=256, rope_theta=1e6,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        RECURRENTGEMMA_2B, QWEN3_4B, GEMMA2_27B, QWEN15_110B, GEMMA3_27B,
        QWEN3_MOE_30B, QWEN3_MOE_235B, MAMBA2_130M, WHISPER_LARGE_V3,
        INTERNVL2_2B,
    ]
}


# --------------------------------------------------------------------------
# smoke reductions: same family/features, tiny dims
# --------------------------------------------------------------------------

def smoke(name: str) -> ModelConfig:
    c = ARCHS[name]
    reduced = dict(
        num_layers=len(c.pattern) + len(c.tail),
        d_model=64,
        num_heads=max(2, min(4, c.num_heads or 2)),
        num_kv_heads=max(1, min(2, c.num_kv_heads or 1)),
        head_dim=16,
        d_ff=128 if c.d_ff else 0,
        vocab_size=128,
        rglru_width=64 if c.rglru_width else 0,
        num_experts=8 if c.num_experts else 0,
        num_experts_per_tok=min(2, c.num_experts_per_tok) if c.num_experts else 0,
        moe_d_ff=32 if c.moe_d_ff else 0,
        ssm_state=16 if c.ssm_state else 0,
        ssm_head_dim=8 if c.ssm_state else 64,
        ssm_chunk=8 if c.ssm_state else 64,
        encoder_layers=1 if c.encoder_layers else 0,
        encoder_frames=12 if c.encoder_frames else 0,
        vision_tokens=8 if c.vision_tokens else 0,
        name=c.name + "-smoke",
    )
    # shrink local windows so masks differ from global at smoke seq lens
    pat = tuple(LayerSpec(s.kind, 8 if s.window else None) for s in c.pattern)
    tail = tuple(LayerSpec(s.kind, 8 if s.window else None) for s in c.tail)
    return dataclasses.replace(c, pattern=pat, tail=tail, **reduced)


# --------------------------------------------------------------------------
# per-arch shape applicability (the reference's dry-run grid)
# --------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524_288, global_batch=1),
}

# long_500k runs only for sub-quadratic (windowed/recurrent) families
LONG_OK = {"recurrentgemma-2b", "gemma2-27b", "gemma3-27b", "mamba2-130m"}


def cells() -> list[tuple[str, str]]:
    """The (arch, shape) grid with documented skips removed."""
    out = []
    for a in ARCHS:
        for sh in SHAPES:
            if sh == "long_500k" and a not in LONG_OK:
                continue
            out.append((a, sh))
    return out


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for a in ARCHS:
        if a not in LONG_OK:
            out.append((a, "long_500k",
                        "pure full attention (or <=30s audio) — "
                        "sub-quadratic requirement, see DESIGN.md"))
    return out
