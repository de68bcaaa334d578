"""The LM zoo's layers in the port (repro_torch.models) against the JAX
package's, on the same inputs made with numpy from a seed: norms, RoPE,
attention (softcap, window, GQA, the chunked causal path, the ring cache),
MoE (capacity drops, router ties), RG-LRU and SSD (chunked scans, decode),
the padded-vocabulary mask, and the bf16 crossing of ``convert.py``.

Everything runs in float32 (the reference accepts any dtype through its
config), where the two frameworks differ only by float order: the bound is
rtol = atol = 1e-4 unless a test says otherwise; integer state (ring
positions, lengths, capacity ranks) must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import smoke as jsmoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro.models import transformer as jtf
from repro.models.common import NO_SHARDING
from repro_torch.configs.archs import smoke as tsmoke
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttf

TOL = dict(rtol=1e-4, atol=1e-4)


def cfgs(name, **kw):
    """The reference's and the port's smoke config of ``name``, float32."""
    return (dataclasses.replace(jsmoke(name), dtype=jnp.float32, **kw),
            dataclasses.replace(tsmoke(name), dtype=torch.float32, **kw))


def flat(tree) -> dict:
    """A JAX pytree as {dotted path: numpy array}, the keys convert.py
    reads."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "idx", None)))
                     for k in path): np.asarray(v) for path, v in leaves}


def t(a):
    return convert.to_tensor(np.asarray(a), "cpu")


def nt(cls, jtree):
    """A reference NamedTuple of arrays as the port's ``cls`` of tensors."""
    return cls(*[None if a is None else t(a) for a in jtree])


def close(ref, got, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), **(tol or TOL))


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    w, x = randn(rng, 64, scale=0.5), randn(rng, 3, 5, 64)
    close(jcommon.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-6, offset),
          tcommon.rms_norm(t(w), t(x), 1e-6, offset))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_half_split(theta):
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    close(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), theta),
          tcommon.rope(t(x), t(pos), theta))


@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, None),
                                            (None, 5), (50.0, 5)])
def test_sdpa_gqa_softcap_window(softcap, window):
    """GQA (4 query heads on 2 KV heads), the tanh softcap, causal and
    windowed masks: the same float32 recipe."""
    jc, tc = cfgs("gemma2-27b", attn_softcap=softcap)
    rng = np.random.default_rng(2)
    q, k, v = (randn(rng, 2, 12, 4, 16), randn(rng, 2, 12, 2, 16),
               randn(rng, 2, 12, 2, 16))
    jm = jattn.causal_mask(12, 12, window)
    tm = tattn.causal_mask(12, 12, window)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    close(jattn._sdpa(*map(jnp.asarray, (q, k, v)), jm, jc),
          tattn._sdpa(t(q), t(k), t(v), tm, tc))


@pytest.mark.parametrize("Sq,Sk,window", [(4, 9, None), (9, 9, 3),
                                          (1, 6, 2)])
def test_causal_mask(Sq, Sk, window):
    np.testing.assert_array_equal(
        np.asarray(jattn.causal_mask(Sq, Sk, window)),
        tattn.causal_mask(Sq, Sk, window).numpy())


@pytest.mark.parametrize("window", [None, 1024])
def test_chunked_causal_attention(window):
    """S = 4 * Q_CHUNK takes the chunked path (a window of 1024 slices K/V
    to its rounded Lk); the port's attention equals the reference's."""
    assert tattn.Q_CHUNK == jattn.Q_CHUNK == 1024
    jc, tc = cfgs("qwen3-4b", d_model=32, head_dim=8, num_heads=4,
                  num_kv_heads=2)
    rng = np.random.default_rng(3)
    jp = jattn.init_attn(jax.random.key(0), jc)
    S = 4 * tattn.Q_CHUNK
    x = randn(rng, 1, S, 32, scale=0.3)
    pos = np.arange(S, dtype=np.int32)[None]
    ref = jattn.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                          NO_SHARDING, window)
    got = tattn.attention(nt(tattn.AttnParams, jp), tc, t(x), t(pos), window)
    close(ref, got)


def test_decode_attention_across_a_ring_wrap():
    """A window-8 layer on an 8-slot ring, 20 tokens: the ring wraps twice;
    outputs and the final cache (k, v, positions, length) match."""
    jc, tc = cfgs("gemma2-27b")
    rng = np.random.default_rng(4)
    jp = jattn.init_attn(jax.random.key(1), jc)
    tp = nt(tattn.AttnParams, jp)
    xs = randn(rng, 2, 20, jc.d_model, scale=0.3)
    jcache = jattn.init_cache(jc, 2, 32, window=8, dtype=jnp.float32)
    tcache = tattn.init_cache(tc, 2, 32, window=8, dtype=torch.float32,
                              device="cpu")
    assert tcache.k.shape[1] == 8
    for i in range(20):
        jy, jcache = jattn.decode_attention(jp, jc, jnp.asarray(xs[:, i:i + 1]),
                                            jcache, NO_SHARDING, window=8)
        ty, tcache = tattn.decode_attention(tp, tc, t(xs[:, i:i + 1]), tcache,
                                            window=8)
        close(jy, ty)
    np.testing.assert_array_equal(np.asarray(jcache.pos), tcache.pos.numpy())
    assert int(tcache.length) == int(jcache.length) == 20
    close(jcache.k, tcache.k)
    close(jcache.v, tcache.v)


@pytest.mark.parametrize("n,window", [(0, None), (5, None), (32, None),
                                      (8, 8), (13, 8), (3, 8)])
def test_init_cache_prefill_layout(n, window):
    """The stand-in prefill's ring layout: slot p % W holds the newest
    position p < n, or -1."""
    jc, tc = cfgs("gemma2-27b")
    ref = jattn.init_cache(jc, 1, 32, window, jnp.float32, prefill_len=n)
    got = tattn.init_cache(tc, 1, 32, window, torch.float32, prefill_len=n,
                           device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.pos), got.pos.numpy())
    assert got.pos.dtype == torch.int32 and got.length.dtype == torch.int32
    assert int(got.length) == int(ref.length) == n
    assert got.k.shape == ref.k.shape


def test_cross_attention_matches_reference():
    jc, tc = cfgs("whisper-large-v3")
    rng = np.random.default_rng(5)
    jp = jattn.init_attn(jax.random.key(2), jc)
    x = randn(rng, 2, 5, jc.d_model)
    k, v = randn(rng, 2, 12, 2, 16), randn(rng, 2, 12, 2, 16)
    close(jattn.cross_attention(jp, jc, jnp.asarray(x),
                                (jnp.asarray(k), jnp.asarray(v)), NO_SHARDING),
          tattn.cross_attention(nt(tattn.AttnParams, jp), tc, t(x),
                                (t(k), t(v))))


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert id first, as lax.top_k."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe.top_k(t(probs), 3)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("cf,ties", [(1.25, False), (0.5, False),
                                     (0.5, True), (1.25, True)])
def test_moe_capacity_drops_and_router_ties(cf, ties):
    """Capacity factor 0.5 drops routings past each expert's buffer.  The
    planted ties are triples of identical router columns (experts 0-2 and
    3-5) and a pair (6-7): where a token's best expert is in a triple, its
    top 2 are two of three equal probabilities, and the tie order decides
    which expert is left out."""
    jc, tc = cfgs("qwen3-moe-30b-a3b", capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.key(3), jc)
    rng = np.random.default_rng(6)
    if ties:
        router = np.asarray(jp.router).copy()
        for lead, members in ((0, (1, 2)), (3, (4, 5)), (6, (7,))):
            router[:, list(members)] = router[:, [lead]]
        jp = jp._replace(router=jnp.asarray(router))
    x = randn(rng, 2, 24, jc.d_model)
    ref = jmoe.moe_ffn_local(jp, jc, jnp.asarray(x), NO_SHARDING)
    got = tmoe.moe_ffn_local(nt(tmoe.MoEParams, jp), tc, t(x))
    close(ref, got)
    if ties:   # the planted ties straddle the top-k boundary
        probs = torch.softmax(t(x).reshape(-1, jc.d_model)
                              @ t(np.asarray(jp.router)), -1)
        top = tmoe.top_k(probs, 3)[0]
        assert int((top[:, 1] == top[:, 2]).sum()) >= 8


@pytest.mark.parametrize("S,h0", [(40, False), (40, True),
                                  (3 * trec.LRU_CHUNK, False),
                                  (3 * trec.LRU_CHUNK, True)])
def test_lru_scan_unchunked_and_chunked(S, h0):
    """S = 40 runs one prefix; S = 3 * LRU_CHUNK runs three chunks with a
    carry; with and without an initial state."""
    assert trec.LRU_CHUNK == jrec.LRU_CHUNK
    rng = np.random.default_rng(7)
    a = rng.uniform(0.8, 1.0, (2, S, 8)).astype(np.float32)
    bx = randn(rng, 2, S, 8, scale=0.1)
    h = randn(rng, 2, 8) if h0 else None
    ref = jrec._lru_scan(jnp.asarray(a), jnp.asarray(bx),
                         None if h is None else jnp.asarray(h))
    close(ref, trec._lru_scan(t(a), t(bx), None if h is None else t(h)))


@pytest.mark.parametrize("S,state", [(10, False), (1, True), (3, True)])
def test_rglru(S, state):
    jc, tc = cfgs("recurrentgemma-2b")
    jp = jrec.init_rglru(jax.random.key(4), jc)
    rng = np.random.default_rng(8)
    x = randn(rng, 2, S, jc.d_model, scale=0.5)
    js = ts = None
    if state:
        js = jrec.RGLRUState(h=jnp.asarray(randn(rng, 2, jc.rglru_width)),
                             conv=jnp.asarray(randn(rng, 2, 3,
                                                    jc.rglru_width)))
        ts = nt(trec.RGLRUState, js)
    jy, jst = jrec.rglru(jp, jc, jnp.asarray(x), NO_SHARDING, js)
    ty, tst = trec.rglru(nt(trec.RGLRUParams, jp), tc, t(x), ts)
    close(jy, ty)
    close(jst.h, tst.h)
    close(jst.conv, tst.conv)


@pytest.mark.parametrize("h0", [False, True])
def test_ssd_chunked(h0):
    """Four chunks of 8 with the inter-chunk carry, from zero or a given
    state."""
    rng = np.random.default_rng(9)
    B, S, H, P, N = 2, 32, 4, 8, 16
    xh = randn(rng, B, S, H, P)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm, Cm = randn(rng, B, S, N), randn(rng, B, S, N)
    h = randn(rng, B, H, P, N) if h0 else None
    jy, jh = jrec._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), 8,
                               None if h is None else jnp.asarray(h))
    ty, th = trec._ssd_chunked(t(xh), t(dt), t(A), t(Bm), t(Cm), 8,
                               None if h is None else t(h))
    close(jy, ty)
    close(jh, th)


@pytest.mark.parametrize("S,state", [(12, False), (1, True)])
def test_ssd_prefill_and_decode(S, state):
    """S = 12 pads to two chunks of 8 (the prefill path); S = 1 with a state
    is the decode step."""
    jc, tc = cfgs("mamba2-130m")
    jp = jrec.init_ssd(jax.random.key(5), jc)
    rng = np.random.default_rng(10)
    x = randn(rng, 2, S, jc.d_model, scale=0.5)
    js = ts = None
    if state:
        H, P, N = jrec.ssd_dims(jc)
        js = jrec.SSDState(h=jnp.asarray(randn(rng, 2, H, P, N, scale=0.1)))
        ts = nt(trec.SSDState, js)
    jy, jst = jrec.ssd(jp, jc, jnp.asarray(x), NO_SHARDING, js)
    ty, tst = trec.ssd(nt(trec.SSDParams, jp), tc, t(x), ts)
    close(jy, ty)
    close(jst.h, tst.h)


@pytest.mark.parametrize("tie,softcap", [(True, None), (False, 30.0)])
def test_lm_logits_masks_padded_slots(tie, softcap):
    """vocab 100 pads to 112: slots 100-111 are exactly -1e9, the rest
    match (tied or untied head, with and without the logit softcap)."""
    jc, tc = cfgs("qwen3-4b", vocab_size=100, tie_embeddings=tie,
                  logit_softcap=softcap)
    jp = jtf.init_params(jax.random.key(6), jc)
    tp = convert.params_from_numpy(tc, flat(jp), "cpu")
    rng = np.random.default_rng(11)
    h = randn(rng, 2, 3, jc.d_model)
    ref = np.asarray(jtf.lm_logits(jp, jc, jnp.asarray(h), NO_SHARDING))
    got = ttf.lm_logits(tp, tc, t(h)).numpy()
    assert got.shape[-1] == tcommon.padded_vocab(100) == 112
    assert (got[..., 100:] == np.float32(-1e9)).all()
    close(ref, got)


@pytest.mark.parametrize("v", [128, 100, 9_999, 10_000, 151_936, 256_000])
def test_padded_vocab(v):
    assert tcommon.padded_vocab(v) == jcommon.padded_vocab(v)


def test_bf16_crosses_as_its_bits():
    """A JAX bf16 array reaches numpy as ml_dtypes.bfloat16, which
    torch.from_numpy refuses; convert.to_tensor carries its bits."""
    rng = np.random.default_rng(12)
    a = np.asarray(jnp.asarray(randn(rng, 5, 7)).astype(jnp.bfloat16))
    assert a.dtype.name == "bfloat16"
    with pytest.raises(TypeError):
        torch.from_numpy(a)
    got = convert.to_tensor(a, "cpu")
    assert got.dtype == torch.bfloat16 and got.shape == (5, 7)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  a.view(np.int16))
    np.testing.assert_array_equal(got.float().numpy(), a.astype(np.float32))
    zero_d = convert.to_tensor(np.asarray(jnp.int32(7)), "cpu")
    assert zero_d.shape == () and zero_d.dtype == torch.int32


def test_embed_scale_rounds_like_jax():
    """A bf16 embedding times sqrt(D): JAX rounds the scalar to bf16 first
    (weak typing); the port's embed_tokens does the same."""
    jc = dataclasses.replace(jsmoke("qwen3-4b"), d_model=2560)
    tc = dataclasses.replace(tsmoke("qwen3-4b"), d_model=2560)
    rng = np.random.default_rng(13)
    e = np.asarray(jnp.asarray(randn(rng, 16, 2560)).astype(jnp.bfloat16))
    tok = np.arange(16, dtype=np.int32)[None]
    ref = jtf.embed_tokens(jtf.ModelParams(jnp.asarray(e), (), None, None),
                           jc, jnp.asarray(tok), NO_SHARDING)
    got = ttf.embed_tokens(ttf.ModelParams(convert.to_tensor(e, "cpu"), (),
                                           None, None), tc, t(tok))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
