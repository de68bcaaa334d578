"""The port's fold-in building blocks (repro_torch.core, repro_torch.kernels)
held against the JAX package on the same numpy inputs.

Randomness is data: z0 and the per-sweep uniforms are drawn with numpy and
handed to both packages.  Tolerances:

* integer outputs (theta sums, sparse-draw counts, ELL counts and topics,
  blocked-search draws, scatter counts) must be exact.  At these sizes the
  plain PyTorch version makes the same draws as the JAX oracle; the float
  order of the two frameworks' cumsums differs (fault F2), which at NYTimes
  width can flip a draw that sits on a boundary — the card check in
  ``chip_smoke.py`` states its bound for that;
* ``ssq`` (a float sum of S/(S+Q) over tokens, reduced in another order)
  within rtol 1e-5.

The JAX fold-in kernel runs as its own tests run it on the CPU: the Pallas
kernel in interpret mode, and its jnp oracle.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sampler as jsampler
from repro.core import updates as jupdates
from repro.kernels.fold_in import kernel as jkernel
from repro.kernels.fold_in import ref as jref
from repro_torch.core import sampler as tsampler
from repro_torch.core import updates as tupdates
from repro_torch.kernels.fold_in import kernel as tkernel
from repro_torch.kernels.fold_in import ops as tops
from repro_torch.kernels.fold_in import ref as tref


def foldin_case(K, B=4, L=48, V=200, burn_in=3, samples=2, seed=0,
                density=0.1, empty_doc=False):
    """Random phi rows, ragged docs and numpy randoms for one batch."""
    rng = np.random.default_rng(seed)
    phi = ((rng.random((V, K)) < density)
           * rng.integers(1, 300, (V, K))).astype(np.int32)
    toks = rng.integers(0, V, (B, L))
    lens = rng.integers(1, L + 1, B)
    if empty_doc:
        lens[-1] = 0
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    n_sweeps = burn_in + samples
    args = (phi[toks], phi.sum(0).astype(np.int32),
            np.array([50.0 / K, 0.01], np.float32),
            rng.random((B, n_sweeps, L, 2), dtype=np.float32), mask,
            rng.integers(0, K, (B, L)).astype(np.int32))
    kw = dict(num_words_total=V, burn_in=burn_in, samples=samples,
              ell_capacity=min(L, K))
    return args, kw


def _assert_partials(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out[0]),
                                  torch_out[0].numpy())
    np.testing.assert_array_equal(np.asarray(jax_out[1]),
                                  torch_out[1].numpy())
    np.testing.assert_allclose(np.asarray(jax_out[2]), torch_out[2].numpy(),
                               rtol=1e-5)


# K = 96: 32-wide search blocks (nb = 3); K = 256: 128-wide (nb = 2)
@pytest.mark.parametrize("K", [96, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_foldin_ref_matches_jax_oracle(K, seed):
    args, kw = foldin_case(K, seed=seed)
    j = jref.fold_in_docs_ref(*(jnp.asarray(a) for a in args), **kw)
    t = tref.fold_in_docs_ref(*(torch.from_numpy(a) for a in args), **kw)
    _assert_partials(j, t)


@pytest.mark.parametrize("K", [96, 256])
def test_foldin_ref_matches_pallas_interpret(K):
    args, kw = foldin_case(K, B=3, L=40, seed=7)
    j = jkernel.fold_in_docs(*(jnp.asarray(a) for a in args),
                             interpret=True, **kw)
    t = tref.fold_in_docs_ref(*(torch.from_numpy(a) for a in args), **kw)
    _assert_partials(j, t)


def test_foldin_ref_small_ell_capacity():
    """P < the number of live topics: the sparse side sees only the top-P
    slice, in lax.top_k order."""
    args, kw = foldin_case(256, seed=3)
    kw["ell_capacity"] = 8
    j = jref.fold_in_docs_ref(*(jnp.asarray(a) for a in args), **kw)
    t = tref.fold_in_docs_ref(*(torch.from_numpy(a) for a in args), **kw)
    _assert_partials(j, t)


def test_foldin_ref_padding_doc_writes_zeros():
    """An all-padding row of a batch bucket contributes nothing."""
    args, kw = foldin_case(96, seed=4, empty_doc=True)
    tsum, sp, ssq, z = tref.fold_in_docs_ref(
        *(torch.from_numpy(a) for a in args), **kw)
    assert int(tsum[-1].abs().sum()) == 0
    assert int(sp[-1]) == 0 and float(ssq[-1]) == 0.0
    # padded slots keep z0
    z0, mask = args[5], args[4]
    np.testing.assert_array_equal(z.numpy()[mask == 0], z0[mask == 0])


def test_foldin_ref_theta_sums_count_kept_tokens():
    args, kw = foldin_case(96, seed=5)
    tsum = tref.fold_in_docs_ref(*(torch.from_numpy(a) for a in args),
                                 **kw)[0]
    np.testing.assert_array_equal(tsum.sum(1).numpy(),
                                  args[4].sum(1) * kw["samples"])


@pytest.mark.parametrize("K,P", [(128, 16), (1024, 64), (96, 96)])
def test_ell_topk_matches_lax_top_k_tie_order(K, P):
    """Fault F1: torch.topk orders ties differently; ell_topk is a stable
    sort on -count and must equal lax.top_k exactly, zero padding too."""
    rng = np.random.default_rng(K + P)
    theta = rng.integers(0, 4, (200, K)).astype(np.int32)
    theta[:, rng.random(K) < 0.5] = 0          # many zeros, many ties
    theta[0] = 0                               # an all-zero row
    jc, jt = jax.lax.top_k(jnp.asarray(theta), P)
    tc, tt = tupdates.ell_topk(torch.from_numpy(theta), P)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    assert tc.dtype == torch.int32 and tt.dtype == torch.int32


@pytest.mark.parametrize("K", [96, 256, 1024])
def test_blocked_search_matches_jax(K):
    rng = np.random.default_rng(K)
    p = (rng.random(K) * (rng.random(K) < 0.3)).astype(np.float32) + 1e-4
    u = rng.random(4096, dtype=np.float32)
    j = jsampler.blocked_search(jnp.asarray(p), jnp.asarray(u))
    t = tsampler.blocked_search(torch.from_numpy(p), torch.from_numpy(u))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_search_block_policy_matches_jax():
    for K in (8, 96, 100, 128, 256, 384, 1000, 1024, 4096):
        assert tsampler.pick_search_block(K) == jsampler.pick_search_block(K)


def test_pstar_matches_jax():
    rng = np.random.default_rng(0)
    phi = rng.integers(0, 500, (7, 96)).astype(np.int32)
    ps = phi.sum(0).astype(np.int32)
    j = jsampler.pstar(jnp.asarray(phi), jnp.asarray(ps), 0.01, 5000)
    t = tsampler.pstar(torch.from_numpy(phi), torch.from_numpy(ps), 0.01, 5000)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_count_scatters_match_jax():
    rng = np.random.default_rng(1)
    n, t, V, K, D = 12, 8, 30, 16, 5
    z = rng.integers(0, K, (n, t)).astype(np.int32)
    words = rng.integers(0, V, n).astype(np.int32)
    docs = rng.integers(0, D, (n, t)).astype(np.int32)
    mask = rng.random((n, t)) < 0.8
    np.testing.assert_array_equal(
        np.asarray(jupdates.phi_from_z(jnp.asarray(z), jnp.asarray(words),
                                       jnp.asarray(mask), V, K)),
        tupdates.phi_from_z(torch.from_numpy(z), torch.from_numpy(words),
                            torch.from_numpy(mask), V, K).numpy())
    np.testing.assert_array_equal(
        np.asarray(jupdates.theta_from_z(jnp.asarray(z), jnp.asarray(docs),
                                         jnp.asarray(mask), D, K)),
        tupdates.theta_from_z(torch.from_numpy(z), torch.from_numpy(docs),
                              torch.from_numpy(mask), D, K).numpy())


def test_draw_fold_in_randoms_shapes_and_determinism():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tops.draw_fold_in_randoms(g, 3, 16, 96, 5, "cpu")

    z0, u = draw(11)
    assert z0.shape == (3, 16) and z0.dtype == torch.int32
    assert u.shape == (5, 3, 16, 2) and u.dtype == torch.float32
    assert int(z0.min()) >= 0 and int(z0.max()) < 96
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    z1, u1 = draw(11)
    assert torch.equal(z0, z1) and torch.equal(u, u1)
    assert not torch.equal(u, draw(12)[1])


def test_sweeps_drawn_matches_jax_ops_on_cpu():
    """ops-level seam: the same z0/uniforms through both packages' ops."""
    from repro.kernels.fold_in import ops as jops

    args, kw = foldin_case(96, seed=9)
    phi_tok, phi_sum, hyper, uni_bs, mask, z0 = args
    uni = np.ascontiguousarray(np.swapaxes(uni_bs, 0, 1))   # (S, B, L, 2)
    j = jops.fold_in_sweeps_drawn(
        jnp.asarray(phi_tok), jnp.asarray(phi_sum), jnp.asarray(mask != 0),
        jnp.asarray(z0), jnp.asarray(uni), float(hyper[0]), float(hyper[1]),
        impl="ref", **kw)
    t = tops.fold_in_sweeps_drawn(
        torch.from_numpy(phi_tok), torch.from_numpy(phi_sum),
        torch.from_numpy(mask != 0), torch.from_numpy(z0),
        torch.from_numpy(uni), float(hyper[0]), float(hyper[1]), **kw)
    _assert_partials(j, t)


def test_cpu_dispatch_runs_plain_version_without_launching():
    args, kw = foldin_case(96, seed=2)
    phi_tok, phi_sum, hyper, uni_bs, mask, z0 = (torch.from_numpy(a)
                                                 for a in args)
    before = tkernel.fold_in_docs.launches
    out = tops.fold_in_sweeps_drawn(
        phi_tok, phi_sum, mask != 0, z0, uni_bs.transpose(0, 1), hyper[0],
        hyper[1], impl="kernel", **kw)
    assert tkernel.fold_in_docs.launches == before
    ref_out = tref.fold_in_docs_ref(*(torch.from_numpy(a) for a in args),
                                    **kw)
    for a, b in zip(out, ref_out):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    args, kw = foldin_case(96, seed=2)
    before = tkernel.fold_in_docs.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        tkernel.fold_in_docs(*(torch.from_numpy(a) for a in args), **kw)
    assert tkernel.fold_in_docs.launches == before


def test_unknown_impl_rejected():
    args, kw = foldin_case(96, seed=2)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="impl"):
        tops.fold_in_sweeps_drawn(t[0], t[1], t[4] != 0, t[5],
                                  t[3].transpose(0, 1), 0.1, 0.01,
                                  impl="xla", **kw)
