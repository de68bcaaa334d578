"""Tests of the port that need a CUDA card: the fold-in kernel against its
plain PyTorch version on the card, the wrapper's input checks, and the
engine serving through the kernel.  Skipped without a card.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fold_in import kernel, ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fold-in kernel runs only there")
    return torch.device("cuda:0")


def case(K, dev, B=8, L=64, V=300, burn_in=3, samples=2, seed=0):
    rng = np.random.default_rng(seed)
    phi = ((rng.random((V, K)) < 0.1)
           * rng.integers(1, 300, (V, K))).astype(np.int32)
    lens = rng.integers(1, L + 1, B)
    lens[-1] = 0                                  # one all-padding doc
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    args = (phi[rng.integers(0, V, (B, L))], phi.sum(0).astype(np.int32),
            np.array([50.0 / K, 0.01], np.float32),
            rng.random((B, burn_in + samples, L, 2), dtype=np.float32), mask,
            rng.integers(0, K, (B, L)).astype(np.int32))
    kw = dict(num_words_total=V, burn_in=burn_in, samples=samples,
              ell_capacity=min(L, K))
    return [torch.from_numpy(a).to(dev) for a in args], kw


@pytest.mark.parametrize("K", [96, 256, 1024])
def test_kernel_matches_plain_version(dev, K):
    """At these sizes the draws agree exactly (no float-order boundary is
    hit), so theta sums, sparse counts and final z are equal; the S-share
    sum is reduced in another order (rtol 1e-5)."""
    args, kw = case(K, dev, seed=K)
    before = kernel.fold_in_docs.launches
    k = kernel.fold_in_docs(*args, **kw)
    assert kernel.fold_in_docs.launches == before + 1
    r = ref.fold_in_docs_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])
    assert torch.equal(k[3], r[3])
    torch.testing.assert_close(k[2], r[2], rtol=1e-5, atol=0)
    assert int(k[0][-1].abs().sum()) == 0          # padding doc: zeros


def test_ops_dispatch_launches_on_cuda(dev):
    args, kw = case(96, dev, seed=1)
    before = kernel.fold_in_docs.launches
    out = ops.fold_in_sweeps_drawn(args[0], args[1], args[4] != 0, args[5],
                                   args[3].transpose(0, 1), args[2][0],
                                   args[2][1], **kw)
    assert kernel.fold_in_docs.launches == before + 1
    ops.fold_in_sweeps_drawn(args[0], args[1], args[4] != 0, args[5],
                             args[3].transpose(0, 1), args[2][0], args[2][1],
                             impl="ref", **kw)
    assert kernel.fold_in_docs.launches == before + 1
    assert out[0].device.type == "cuda"


def test_wrapper_rejects_bad_inputs(dev):
    args, kw = case(96, dev, seed=2)
    bad = list(args)
    bad[0] = args[0].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        kernel.fold_in_docs(*bad, **kw)
    bad = list(args)
    bad[3] = args[3].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.fold_in_docs(*bad, **kw)
    with pytest.raises(ValueError, match="ell_capacity"):
        kernel.fold_in_docs(*args, **{**kw, "ell_capacity": 0})


def test_engine_serves_through_kernel(dev):
    from repro_torch.serve import (EngineConfig, HotSwapModel, InferConfig,
                                   LDAServeEngine, snapshot_from_numpy)

    V, K = 64, 8
    phi = np.zeros((V, K), np.int32)
    for k in range(K):
        phi[k * 8:(k + 1) * 8, k] = 200
    snap = snapshot_from_numpy(phi, phi.sum(0), 0.1, 0.01, V, device=dev)
    eng = LDAServeEngine(HotSwapModel(snap), EngineConfig(
        max_batch=4, max_delay_ms=20.0, length_buckets=(32,),
        infer=InferConfig(burn_in=3, samples=2)))
    before = kernel.fold_in_docs.launches
    try:
        out = eng.infer_many([np.arange(k * 8, k * 8 + 8, dtype=np.int32)
                              for k in (0, 1, 2)])
    finally:
        eng.stop()
    assert [int(r["theta"].argmax()) for r in out] == [0, 1, 2]
    assert kernel.fold_in_docs.launches > before
