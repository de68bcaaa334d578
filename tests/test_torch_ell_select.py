"""The ELL of theta in the port (``kernels/ell_select``) on the CPU: CPU
tensors go to the plain version (the stable sort) and keep its output; the
custom op ``repro_torch::ell_select`` traces on fake ``cuda`` tensors with
the outputs' shapes and dtypes (the dry run's route), and its wrapper
refuses what the kernel does not take before anything is built.  The
kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import updates
from repro_torch.kernels.ell_select import kernel


def top_k_order(theta: np.ndarray, P: int):
    """lax.top_k's order in numpy: count descending, ties to the lower id."""
    order = np.argsort(-theta.astype(np.int64), axis=-1, kind="stable")
    order = order[..., :min(P, theta.shape[-1])]
    return np.take_along_axis(theta, order, -1), order


@pytest.mark.parametrize("lead,K,P,dtype", [
    ((9,), 64, 16, torch.int16), ((9,), 64, 64, torch.int32),
    ((2, 5), 90, 200, torch.int16), ((4,), 1024, 512, torch.int16)])
def test_cpu_tensors_take_the_plain_version(monkeypatch, lead, K, P, dtype):
    """On CPU tensors ``ell_topk`` and ``theta_to_ell`` never reach the
    kernel's wrapper and give the stable order, padding and overflow flag
    that they gave before the kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(kernel, "ell_select", refuse)
    rng = np.random.default_rng(K + P)
    theta = ((rng.random((*lead, K)) < 0.3)
             * rng.integers(1, 4, (*lead, K))).astype(np.int32)
    theta.reshape(-1, K)[0] = 0
    theta.reshape(-1, K)[1] = rng.integers(1, 3, K)
    want_c, want_t = top_k_order(theta, P)
    c, t, over = updates.theta_to_ell(torch.from_numpy(theta), P, dtype)
    c2, t2 = updates.ell_topk(torch.from_numpy(theta), P, dtype)
    for got in (c, t, c2, t2):
        assert got.dtype == dtype and got.shape == (*lead, min(P, K))
    np.testing.assert_array_equal(c.numpy(), want_c)
    np.testing.assert_array_equal(t.numpy(), want_t)
    assert torch.equal(c, c2) and torch.equal(t, t2)
    np.testing.assert_array_equal(over.numpy(),
                                  (theta > 0).sum(-1) > min(P, K))


@pytest.mark.parametrize("lead,K,P,dtype", [
    ((7,), 1024, 512, torch.int16), ((2, 3), 90, 60, torch.int32),
    ((5,), 64, 100, torch.int16)])
def test_op_traces_on_fake_cuda_tensors(monkeypatch, lead, K, P, dtype):
    """A fake ``cuda`` theta (the dry run's) routes to the custom op, never
    to the plain version, and the op's fake implementation gives counts and
    topics (..., min(P, K)) in the ELL's type and the (...,) bool flag,
    without building or launching."""
    def refuse(*args, **kwargs):
        raise AssertionError("a cuda tensor reached the plain version")

    monkeypatch.setattr(updates, "theta_to_ell_plain", refuse)
    monkeypatch.setattr(updates, "ell_topk_plain", refuse)
    calls, op = [], kernel._op
    monkeypatch.setattr(kernel, "_op", lambda *a: calls.append(a) or op(*a))
    before = kernel.ell_select.launches
    with FakeTensorMode():
        theta = torch.empty((*lead, K), dtype=torch.int32, device="cuda")
        c, t, over = updates.theta_to_ell(theta, P, dtype)
        c2, t2 = updates.ell_topk(theta, P, dtype)
    for got in (c, t, c2, t2):
        assert got.device.type == "cuda" and got.dtype == dtype
        assert got.shape == (*lead, min(P, K))
    assert over.dtype == torch.bool and over.shape == lead
    assert len(calls) == 2 and kernel.ell_select.launches == before


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA kernel"), ("int64", "dtype"), ("strided", "contiguous"),
    ("ell_int8", "int16 or int32"), ("no_topics", "K >= 1")])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """The checks run before the op, on fake ``cuda`` tensors as on real
    ones: the kernel takes contiguous int32 theta on the card and an int16
    or int32 ELL."""
    dtype = torch.int8 if case == "ell_int8" else torch.int16
    with FakeTensorMode():
        theta = torch.empty((6, 64), dtype=torch.int32, device="cuda")
        theta = {"int64": theta.long(), "strided": theta.t(),
                 "no_topics": theta.narrow(1, 0, 0)}.get(case, theta)
        if case == "cpu":
            theta = torch.empty((6, 64), dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            kernel.ell_select(theta, 8, dtype)


def test_probe_thetas_reach_the_large_count_path():
    """``kernel_probe.py --ell``'s thetas at NYTimes' mean length: every
    row sums to its document's length; the few-topic theta holds a count of
    128 or more (the kernel's path past its histogram) in most rows, the
    random one in none, so the probe times both paths; the byte bound
    counts theta once and the ELL and its flag once."""
    import chip_smoke
    import kernel_probe

    D, K, mean, P = 2000, 1024, 332, 512
    traffic = dict(kernel_probe.ELL_TRAFFIC)
    sums = None
    for name, over_127 in (("random", 0), ("few_topics", D // 2)):
        theta = kernel_probe.ell_theta(D, K, mean, traffic[name], 7,
                                       torch.device("cpu"))
        assert theta.dtype == torch.int32 and theta.shape == (D, K)
        assert int(theta.min()) >= 0
        peak = int((theta.amax(1) > 127).sum())
        assert peak > over_127 if over_127 else peak == 0
        row_sums = theta.sum(1)
        assert sums is None or torch.equal(row_sums, sums)   # same lengths
        sums = row_sums
    assert chip_smoke.ell_bytes(theta, P, torch.int16) == \
        D * K * 4 + D * P * 2 * 2 + D
