"""The port's data loader (``repro_torch.data.loader``): ``lm_batches``
gives the reference's numpy stream bit for bit, and ``PrefetchLoader``
keeps the order of its batches, places them on the given device, hands a
worker's exception to the consumer and stops its worker on ``close()``."""
import numpy as np
import pytest
import torch

from repro.data import loader as jloader
from repro_torch.data import loader


@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (128, 2, 16, 0), (32_000, 4, 128, 3), (153_600, 1, 300, 7)])
def test_lm_batches_equal_reference(vocab, batch, seq, seed):
    ours = loader.lm_batches(vocab, batch, seq, seed)
    theirs = jloader.lm_batches(vocab, batch, seq, seed)
    for i in (0, 1, 5):
        a, b = ours(i), theirs(i)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        assert a["tokens"].shape == (batch, seq)
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_prefetch_loader_keeps_order_and_device():
    make = loader.lm_batches(100, 2, 8, seed=1)
    ld = loader.PrefetchLoader(make, depth=2, device="cpu")
    try:
        got = [next(ld) for _ in range(5)]
    finally:
        ld.close()
    assert ld.device == torch.device("cpu")
    for i, b in enumerate(got):
        ref = make(i)
        for k in ("tokens", "labels"):
            assert isinstance(b[k], torch.Tensor)
            assert b[k].device == torch.device("cpu")
            np.testing.assert_array_equal(b[k].numpy(), ref[k])


def test_prefetch_loader_close_stops_the_worker():
    """close() returns with the worker stopped, also while the worker is
    blocked on a full queue."""
    made = []

    def make(i):
        made.append(i)
        return {"x": np.full((2,), i, np.int32)}

    ld = loader.PrefetchLoader(make, depth=1, device="cpu")
    assert int(next(ld)["x"][0]) == 0
    ld.close()
    assert not ld._thread.is_alive()
    assert len(made) <= 4    # one consumed, one queued, one held, one made


def test_prefetch_loader_raises_worker_errors():
    def make(i):
        if i == 2:
            raise ValueError("bad batch 2")
        return {"x": np.zeros(1, np.int32)}

    ld = loader.PrefetchLoader(make, device="cpu")
    try:
        next(ld), next(ld)
        with pytest.raises(ValueError, match="bad batch 2"):
            next(ld)
    finally:
        ld.close()
