"""The port's PubMed configuration against the reference's, and the port's
four examples (examples/torch_*.py) run in process on the CPU at tiny
sizes."""
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

from repro.configs import lda_pubmed as ref_pubmed
from repro_torch.configs import lda_pubmed

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def example(monkeypatch):
    """Import an example by its module name (spawned ranks unpickle their
    function by it), examples/ on the path for this test."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    return importlib.import_module


def test_pubmed_config_matches_reference():
    ours, theirs = lda_pubmed.CONFIG, ref_pubmed.CONFIG
    shared = ({f.name for f in dataclasses.fields(ours)}
              & {f.name for f in dataclasses.fields(theirs)}) - {"sampler",
                                                                 "topic_dtype"}
    assert shared >= {"num_topics", "alpha", "beta", "tile_tokens",
                      "ell_capacity", "micro_chunks", "seed"}
    for name in sorted(shared):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert str(ours.topic_dtype).split(".")[-1] == \
        np.dtype(theirs.topic_dtype).name == "int16"
    assert lda_pubmed.FULL == ref_pubmed.FULL
    assert lda_pubmed.alpha() == ours.resolved_alpha() == 50.0 / 1024


@pytest.mark.parametrize("scale", [0.0002, 0.01])
def test_pubmed_scaled_corpus_matches_reference(scale):
    """The same seed gives the same corpus; from scale 0.01 V is the full
    141,043."""
    ours, theirs = lda_pubmed.scaled(scale, seed=3), ref_pubmed.scaled(scale,
                                                                      seed=3)
    assert (ours.num_docs, ours.num_words) == (theirs.num_docs,
                                               theirs.num_words)
    np.testing.assert_array_equal(ours.doc_ids, np.asarray(theirs.doc_ids))
    np.testing.assert_array_equal(ours.word_ids, np.asarray(theirs.word_ids))
    if scale >= 0.01:
        assert ours.num_words == lda_pubmed.FULL["num_words"]


def test_quickstart_example_runs(example, capsys):
    res = example("torch_quickstart").main(["--device", "cpu", "--iters",
                                             "10"])
    out = capsys.readouterr().out
    assert "LL/token" in out and "sampling speed" in out
    assert res.ll_per_token[-1] > res.ll_per_token[0]


def test_train_example_checkpoints_and_resumes(example, tmp_path, capsys):
    args = ["--device", "cpu", "--iters", "4", "--topics", "16", "--scale",
            "0.0001", "--ckpt-every", "2", "--eval-every", "2", "--ckpt-dir",
            str(tmp_path)]
    mod = example("torch_train_lda")
    res = mod.main(args)
    assert len(res.ll_per_token) == 2 and "mean throughput" in \
        capsys.readouterr().out
    res2 = mod.main(args[:3] + ["6"] + args[4:])     # 2 more iterations
    assert "[resume] iteration 4" in capsys.readouterr().out
    assert len(res2.tokens_per_sec) == 2 and res2.state.iteration == 6


def test_serve_example_serves_swaps_and_shards(example, capsys):
    out = example("torch_serve_lda").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert len(out["results"]) == 24
    assert all(abs(float(r["theta"].sum()) - 1.0) < 1e-4
               for r in out["results"])
    assert out["version"] == 3 and out["swapped"]["model_version"] == 3
    assert "2-way V-sharded" in text and np.isfinite(
        out["perplexity"].perplexity)


def test_multi_device_example_on_two_gloo_ranks(example, capsys):
    rows = example("torch_multi_device_lda").main(
        ["--device", "cpu", "--ranks", "2", "--iters", "2"])
    assert rows["2d"]["shape"] == [1, 2]
    for key in ("one", "1d", "2d"):
        assert np.isfinite(rows[key]["ll"]) and rows[key]["ms_per_iter"] > 0
    assert "speedup vs 1 device" in capsys.readouterr().out
