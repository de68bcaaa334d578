"""The judge's control (the reference in bfloat16 in the program's place)
and its planted faults come out not correct by each cell's limits; the
sound program comes out correct."""
import pytest
import torch

from portbench import control, run
from portbench.tests import tiny


def _readings(name, device="cpu", size=None, seconds=0.3):
    _, files = tiny.cell(name)
    if size:
        files["config"].update(size)
    spec = dict(config=files["config"], traffic=files["traffic"],
                seed=tiny.SEED, seconds=seconds, trace=False, device=device)
    return control.run(spec), files["limits"]


@pytest.mark.parametrize("name", ["nytimes-train", "pubmed-train"])
def test_control_and_faults_fail_the_limits(name):
    found, limits = _readings(name)
    assert run.verdict(found["sound"], limits)[0]
    for case in ("control", "unchanged", "half", "altered"):
        assert not run.verdict(found[case], limits)[0], case


def test_four_ranks_control_and_faults_fail_the_limits():
    found, limits = _readings("nytimes-train-4card")
    assert run.verdict(found["sound"], limits)[0]
    for case in ("control", "unchanged", "half", "altered", "no_exchange"):
        assert not run.verdict(found[case], limits)[0], case


@pytest.mark.gpu
def test_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    size = dict(num_docs=20000, num_words=20000, avg_doc_len=200,
                num_topics=1024)
    found, limits = _readings("nytimes-train", "cuda", size, seconds=2)
    assert run.verdict(found["sound"], limits)[0], found["sound"]
    for case in ("control", "unchanged", "half", "altered"):
        assert not run.verdict(found[case], limits)[0], case
