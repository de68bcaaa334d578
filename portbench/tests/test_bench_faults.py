"""A whole run of each cell's kind on the CPU at a tiny size, the chip's
look skipped: sound, it comes out correct; with the timed path broken
underneath in each way a training step can break, or with the program
under another prior than the configuration's, not."""
import pytest

from portbench.tests import faults, tiny


def test_sound_run_is_correct_and_reports_its_metrics():
    res = tiny.measure("nytimes-train")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 10 and res["failed"] == 0
    assert set(res["metrics"]) == {"tokens_per_s", "iter_ms_p90",
                                   "peak_gb", "setup_s"}
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_traced_run_on_the_cpu_reports_no_device_metric():
    res = tiny.measure("pubmed-train", trace=True)
    assert res["correct"], res["checks"]
    for name in ("k1_roofline", "k2_roofline", "idle_share", "step_mfu",
                 "sync_ms"):
        assert name not in res["metrics"]
    assert {"prep_s", "theta_ell_ms", "ll_eval_ms"} <= set(res["metrics"])
    assert "busy_s" not in res["device"] and "breakdown" not in res


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half,
                                   faults.altered, faults.prior],
                         ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch.setattr)
    res = tiny.measure("nytimes-train")
    assert not res["correct"]
    assert res["failed"] == 1


def test_four_ranks_are_correct_and_without_the_exchange_not():
    res = tiny.measure("nytimes-train-4card")
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
    res = tiny.measure("nytimes-train-4card",
                       hook="portbench.tests.faults:no_exchange")
    assert not res["correct"]
    assert res["checks"]["phi_errors"]["value"] > 0
