"""Nothing a run loads has the top-level name of JAX or of the JAX
package (``repro``; compared whole, since ``repro_torch`` begins with
it), and without a card the command prints no result."""
import json
import subprocess
import sys

from portbench import foreign, run

RUN = """
import sys, json
sys.path[:0] = [{root!r}, {src!r}]
from portbench.tests import tiny
if __name__ == "__main__":
    res = tiny.measure({cell!r}, trace=True)
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(cell):
    code = RUN.format(root=str(run.ROOT), src=str(run.ROOT / "src"),
                      cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules("nytimes-train")
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & set(foreign.FOREIGN)


def test_foreign_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro" not in foreign.loaded()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in foreign.loaded()


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nytimes-train",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=run.ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
