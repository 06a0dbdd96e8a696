"""The command on the card: each cell once, a short window, traced and not
(``python -m pytest gsmbench/tests -m card`` on a machine with a CUDA
device; skips elsewhere)."""

import json
import subprocess
import sys

import pytest

from gsmbench.harness import cell as cell_mod

CELLS = [w["name"] for w in cell_mod.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(card, name, trace):
    got = subprocess.run(
        [sys.executable, "gsmbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 5), "--seconds", "2", "--trace", str(trace)],
        cwd=cell_mod.ROOT, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stderr[-3000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res["correct"] and 0 <= res["failed"] <= res["attempted"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    cell = cell_mod.load(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    assert list(res)[-1] == "checks"
