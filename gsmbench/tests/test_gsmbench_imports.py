"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the renderer.  Top-level module names are
compared whole: ``gsm_renderer_tpu_torch`` begins with
``gsm_renderer_tpu`` and is another package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from gsmbench import run

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gsm_renderer_tpu"}
RENDERER = "gsm_renderer_tpu_torch"


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative imports
    resolve inside gsmbench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


def test_modules_found():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_renderer(path):
    got = _imports(path)
    assert RENDERER not in got and not got & FORBIDDEN
    assert got <= {"__future__", "dataclasses", "math", "numpy", "torch"}, got


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import gsm_renderer_tpu_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "gsm_renderer_tpu_extra.x", object())
    assert set(run.forbidden_modules()) <= FORBIDDEN
    monkeypatch.setitem(sys.modules, "gsm_renderer_tpu.kernels", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"jax", "gsm_renderer_tpu"} <= set(run.forbidden_modules())


def test_run_loads_no_jax():
    """A whole run, in a fresh interpreter, leaves no forbidden module in
    sys.modules (the check run.main makes before it prints a result)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gsmbench import run\n"
        "from gsmbench.tests.conftest import tiny\n"
        "res = run.run_cell(tiny('xr-stereo-1m.foveated', 2000, 96, 64),"
        " 3, 0.2, False, 'cpu')\n"
        "assert res['attempted'] > 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "assert run.forbidden_modules() == [], run.forbidden_modules()\n"
    ) % str(BENCH.parent)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    assert RENDERER in got.stdout


def test_no_card_exits_nonzero(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "garden-mono-1080p.orbit", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
