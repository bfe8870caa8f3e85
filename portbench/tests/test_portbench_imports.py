"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

PB = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_source_imports_jax(path):
    assert not top_level_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("threecrate_tpu_torch", "threecrate_tpu_torch.ops", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name, object()))
    found = run.forbidden_modules()
    assert "threecrate_tpu" not in found and "jax" not in found
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    code = ("import sys, runpy; sys.argv = ['run.py']; "
            "import portbench.run as r, portbench.calibrate, portbench.entries.perception_step, "
            "portbench.entries.registration_model; import threecrate_tpu_torch; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=PB.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "lidar-8m.track",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=PB.parent, env={"CUDA_VISIBLE_DEVICES": "",
                                                          "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
