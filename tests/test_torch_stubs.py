"""The port's checked-in typed stub must match its runtime public surface.

``tests/test_stubs.py``'s four tests against
``threecrate_tpu_torch/__init__.pyi`` (generated by
``tools/gen_torch_stub.py``) and its ``py.typed`` marker; and the
generator, like the port, imports no JAX.
"""

import ast
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import threecrate_tpu_torch as tt  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
STUB = os.path.join(os.path.dirname(tt.__file__), "__init__.pyi")


def _stub_names():
    with open(STUB) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def test_py_typed_marker_exists():
    assert os.path.exists(os.path.join(os.path.dirname(tt.__file__), "py.typed"))


def test_stub_parses_and_is_nonempty():
    with open(STUB) as f:
        tree = ast.parse(f.read())
    assert len(tree.body) > 100


def test_every_public_export_is_in_the_stub():
    stub = _stub_names()
    missing = [n for n in tt.api.__all__ if n not in stub]
    assert not missing, f"api exports missing from __init__.pyi: {missing}"
    for n in ("PointCloud", "TriangleMesh", "Transform",
              "OrganizedPointCloud", "CameraIntrinsics", "__version__"):
        assert n in stub


def test_stub_names_exist_at_runtime():
    """Every name of the stub is a root name, or a class of a loaded
    module of the port (the annotation closure, e.g. ``AlphaMode``)."""
    dead = [n for n in _stub_names() if not n.startswith("__") and not hasattr(tt, n)]
    importlib.import_module("threecrate_tpu_torch.reconstruction.alpha_shape")
    really_dead = [n for n in dead if not any(
        getattr(m, "__name__", "").startswith("threecrate_tpu_torch") and hasattr(m, n)
        for m in list(sys.modules.values()) if m)]
    assert not really_dead, f"stub names with no runtime object: {really_dead}"


def test_generator_reproduces_the_stub_without_jax(tmp_path):
    """``tools/gen_torch_stub.py`` imports neither JAX nor the JAX package,
    and regenerates the checked-in stub byte for byte."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|threecrate_tpu)(\s|\.|$)", re.M)
    assert not pattern.search((ROOT / "tools" / "gen_torch_stub.py").read_text())
    code = ("import runpy, sys\n"
            "gen = runpy.run_path(sys.argv[1])\n"
            "text = gen['generate']()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'threecrate_tpu')]\n"
            "assert not bad, bad\n"
            "open(sys.argv[2], 'w').write(text)\n")
    out = tmp_path / "stub.pyi"
    subprocess.run([sys.executable, "-c", code, str(ROOT / "tools" / "gen_torch_stub.py"),
                    str(out)], check=True, timeout=120, cwd=ROOT,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.read_text() == Path(STUB).read_text()
