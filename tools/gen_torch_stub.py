"""Generate the port's typed public-surface stub
(threecrate_tpu_torch/__init__.pyi).

The port's copy of ``tools/gen_stub.py``'s method, for
``threecrate_tpu_torch``: the stub is *derived* from the live module by
introspection — run this after changing ``threecrate_tpu_torch/api.py``
exports:

    python tools/gen_torch_stub.py

It imports torch and the port, never JAX. Emits, for every name in
``threecrate_tpu_torch.api.__all__`` plus the core classes re-exported
by ``__init__``:
  * functions — real signatures (defaults elided to ``...``),
  * classes — public methods, properties and dataclass/NamedTuple
    fields,
  * constants — name: type.

tests/test_torch_stubs.py asserts the checked-in stub matches the runtime
surface.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import sys
import types
import typing


def _fmt_annotation(ann) -> str:
    if ann is inspect.Parameter.empty:
        return ""
    if isinstance(ann, str):
        return ann
    if ann is None or ann is type(None):
        return "None"
    if isinstance(ann, type):
        mod = ann.__module__
        if mod in ("builtins", "threecrate_tpu_torch"):
            return ann.__qualname__
        if mod.startswith("threecrate_tpu_torch"):
            return ann.__name__
        if mod.startswith("numpy"):
            return f"np.{ann.__name__}"
        if mod.startswith("torch"):
            return f"torch.{ann.__name__}"
        return f"{mod}.{ann.__name__}"
    return str(ann).replace("typing.", "").replace("numpy.", "np.")


def _fmt_sig(fn, *, drop_self: bool = False) -> str:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return "(*args, **kwargs)"
    parts = []
    params = list(sig.parameters.values())
    if drop_self and params and params[0].name in ("self", "cls"):
        params = params[1:]
        parts.append("self")
    for p in params:
        s = p.name
        if p.kind == p.VAR_POSITIONAL:
            s = "*" + s
        elif p.kind == p.VAR_KEYWORD:
            s = "**" + s
        ann = _fmt_annotation(p.annotation)
        if ann:
            s += f": {ann}"
        if p.default is not p.empty:
            s += " = ..." if ann else "=..."
        parts.append(s)
    ret = _fmt_annotation(sig.return_annotation)
    out = f"({', '.join(parts)})"
    if ret:
        out += f" -> {ret}"
    return out


def _class_stub(name: str, cls: type) -> list[str]:
    lines = [f"class {name}:"]
    body: list[str] = []
    hints = {}
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = getattr(cls, "__annotations__", {}) or {}
    if dataclasses.is_dataclass(cls):
        for f in dataclasses.fields(cls):
            ann = _fmt_annotation(hints.get(f.name, f.type))
            default = " = ..." if (f.default is not dataclasses.MISSING or
                                   f.default_factory is not dataclasses.MISSING) \
                else ""
            body.append(f"    {f.name}: {ann}{default}")
        body.append(f"    def __init__{_fmt_sig(cls.__init__, drop_self=True)}: ...")
    elif issubclass(cls, tuple) and hasattr(cls, "_fields"):  # NamedTuple
        for fname in cls._fields:
            ann = _fmt_annotation(hints.get(fname, ""))
            body.append(f"    {fname}: {ann or 'typing.Any'}")
    else:
        for fname, ann in hints.items():
            if not fname.startswith("_"):
                body.append(f"    {fname}: {_fmt_annotation(ann)}")
        init = cls.__dict__.get("__init__")
        if init is not None and not name.endswith("Error"):
            body.append(
                f"    def __init__{_fmt_sig(init, drop_self=True)}: ...")
    for mname, m in sorted(vars(cls).items()):
        if mname.startswith("_"):
            continue
        if isinstance(m, property):
            fget = m.fget
            ret = _fmt_annotation(
                inspect.signature(fget).return_annotation) if fget else ""
            body.append("    @property")
            body.append(f"    def {mname}(self){' -> ' + ret if ret else ''}: ...")
        elif isinstance(m, staticmethod):
            body.append("    @staticmethod")
            body.append(f"    def {mname}{_fmt_sig(m.__func__)}: ...")
        elif isinstance(m, classmethod):
            body.append("    @classmethod")
            body.append(
                f"    def {mname}{_fmt_sig(m.__func__, drop_self=True)}: ...")
        elif callable(m):
            body.append(f"    def {mname}{_fmt_sig(m, drop_self=True)}: ...")
    if not body:
        body = ["    ..."]
    return lines + body + [""]


def generate() -> str:
    import threecrate_tpu_torch as tc

    out = [
        '"""Typed public surface of threecrate_tpu_torch (generated — do not',
        "edit by hand; regenerate with `python tools/gen_torch_stub.py`).",
        "",
        "Counterpart of the reference's threecrate-python/threecrate.pyi.",
        '"""',
        "",
        "import typing",
        "from typing import (Any, Callable, Dict, Iterable, Iterator, List,",
        "                    Optional, Sequence, Tuple, Union)",
        "",
        "import numpy as np",
        "import torch",
        "",
        "__version__: str",
        "",
    ]
    names = sorted(set(tc.api.__all__) | {
        "PointCloud", "TriangleMesh", "Transform",
        "OrganizedPointCloud", "CameraIntrinsics"})
    consts, funcs, classes = [], [], []
    for n in names:
        v = getattr(tc, n)
        if isinstance(v, type):
            classes.append((n, v))
        elif callable(v):
            funcs.append((n, v))
        elif isinstance(v, types.ModuleType):
            continue
        else:
            consts.append((n, v))
    for n, v in consts:
        out.append(f"{n}: {type(v).__name__}")
    out.append("")
    body: list[str] = []
    for n, cls in classes:
        body.extend(_class_stub(n, cls))
    for n, fn in funcs:
        body.append(f"def {n}{_fmt_sig(fn)}: ...")

    # close over annotation-referenced internal classes that are not
    # themselves exported (e.g. AlphaMode inside AlphaShapeConfig):
    # pull their stubs in transitively; alias anything unresolvable to Any
    import ast as _ast
    defined = {n for n, _ in classes}
    known = set(dir(typing)) | {"np", "torch", "typing", "None",
                                "self", "cls"} | set(dir(__builtins__)) \
        | {"bool", "int", "float", "str", "bytes", "list", "dict", "tuple",
           "set", "type", "object", "slice"} | {n for n, _ in consts} \
        | {n for n, _ in funcs}
    registry: dict[str, type] = {}
    for mod in list(sys.modules.values()):
        if mod and getattr(mod, "__name__", "").startswith("threecrate_tpu_torch"):
            for an, av in vars(mod).items():
                if isinstance(av, type) and not an.startswith("_"):
                    registry.setdefault(an, av)
    for _ in range(4):  # transitive closure, bounded
        text = "\n".join(body)
        missing = set()
        for node in _ast.walk(_ast.parse(text)):
            if isinstance(node, _ast.Name) and node.id[:1].isupper() \
                    and node.id not in defined and node.id not in known:
                missing.add(node.id)
        if not missing:
            break
        for name in sorted(missing):
            if name in registry:
                body.extend(_class_stub(name, registry[name]))
                defined.add(name)
            else:
                out.append(f"{name}: typing.TypeAlias = Any")
                known.add(name)
    out.append("")
    out.extend(body)
    out.append("")
    return "\n".join(out)


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    stub_path = os.path.join(here, "threecrate_tpu_torch", "__init__.pyi")
    text = generate()
    import ast
    ast.parse(text)  # a stub that does not parse is worse than none
    with open(stub_path, "w") as f:
        f.write(text)
    with open(os.path.join(here, "threecrate_tpu_torch", "py.typed"), "w") as f:
        f.write("")
    print(f"wrote {stub_path} ({len(text.splitlines())} lines)")


if __name__ == "__main__":
    main()
