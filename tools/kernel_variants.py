"""What the kernel design-variant tools (``tools/*_variants.py``) share:
build each variant of one ``csrc/`` source into a shared library of its
own, check its output against the committed source's, and time it.

A variant is a list of (committed text, replacement) pairs applied to
the source or, where the text is not in the source, to the one
``csrc/*.cuh`` header that holds it. Every variant compiles alone (one
``nvcc`` per variant, all started together, with ``-Xptxas -v``) beside
its copy of every header; registers and spills come from ptxas. Times are
CUDA-event medians of 10 launches, taken in two rounds over all
variants within the one call. A variant whose name starts with
``probe: `` leaves out part of the work to time the rest; its output is
compared but need not equal. Needs ``nvcc`` and one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "threecrate_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT))
# a variant named so is a timing probe: it leaves out part of the work, so
# its output is not held to the committed source's
PROBE = "probe: "


def build(tmp: Path, source: str, variants, functions, label):
    """{variant: (loaded library, ptxas lines)} for ``csrc/<source>`` with
    each variant's substitutions; ``functions`` are the C entry points to
    bind, ``label(entry)`` names a kernel whose registers to report (None
    for the others)."""
    from threecrate_tpu_torch.kernels import _build

    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        # the source and every header; a substitution applies where its
        # text occurs once: in the source, else in exactly one header
        files = {source: (CSRC / source).read_text(),
                 **{h.name: h.read_text() for h in CSRC.glob("*.cuh")}}
        for old, new in subs:
            where = [f for f, text in files.items() if old in text]
            if files[source].count(old) == 1:
                where = [source]
            if len(where) != 1 or files[where[0]].count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old[:60]!r} not found once in the "
                                 "source or its headers")
            files[where[0]] = files[where[0]].replace(old, new)
        d = tmp / f"v{i}"
        d.mkdir()
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in functions:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, ptxas_summary(log, label))
    return libs


def ptxas_summary(log: str, label):
    """'label: N registers, S bytes spilled' for each kernel entry of a
    ptxas -v log that ``label`` names."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = label(m.group(1)), 0
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{entry}: {m.group(1)} registers, {spill} bytes spilled")
            entry = None
    return out


def compare_and_time(libs, runs, launch, out, same=None):
    """{variant: report}: each run of ``runs`` launched once per variant
    (``launch(lib, run)`` writes ``out``, one tensor or a tuple of them)
    and compared with the committed variant's output (``same(run, got,
    committed)``, default bit-equality), then timed."""
    from threecrate_tpu_torch.utils.profiling import median_time

    outs = out if isinstance(out, (tuple, list)) else (out,)
    ref = {}
    for run in runs:
        for o in outs:
            o.fill_(-1)
        launch(libs["committed"][0], run)
        torch.cuda.synchronize()
        ref[run] = [o.clone() for o in outs]
    report = {}
    for name, (lib, regs) in libs.items():
        equal = []
        for run in runs:
            for o in outs:
                o.fill_(-1)
            launch(lib, run)
            torch.cuda.synchronize()
            equal.append(all((same or (lambda _, a, b: torch.equal(a, b)))(run, o, r)
                             for o, r in zip(outs, ref[run])))
        report[name] = {"rows_equal_committed": equal, "ptxas": regs,
                        "ms": {run: [] for run in runs}}
    for _ in range(2):
        for name, (lib, _) in libs.items():
            for run in runs:
                t = median_time(lambda lib=lib, run=run: launch(lib, run), warmup=1, iters=10)
                report[name]["ms"][run].append(1e3 * t)
    return report


def print_report(card: str, report, **meta) -> int:
    """One line per variant, then the JSON object as the last line; 0
    where every variant's output equals the committed source's (a probe's
    need not)."""
    ok = True
    for name, r in report.items():
        ok &= name.startswith(PROBE) or all(r["rows_equal_committed"])
        times = ", ".join(f"{run} {ms[0]:.4f} / {ms[1]:.4f}" for run, ms in r["ms"].items())
        print(f"{name}: {times} ms; rows equal to committed {r['rows_equal_committed']}; "
              f"{'; '.join(r['ptxas'])}", flush=True)
    print(json.dumps({"card": card, **meta, "variants": report}))
    return 0 if ok else 1
