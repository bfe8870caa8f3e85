#!/usr/bin/env python3
"""Time design variants of the fused window-normals kernel on one card.

    python3 tools/window_normals_variants.py

Each variant is ``threecrate_tpu_torch/csrc/union_window.cu`` with one
design choice changed by a text substitution (the culling chunk, the
exact body's seed band, the unrolling of the chunk loops, queries a
thread, the list size for k <= 12), compiled
alone into a shared library (one ``nvcc`` per variant, all started
together, with ``-Xptxas -v``) and launched through its
``tc_window_normals`` on the phase-3 inputs of ``chip_smoke.py``: the
Morton-sorted 1M scan, k = 10, tile 256, at band 16 (``window_fast``'s
shape) and band 0 (the exact body). Every variant's six rows must equal
the committed source's on every query. Times are CUDA-event medians of
10 launches, taken in two rounds over all variants within the one call;
each variant's registers and spills for k <= 12 come from ptxas. The
last line is one JSON object with the card and every variant's numbers.
Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K, TILE, BAND = 10, 256, 16
# name -> (committed text, replacement) pairs applied to union_window.cu
SEL_LOOP = "#pragma unroll 4\n    for (int c = c0; c < c1; ++c) select_candidate"
SUM_LOOP = "#pragma unroll 4\n      for (int c = c0; c < c1; ++c) sum_candidate"
VARIANTS = {
    "committed": [],
    "no culling (one box)": [("kChunk = 16;", "kChunk = 4096;")],
    "8-column chunks": [("kChunk = 16;", "kChunk = 8;")],
    "32-column chunks": [("kChunk = 16;", "kChunk = 32;")],
    "exact seed +-k": [("tile, base, k, min(2 * k, tile), qi,", "tile, base, k, k, qi,")],
    "chunk loops unrolled 2": [(SEL_LOOP, SEL_LOOP.replace("unroll 4", "unroll 2")),
                               (SUM_LOOP, SUM_LOOP.replace("unroll 4", "unroll 2"))],
    "2 queries a thread": [("kNormalQueries = 1;", "kNormalQueries = 2;")],
    "16-entry list at k <= 12": [("if (k <= 12) return launch_normals<12>",
                                  "if (k <= 12) return launch_normals<16>")],
}


def build(tmp: Path):
    """{variant: (loaded library, ptxas lines of its k <= 12 normals kernels)}."""
    from threecrate_tpu_torch.kernels import _build

    csrc = ROOT / "threecrate_tpu_torch" / "csrc"
    source = (csrc / "union_window.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old!r} not found once in the source")
            text = text.replace(old, new)
        d = tmp / f"v{i}"
        d.mkdir()
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "union_window.cu").write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / "union_window.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.tc_window_normals.argtypes = _build._SIGNATURES["tc_window_normals"]
        lib.tc_window_normals.restype = ctypes.c_int
        libs[name] = (lib, ptxas_summary(log))
    return libs


def ptxas_summary(log: str):
    """'kernel: N registers, S bytes spilled' for the KMAX-12 window-normals
    kernels in a ptxas -v log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        if entry is None or "window_normals" not in entry or "ILi12E" not in entry:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            body = "exact" if "exact" in entry else "band"
            out.append(f"{body}: {m.group(1)} registers, {spill} bytes spilled")
            entry = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("window_normals_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from threecrate_tpu_torch.utils.profiling import median_time

    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        pa, va, _, _ = chip_smoke.sorted_scan(dev)
        pts = pa.T.contiguous()
        valid = va[None].contiguous()
        n = pts.shape[1]
        out = torch.empty((6, n), device=dev)

        def launch(lib, band):
            err = lib.tc_window_normals(pts.data_ptr(), valid.data_ptr(), out.data_ptr(), n,
                                        TILE, K, max(band, K) if band else 0,
                                        torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")

        ref = {}
        for band in (BAND, 0):
            launch(libs["committed"][0], band)
            torch.cuda.synchronize()
            ref[band] = out.clone()
        report = {}
        for name, (lib, regs) in libs.items():
            equal = []
            for band in (BAND, 0):
                launch(lib, band)
                torch.cuda.synchronize()
                equal.append(bool(torch.equal(out, ref[band])))
            report[name] = {"rows_equal_committed": equal, "ptxas": regs,
                            "band16_ms": [], "band0_ms": []}
        for _ in range(2):
            for name, (lib, _) in libs.items():
                for band, key in ((BAND, "band16_ms"), (0, "band0_ms")):
                    t = median_time(lambda lib=lib, band=band: launch(lib, band),
                                    warmup=1, iters=10)
                    report[name][key].append(1e3 * t)
    ok = True
    for name, r in report.items():
        ok &= all(r["rows_equal_committed"])
        print(f"{name}: band 16 {r['band16_ms'][0]:.4f} / {r['band16_ms'][1]:.4f} ms, "
              f"band 0 {r['band0_ms'][0]:.4f} / {r['band0_ms'][1]:.4f} ms, rows equal to "
              f"committed {r['rows_equal_committed']}; {'; '.join(r['ptxas'])}", flush=True)
    print(json.dumps({"card": card, "k": K, "tile": TILE, "n": n, "variants": report}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
