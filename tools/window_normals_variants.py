#!/usr/bin/env python3
"""Time design variants of the fused window-normals kernel on one card.

    python3 tools/window_normals_variants.py

Each variant is ``threecrate_tpu_torch/csrc/union_window.cu`` with one
design choice changed by a text substitution (the culling chunk, the
exact body's seed band, the unrolling of the chunk loops, queries a
thread, the list size for k <= 12), built and timed as
``tools/kernel_variants.py`` says (registers and spills for k <= 12)
and launched through its ``tc_window_normals`` on the phase-3 inputs of
``chip_smoke.py``: the Morton-sorted 1M scan, k = 10, tile 256, at band
16 (``window_fast``'s shape) and band 0 (the exact body). Every
variant's six rows must equal the committed source's on every query.
The last line is one JSON object with the card and every variant's
numbers. Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

K, TILE, BAND = 10, 256, 16
# name -> (committed text, replacement) pairs applied to union_window.cu, or to
# the header that holds the text (kChunk and the selection sweep: window.cuh)
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


def label(entry: str):
    """The body of a KMAX-12 window-normals kernel entry, else None."""
    if "window_normals" not in entry or "ILi12E" not in entry:
        return None
    return "exact" if "exact" in entry else "band"


def main() -> int:
    if not torch.cuda.is_available():
        print("window_normals_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    pa, va, _, _ = chip_smoke.sorted_scan(dev)
    pts = pa.T.contiguous()
    valid = va[None].contiguous()
    n = pts.shape[1]
    out = torch.empty((6, n), device=dev)
    runs = {"band 16": BAND, "band 0": 0}

    def launch(lib, run):
        band = runs[run]
        err = lib.tc_window_normals(pts.data_ptr(), valid.data_ptr(), out.data_ptr(), n,
                                    TILE, K, max(band, K) if band else 0,
                                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "union_window.cu", VARIANTS,
                                     ("tc_window_normals",), label)
        report = kernel_variants.compare_and_time(libs, runs, launch, out)
    return kernel_variants.print_report(card, report, k=K, tile=TILE, n=n)


if __name__ == "__main__":
    sys.exit(main())
