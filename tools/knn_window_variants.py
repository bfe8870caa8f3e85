#!/usr/bin/env python3
"""Time design variants of the window kNN kernel on one card.

    python3 tools/knn_window_variants.py

Each variant is ``threecrate_tpu_torch/csrc/knn_window.cu`` (with its
headers) with one design choice changed by a text substitution: the cut
between the list body and the warp body (the list body up to k = 32,
the warp body from k = 13), a 16-entry list at k <= 12, the list body at
k = 64 (a 64-entry register list) instead of the warp body, no culling,
the list body's insertions made directly (no queue) or through a queue
of 16, and a seed of KB columns (k rounded up to 32, 64 or 128) in the
warp body instead of ~2k. Each is built and timed as ``tools/kernel_variants.py`` says,
launched through its ``tc_knn_window`` on the phase-3 inputs of
``chip_smoke.py``: the sorted 1M scan, tile 128, at its ``KNN_SHAPES``
(k = 10, k = 10 with coordinates, k = 9, k = 64 with self excluded,
k = 128 with coordinates and self excluded) and at k = 16, 17 and 33,
either side of the cut between the bodies. Every variant's outputs must equal the
committed source's in every slot. The last line is one JSON object with
the card and every variant's numbers. An earlier source is timed by
running ``chip_smoke.py`` from a ``git archive`` of it beside one of
this tree, in one call. Needs one CUDA card and ``nvcc``; exits non-zero
without them.
"""

from __future__ import annotations

import re
import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

TILE, KMAX = 128, 128
VARIANTS = {
    "committed": [],
    "list body to k <= 32": [("if (k <= 32) return launch_warp<32>(a);",
                              "if (k <= 32) return launch_list<32>(a);")],
    "warp body from k > 12": [("if (k <= 16) return launch_list<16>(a);",
                               "if (k <= 16) return launch_warp<32>(a);")],
    "16-entry list at k <= 12": [("if (k <= 12) return launch_list<12>(a);",
                                  "if (k <= 12) return launch_list<16>(a);")],
    "list body at k = 64": [("if (k <= 64) return launch_warp<64>(a);",
                             "if (k <= 64) return launch_list<64>(a);")],
    "no culling": [("const float4* cull_box = box;", "const float4* cull_box = nullptr;"),
                   ("        if (((open >> (ch % kWarp)) & 3u) == 0u) continue;\n", "")],
    "direct insertion": [("kListQueue = 32;", "kListQueue = 0;")],
    "queue of 16": [("kListQueue = 32;", "kListQueue = 16;")],
    "seed of KB columns": [("max((kSeedPerK * k + kWarp / 2) / kWarp, 1) * kWarp",
                            "KB")],
}


def label(entry: str):
    """The body and list size of a knn_window kernel entry."""
    m = re.search(r"knn_(list|warp)_kernelILi(\d+)ELb(\d)E", entry)
    return None if m is None else f"{m.group(1)} {m.group(2)}{' excl' * int(m.group(3))}"


def main() -> int:
    if not torch.cuda.is_available():
        print("knn_window_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    pa, va, _, perm_a = chip_smoke.sorted_scan(dev)
    pts, valid = pa.T.contiguous(), va[None].contiguous()
    ids = perm_a.to(torch.int32)[None].contiguous()
    n = pts.shape[1]
    runs = {**chip_smoke.KNN_SHAPES, "k=16": (16, False, False), "k=17": (17, False, False),
            "k=33": (33, False, False)}
    neg = torch.empty((KMAX, n), device=dev)
    idx = torch.empty((KMAX, n), dtype=torch.int32, device=dev)
    crd = torch.empty((3 * KMAX, n), device=dev)

    def launch(lib, run):
        k, coords, excl = runs[run]
        err = lib.tc_knn_window(pts.data_ptr(), valid.data_ptr(), ids.data_ptr(),
                                neg.data_ptr(), idx.data_ptr(), crd.data_ptr(), n, TILE, k,
                                int(coords), int(excl), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "knn_window.cu", VARIANTS, ("tc_knn_window",),
                                     label)
        report = kernel_variants.compare_and_time(libs, list(runs), launch, (neg, idx, crd))
    return kernel_variants.print_report(card, report, tile=TILE, n=n)


if __name__ == "__main__":
    sys.exit(main())
