#!/usr/bin/env python3
"""Count the work of kernels 3 and 5's culled sweeps on the CPU.

    python3 tools/selection_counts.py

Runs the numpy emulations of ``tests/test_torch_icp_match_selection.py``
and ``tests/test_torch_knn_window_selection.py`` (each held bit for bit
to the plain versions there) on a seeded sample of ``chip_smoke.py``'s
1M inputs: 300 source tiles of the ICP pair (tile 128, w_tiles 3) and
60 query tiles of the sorted scan (tile 128), each with its own window.
It prints, per point or query: the columns a warp of ``icp_match``
sweeps, by the warp's centroid order and from the middle tile on; the
insertion steps a warp of the list body runs at k = 10 and 9, queued
and direct; and the merges of 32 keys a query of the warp body at
k = 17, 33, 64 (self excluded) and 128 (self excluded). The last line
is one JSON object with them. Counts only: no time, no device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import chip_smoke  # noqa: E402
import test_torch_icp_match_selection as icp_emu  # noqa: E402
import test_torch_knn_window_selection as knn_emu  # noqa: E402

TILE = 128


def icp_counts(rng):
    src, tgt, ws = chip_smoke.icp_inputs(torch.device("cpu"), 0)
    tiles = np.sort(rng.choice(src.shape[1] // TILE, 300, replace=False))
    cols = (tiles[:, None] * TILE + np.arange(TILE)).ravel()
    args = (src[:, cols].numpy(), tgt.numpy(), ws[tiles].numpy(), TILE, 3)
    out = {}
    for name, order in (("centroid order", True), ("middle tile first", False)):
        icp_emu.WARP_ORDER = order
        _, _, _, (examined, swept), _ = icp_emu.emulate_sweep(*args)
        out[name] = {"warp_columns": float(swept.mean()), "thread_columns": float(examined.mean())}
    return out


def knn_counts(rng):
    pa, va, _, perm = chip_smoke.sorted_scan(torch.device("cpu"))
    pts, valid = pa.T.contiguous().numpy(), va.numpy()
    ids = perm.numpy().astype(np.int32)
    tiles = rng.choice(np.arange(1, pts.shape[1] // TILE - 1), 60, replace=False)
    out = {}
    for k, excl in ((10, False), (9, False), (17, False), (33, False), (64, True), (128, True)):
        body, size = knn_emu.body_of(k)
        runs = {"queued": knn_emu.QUEUE, "direct": 0} if body == "list" else {"merges": None}
        got = {name: [] for name in runs}
        for t in tiles:
            sl = slice((t - 1) * TILE, (t + 2) * TILE)     # the middle tile's window
            d2, lb, *_ = knn_emu._inputs(pts[:, sl], valid[sl], ids[sl], TILE, excl)
            for name, queue in runs.items():
                if body == "list":
                    _, steps = knn_emu.emulate_list(d2, lb, TILE, k, size, queue=queue)
                else:
                    _, _, steps = knn_emu.emulate_warp(d2, lb, TILE, k, size, excl)
                got[name].append(steps[TILE:2 * TILE])
        out[f"k={k}{' exclude_self' * excl}"] = {name: float(np.concatenate(v).mean())
                                                 for name, v in got.items()}
    return out


def main() -> int:
    rng = np.random.default_rng(0)
    report = {"icp_match": icp_counts(rng), "knn_window": knn_counts(rng)}
    for kernel, rows in report.items():
        for name, vals in rows.items():
            print(f"{kernel} {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in vals.items()),
                  flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
