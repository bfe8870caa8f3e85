#!/usr/bin/env python3
"""The JAX package's result on the CPU for ``chip_smoke.py``'s phase 43
(``knn_grid`` at k = 10 on the 1M scan, with ``estimate_cell_size``),
beside the port's own CPU run of the same input.

    JAX_PLATFORMS=cpu python3 tools/io_references.py

Prints one JSON line: each package's cell size and recall of the exact
10 nearest neighbours (``chip_smoke.exact_nearest``) on the
``chip_smoke.grid_sample()`` queries, and the share of slots where the
two packages' ids agree. The database is the whole scan; only the
sampled rows are searched. No device is measured.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]

import chip_smoke  # noqa: E402


def main() -> None:
    import jax.numpy as jnp
    import torch

    from threecrate_tpu.ops import neighbors as jax_neighbors
    from threecrate_tpu_torch.ops import neighbors as port_neighbors

    pts = chip_smoke.scan(chip_smoke.N_SCAN, 0)
    sample = chip_smoke.grid_sample()
    mask = np.ones(len(pts), bool)
    k = chip_smoke.GRID_K
    t0 = time.perf_counter()
    jcell = jax_neighbors.estimate_cell_size(jnp.asarray(pts), jnp.asarray(mask), k)
    jres = jax_neighbors.knn_grid(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(pts[sample]), None, k, jcell)
    jids, jvalid = np.asarray(jres.indices), np.asarray(jres.mask)
    t1 = time.perf_counter()
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    tcell = port_neighbors.estimate_cell_size(tp, tm, k)
    tres = port_neighbors.knn_grid(tp, tm, tp[sample], None, k, tcell)
    exact = chip_smoke.exact_nearest(tp, tp[sample], k)
    print(json.dumps({
        "section": "knn_grid", "points": len(pts), "queries": len(sample), "k": k,
        "jax_cell": jcell, "port_cpu_cell": tcell,
        "jax_recall": chip_smoke.grid_recall(torch.from_numpy(jids).long(),
                                             torch.from_numpy(jvalid), exact),
        "port_cpu_recall": chip_smoke.grid_recall(tres.indices, tres.mask, exact),
        "ids_agree": float((tres.indices.numpy() == jids)[jvalid].mean()),
        "jax_cpu_s": t1 - t0}))


if __name__ == "__main__":
    main()
