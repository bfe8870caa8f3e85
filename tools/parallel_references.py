#!/usr/bin/env python3
"""The JAX package's result on the CPU for ``chip_smoke.py``'s phase 48
gate on the sharded window normals: ``make_sharded_normals_window`` (one
Morton pass, kernel 4 in interpret mode on each shard of JAX's 8-device
virtual CPU mesh) on phase 48's shuffled 8,388,608-point scan, and its
angle to exact k = 10 normals on phase 48's 16,384-point sample, over all
sampled points and over the planar ones (curvature below
``chip_smoke.PLANAR_CURVATURE``); beside it the same numbers for the
port's sharded entry on eight CPU shards (kernel 4's plain version) and
for its single-device one-pass window normals (``method="window_fast"``,
``window_passes=1``), the same kernel without shard seams. JAX's sort
loses rows where Morton keys tie (``ROADMAP.md`` §3), so its routed-back
normals land on other rows.

    JAX_PLATFORMS=cpu python3 tools/parallel_references.py [n_points]

The exact normals come from the 10 nearest points by direct differences
(``scipy.spatial.cKDTree``) and the port's ``_pca_normals`` on the CPU.
Prints one JSON line. No device is measured (~10 min and ~10 GB on the
CPU at the default size).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]

import chip_smoke  # noqa: E402


def exact_sample(pts: np.ndarray, k: int = chip_smoke.K_NORMALS):
    """(sample rows, exact normals, curvature) of phase 48's strided
    16,384-point sample."""
    import torch
    from scipy.spatial import cKDTree

    from threecrate_tpu_torch.ops.normals import _pca_normals

    n = len(pts)
    sub = np.arange(0, n, n // 16384)[:16384]
    _, idx = cKDTree(pts).query(pts[sub], k=k)
    p = torch.from_numpy(pts)
    nrm, curv = _pca_normals(p[torch.from_numpy(idx)], torch.ones(idx.shape, dtype=torch.bool),
                             p[torch.from_numpy(sub)], torch.zeros(3), True)
    return sub, nrm.numpy(), curv.numpy()


def main(n: int) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from threecrate_tpu.parallel import make_mesh, make_sharded_normals_window, put_sharded

    pts = chip_smoke.scan(n, 0)[np.random.default_rng(chip_smoke.SHARD_SEED).permutation(n)]
    mesh = make_mesh(chip_smoke.SHARDS)
    fn = make_sharded_normals_window(mesh, k=chip_smoke.K_NORMALS, tile=256, band=16)
    t0 = time.perf_counter()
    nrm, valid = (np.asarray(x) for x in fn(put_sharded(jnp.asarray(pts), mesh),
                                            put_sharded(jnp.ones(n, bool), mesh)))
    jax_s = time.perf_counter() - t0
    sub, exact, curv = exact_sample(pts)

    def angles(normals, ok):
        both = ok[sub]
        planar = both & (curv < chip_smoke.PLANAR_CURVATURE)
        ang = np.degrees(np.arccos(np.clip(np.abs((exact * normals[sub]).sum(1)), 0.0, 1.0)))
        return {"valid_share": float(ok.mean()), "mean_angle_deg": float(ang[both].mean()),
                "planar_mean_angle_deg": float(ang[planar].mean()), "planar": int(planar.sum())}

    import torch

    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch import parallel as tp

    cpu = torch.device("cpu")
    tmesh = tp.make_mesh(chip_smoke.SHARDS, devices=[cpu] * chip_smoke.SHARDS)
    tn, tv = (x.numpy() for x in tp.make_sharded_normals_window(
        tmesh, k=chip_smoke.K_NORMALS, tile=256, band=16)(pts, np.ones(n, bool)))
    one = tt.estimate_normals_detailed(
        tt.PointCloud.from_numpy(pts, device=cpu),
        tt.NormalEstimationConfig(k_neighbors=chip_smoke.K_NORMALS, method="window_fast",
                                  window_passes=1, viewpoint=(0.0, 0.0, 0.0)))
    return {"points": n, "jax_sharded": angles(nrm, valid), "jax_cpu_s": jax_s,
            "port_cpu_sharded": angles(tn, tv),
            "port_cpu_one_pass": angles(one.normals.numpy(), one.valid.numpy())}


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_SHARDED)))
