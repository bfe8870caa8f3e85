#!/usr/bin/env python3
"""The JAX package's results on the CPU for two of ``chip_smoke.py``'s
sharded gates.

Phase 48's gate on the sharded window normals: ``make_sharded_normals_window`` (one
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
(``scipy.spatial.cKDTree``) and the port's ``_pca_normals`` on the CPU
(~10 min and ~10 GB on the CPU at the default size).

Phase 55's gate on the x-slab raycast: JAX's ``make_sharded_tsdf`` on
the 8-device virtual mesh fuses phase 28's 480x640 frame into phase 28's
grid (2,048 blocks a shard, every block updated), raycasts it from the
identity at 480x640 and compares the maps with JAX's single-device
``sparse_raycast`` of the same volume: the mask disagreement, the depth
difference on the pixels both mark confident, the share of the hits
beyond a voxel and the largest difference on all hits; the same numbers
for the port's sharded entry on eight CPU shards against its
single-device call (~5 min on the CPU):

    JAX_PLATFORMS=cpu python3 tools/parallel_references.py slab

Each mode prints one JSON line. No device is measured.
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


def ray_agreement(sharded, single, voxel: float) -> dict:
    """Phase 55's numbers of a sharded raycast's (depth, mask, confident)
    maps against a single-device one's, as numpy arrays."""
    (d, m, c), (d1, m1, c1) = sharded, single
    both = m & m1
    err = np.abs(d - d1)
    return {"mask_disagreement": float((m != m1).mean()),
            "confident_depth_err_m": float(err[both & c & c1].max()),
            "over_voxel_share": float((err[both] > voxel).mean()),
            "all_hits_depth_err_m": float(err[both].max()), "hit_share": float(m.mean())}


def slab() -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from threecrate_tpu.ops import tsdf_raycast as jrc
    from threecrate_tpu.ops import tsdf_sparse as jsp
    from threecrate_tpu.parallel import make_mesh, make_sharded_tsdf

    cs = chip_smoke
    h, w = cs.DEPTH_HW
    depth, eye = cs.wavy_depth(), np.eye(4, dtype=np.float32)
    ray = dict(near=cs.RAY_NEAR, far=cs.RAY_FAR)
    fac = make_sharded_tsdf(make_mesh(cs.SHARDS), cs.TSDF_GRID, cs.TSDF_VOXEL,
                            origin=cs.TSDF_ORIGIN, max_blocks_per_shard=cs.SLAB_BLOCKS,
                            update_fraction=1.0)
    st = fac.integrate(fac.init(), jnp.asarray(depth), jnp.asarray(cs.DEPTH_INTR),
                       jnp.asarray(eye))
    t0 = time.perf_counter()
    jd, _, _, jm, jc = (np.asarray(x) for x in fac.raycast(
        st, jnp.asarray(cs.DEPTH_INTR), jnp.asarray(eye), h, w, **ray))
    jax_s = time.perf_counter() - t0
    vol = jsp.sparse_integrate(
        jsp.create_sparse_volume(cs.TSDF_VOXEL, origin=cs.TSDF_ORIGIN, grid_blocks=cs.TSDF_GRID,
                                 max_blocks=cs.SHARDS * cs.SLAB_BLOCKS),
        jnp.asarray(depth), jnp.asarray(cs.DEPTH_INTR), jnp.asarray(eye),
        grid_blocks=cs.TSDF_GRID, update_fraction=1.0)
    one = jrc.sparse_raycast(vol, jnp.asarray(cs.DEPTH_INTR), jnp.asarray(eye), h, w,
                             grid_blocks=cs.TSDF_GRID, **ray)

    import torch

    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.ops import tsdf_raycast as trc
    from threecrate_tpu_torch.ops import tsdf_sparse as tsp

    cpu = torch.device("cpu")
    tfac = tp.make_sharded_tsdf(tp.make_mesh(cs.SHARDS, devices=[cpu] * cs.SHARDS),
                                cs.TSDF_GRID, cs.TSDF_VOXEL, origin=cs.TSDF_ORIGIN,
                                max_blocks_per_shard=cs.SLAB_BLOCKS, update_fraction=1.0)
    tst = tfac.integrate(tfac.init(), depth, cs.DEPTH_INTR, eye)
    td, _, _, tm, tc = (x.numpy() for x in tfac.raycast(tst, cs.DEPTH_INTR, eye, h, w, **ray))
    tvol = tsp.sparse_integrate(
        tsp.create_sparse_volume(cs.TSDF_VOXEL, origin=cs.TSDF_ORIGIN, grid_blocks=cs.TSDF_GRID,
                                 max_blocks=cs.SHARDS * cs.SLAB_BLOCKS, device=cpu),
        depth, cs.DEPTH_INTR, eye, grid_blocks=cs.TSDF_GRID, update_fraction=1.0)
    tone = trc.sparse_raycast(tvol, cs.DEPTH_INTR, eye, h, w, grid_blocks=cs.TSDF_GRID, **ray)
    return {"jax_sharded_vs_single": ray_agreement(
                (jd, jm, jc), (np.asarray(one.depth), np.asarray(one.mask),
                               np.asarray(one.confident)), cs.TSDF_VOXEL),
            "port_cpu_sharded_vs_single": ray_agreement(
                (td, tm, tc), (tone.depth.numpy(), tone.mask.numpy(), tone.confident.numpy()),
                cs.TSDF_VOXEL),
            "port_vs_jax_sharded_mask_disagreement": float((tm != jm).mean()),
            "jax_cpu_s": jax_s}


if __name__ == "__main__":
    if sys.argv[1:] == ["slab"]:
        print(json.dumps(slab()))
    else:
        print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_SHARDED)))
