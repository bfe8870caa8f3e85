#!/usr/bin/env python3
"""The JAX package's results on the CPU for ``chip_smoke.py``'s phases 24-26
(Patchwork++, NDT and the odometry frames), the references those phases
gate the port against, each beside the port's own CPU run of the same
input.

    JAX_PLATFORMS=cpu python3 tools/family_references.py [ground] [ndt] [odometry]

- ground: recall and precision against ``chip_smoke.ground_scan``'s
  labels, and the share of points where the two masks agree;
- ndt: the transform ``ndt_registration`` reaches on phase 25's 250,000-point
  pair (2 m cells, 20 iterations, ε = 0);
- odometry: the pose errors (m, rad) of phase 26's 5 frames against the
  truth, with the default ``KissIcpConfig``.

Each section prints one JSON line. No device is measured (minutes on
the CPU for the odometry frames).
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


def ground():
    from threecrate_tpu import PointCloud as JaxCloud
    from threecrate_tpu.ops import ground as jax_ground
    import threecrate_tpu_torch as tt

    pts, labels = chip_smoke.ground_scan()
    n = len(pts)
    t0 = time.perf_counter()
    jmask = np.asarray(jax_ground.patchwork_plus_plus(JaxCloud.from_numpy(pts)).ground_mask)[:n]
    t1 = time.perf_counter()
    tmask = tt.patchwork_plus_plus(tt.PointCloud.from_numpy(pts, device="cpu")) \
        .ground_mask[:n].numpy()
    return {"section": "ground", "points": n,
            "jax_recall_precision": chip_smoke.recall_precision(jmask, labels),
            "port_cpu_recall_precision": chip_smoke.recall_precision(tmask, labels),
            "mask_agreement": float((jmask == tmask).mean()), "jax_cpu_s": t1 - t0}


def ndt():
    from threecrate_tpu import PointCloud as JaxCloud
    from threecrate_tpu.ops import ndt as jax_ndt
    import threecrate_tpu_torch as tt

    pts = chip_smoke.scan(chip_smoke.NDT_POINTS, 7)
    cfg = dict(chip_smoke.NDT_CONFIG)
    j = jax_ndt.ndt_registration(JaxCloud.from_numpy(pts),
                                 JaxCloud.from_numpy(pts + chip_smoke.SHIFT),
                                 jax_ndt.NdtConfig(**cfg))
    t = tt.ndt_registration(tt.PointCloud.from_numpy(pts, device="cpu"),
                            tt.PointCloud.from_numpy(pts + chip_smoke.SHIFT, device="cpu"),
                            tt.NdtConfig(**cfg))
    jm = np.asarray(j.transformation)
    return {"section": "ndt", "points": len(pts), "jax_translation": jm[:3, 3].tolist(),
            "jax_iterations": int(j.iterations),
            "port_cpu_translation": t.transformation.numpy()[:3, 3].tolist(),
            "port_cpu_vs_jax": float(np.abs(t.transformation.numpy() - jm).max()),
            "applied": chip_smoke.SHIFT.tolist()}


def odometry():
    from threecrate_tpu import PointCloud as JaxCloud
    from threecrate_tpu.models import OdometryModel as JaxOdometry
    import threecrate_tpu_torch as tt

    out = {"section": "odometry", "frames": chip_smoke.ODOMETRY_FRAMES}
    for name, model, cloud in (("jax", JaxOdometry(), JaxCloud.from_numpy),
                               ("port_cpu", tt.OdometryModel(),
                                lambda p: tt.PointCloud.from_numpy(p, device="cpu"))):
        t0 = time.perf_counter()
        errs = [chip_smoke.pose_errors(np.asarray(model.step(cloud(frame)).matrix), truth)
                for frame, truth in chip_smoke.odometry_frames()]
        out[name + "_pose_errors"] = errs
        out[name + "_s"] = time.perf_counter() - t0
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sections = {"ground": ground, "ndt": ndt, "odometry": odometry}
    for name in sys.argv[1:] or list(sections):
        print(json.dumps(sections[name]()), flush=True)


if __name__ == "__main__":
    main()
