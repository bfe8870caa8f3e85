#!/usr/bin/env python3
"""The JAX package's results on the CPU for ``chip_smoke.py``'s phases 24-26
(Patchwork++, NDT and the odometry frames) and 30-31 (frame-to-model
tracking and ``FrameToModelOdometry``), the references those phases gate
the port against, each beside the port's own CPU run of the same input.

    JAX_PLATFORMS=cpu python3 tools/family_references.py [ground] [ndt] [odometry] [f2m]

- ground: recall and precision against ``chip_smoke.ground_scan``'s
  labels, and the share of points where the two masks agree;
- ndt: the transform ``ndt_registration`` reaches on phase 25's 250,000-point
  pair (2 m cells, 20 iterations, ε = 0);
- odometry: the pose errors (m, rad) of phase 26's 5 frames against the
  truth, with the default ``KissIcpConfig``;
- f2m: the pose ``track`` reaches on phase 30's maps (each package
  fusing and raycasting bench.py's frame on its own), and the pose
  errors (m, rad) of ``FrameToModelOdometry()`` over phase 31's wall
  frames.

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


def f2m():
    import jax.numpy as jnp
    from threecrate_tpu.core.organized import CameraIntrinsics as JaxIntrinsics
    from threecrate_tpu.ops import frame_to_model as jf
    from threecrate_tpu.ops import tsdf_raycast as jrc
    from threecrate_tpu.ops import tsdf_sparse as jsp
    import threecrate_tpu_torch as tt

    h, w = chip_smoke.DEPTH_HW
    intr, eye = jnp.asarray(chip_smoke.DEPTH_INTR), jnp.eye(4, dtype=jnp.float32)
    grid = chip_smoke.TSDF_GRID
    vol = jsp.sparse_integrate(
        jsp.create_sparse_volume(chip_smoke.TSDF_VOXEL, origin=chip_smoke.TSDF_ORIGIN,
                                 grid_blocks=grid, block=8,
                                 max_blocks=chip_smoke.TSDF_MAX_BLOCKS),
        jnp.asarray(chip_smoke.wavy_depth()), intr, eye, grid_blocks=grid, block=8)
    ray = dict(grid_blocks=grid, block=8, near=chip_smoke.RAY_NEAR, far=chip_smoke.RAY_FAR)
    model = jrc.sparse_raycast(vol, intr, eye, h, w, **ray)
    frame = jrc.sparse_raycast(vol, intr, jnp.asarray(chip_smoke.shifted_pose(
        chip_smoke.TRACK_SHIFT)), h, w, **ray)
    jt = np.asarray(jf.track(model, eye, frame.depth, intr, eye, max_iterations=10).cam_to_world)
    _, tmodel, tdepth = chip_smoke.track_scene(tt, "cpu")
    pt = tt.track_frame_to_model(tmodel, np.eye(4, dtype=np.float32), tdepth,
                                 chip_smoke.DEPTH_INTR, np.eye(4, dtype=np.float32),
                                 max_iterations=10).cam_to_world.numpy()
    out = {"section": "f2m", "jax_track_translation": jt[:3, 3].tolist(),
           "port_cpu_track_translation": pt[:3, 3].tolist(),
           "port_cpu_vs_jax": float(np.abs(pt - jt).max())}
    # phase 29's check: the raycast depth against the input on confident
    # pixels, sparse (the model above) and dense (phase 27's volume)
    dense = jt_integrate(chip_smoke)
    dmodel = jrc.raycast(dense, intr, eye, h, w, near=chip_smoke.RAY_NEAR, far=chip_smoke.RAY_FAR)
    for name, res in (("sparse", model), ("dense", dmodel)):
        err = np.abs(np.asarray(res.depth) - chip_smoke.wavy_depth())[np.asarray(res.confident)]
        out[f"jax_{name}_raycast_confident_depth_err"] = {
            "max_m": float(err.max()), "over_half_voxel": int((err > chip_smoke.TSDF_VOXEL / 2).sum()),
            "confident": int(err.size)}
    frames = list(chip_smoke.wall_frames())
    cam = chip_smoke.DEPTH_INTR.tolist()
    for name, odo, put in (("jax", jf.FrameToModelOdometry(JaxIntrinsics(*cam), h, w),
                            jnp.asarray),
                           ("port_cpu", tt.FrameToModelOdometry(tt.CameraIntrinsics(*cam), h, w,
                                                                device="cpu"), lambda x: x)):
        t0 = time.perf_counter()
        errs = [chip_smoke.pose_errors(np.asarray(odo.register_frame(put(d)).matrix), truth)
                for d, truth in frames]
        out[name + "_pose_errors"] = errs
        out[name + "_worst"] = [max(e[0] for e in errs), max(e[1] for e in errs)]
        out[name + "_s"] = time.perf_counter() - t0
    return out


def jt_integrate(cs):
    """Phase 27's dense volume, fused by the JAX package."""
    import jax.numpy as jnp
    from threecrate_tpu.ops import tsdf as jax_tsdf

    vol = jax_tsdf.create_volume((cs.TSDF_RES,) * 3, cs.TSDF_VOXEL, origin=cs.TSDF_ORIGIN)
    return jax_tsdf.integrate(vol, jnp.asarray(cs.wavy_depth()), jnp.asarray(cs.DEPTH_INTR),
                              jnp.eye(4, dtype=jnp.float32))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sections = {"ground": ground, "ndt": ndt, "odometry": odometry, "f2m": f2m}
    for name in sys.argv[1:] or list(sections):
        print(json.dumps(sections[name]()), flush=True)


if __name__ == "__main__":
    main()
