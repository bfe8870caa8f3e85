#!/usr/bin/env python3
"""References for ``chip_smoke.py``'s mesh-processing phases (36-39).

    JAX_PLATFORMS=cpu python3 tools/mesh_references.py picks poisson
    python3 tools/mesh_references.py port

- picks (the JAX package, CPU): ``ReconstructionModel``'s stages up to
  the pick (statistical outlier removal at k = 10, ``compact``, normals at
  k = 10, ``analyze_data``, ``select_algorithm``) on phase 36's input
  (``chip_smoke.bumpy_sphere`` at ``MESH_N`` points, sigma ``MESH_SIGMA``)
  and on phase 36b's two (``BASELINE5_SIGMA`` at ``BASELINE5_SIZES``):
  the analysis and the algorithm;
- poisson (the JAX package, CPU): BASELINE config #5's pipeline as
  ``benchmarks/r3_probe.py`` runs it (normals at k = 10,
  ``poisson_reconstruct(PoissonConfig(depth=6))``, ``simplify_mesh`` to
  half the faces) at each of ``BASELINE5_SIZES``: face counts and the
  simplified mesh's radius error against the bumpy sphere (median, 99th
  percentile, largest);
- port (the port, CPU): phase 36's ``ReconstructionModel`` (the pick,
  fallbacks, points kept, faces before and after simplification to half,
  and the share of the simplified mesh's vertices within
  ``NEAR_SPACINGS`` mean spacings of the input, with quantiles of that
  distance) and phase 39's alpha shape (``ALPHA_N`` points), ball pivoting
  (``BPA_N``) and Delaunay (``DELAUNAY_N``) through
  ``auto_reconstruct_detailed`` (faces). It needs
  tens of GB: ``_signed_field``'s exact 1-NN of 110,592 nodes against
  ~85k points runs as a float64 chain on the CPU;
- sheets (both packages, CPU): the auto-reconstructed MLS mesh of a
  1,200-point bumpy sphere at sigma 0.05 (where both pick MLS): the share
  of its vertices within ``NEAR_SPACINGS`` mean spacings of the input and
  quantiles of that distance, in each package. MLS normals are unoriented,
  so the signed field flips sign between sheets and the mesh holds
  surfaces away from the points, in the JAX package as in the port.

Each section prints one JSON line. No device is measured.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]

import chip_smoke  # noqa: E402


def _characteristics(ch) -> dict:
    return {k: (float(v) if isinstance(v, (float, np.floating)) else v)
            for k, v in ch._asdict().items()}


def picks():
    from threecrate_tpu import PointCloud
    from threecrate_tpu.ops import filtering, normals
    from threecrate_tpu.reconstruction import pipeline

    out = {"section": "picks"}
    inputs = {"phase36": (chip_smoke.MESH_N, chip_smoke.MESH_SIGMA)}
    inputs.update({f"phase36b_{n}": (n, chip_smoke.BASELINE5_SIGMA)
                   for n in chip_smoke.BASELINE5_SIZES})
    for name, (n, sigma) in inputs.items():
        t0 = time.perf_counter()
        cloud = PointCloud.from_numpy(chip_smoke.bumpy_sphere(n, sigma))
        clean = filtering.statistical_outlier_removal(cloud, k=10).cloud.compact()
        withn = normals.estimate_normals(clean, k=10)
        ch = pipeline.analyze_data(withn)
        algo = pipeline.select_algorithm(ch, pipeline.PipelineConfig())
        out[name] = {"points": n, "sigma": sigma, "algorithm": algo.value,
                     "characteristics": _characteristics(ch),
                     "cpu_s": time.perf_counter() - t0}
    return out


def _radius_stats(v: np.ndarray) -> dict:
    err = chip_smoke.bumpy_radius_error(v)
    return {"median": float(np.median(err)), "p99": float(np.percentile(err, 99)),
            "max": float(err.max())}


def poisson():
    from threecrate_tpu import PointCloud
    from threecrate_tpu.ops.normals import estimate_normals
    from threecrate_tpu.reconstruction.poisson import PoissonConfig, poisson_reconstruct
    from threecrate_tpu.simplification import simplify_mesh

    out = {"section": "poisson"}
    for n in chip_smoke.BASELINE5_SIZES:
        t0 = time.perf_counter()
        pc = estimate_normals(PointCloud.from_numpy(
            chip_smoke.bumpy_sphere(n, chip_smoke.BASELINE5_SIGMA)), 10)
        mesh = poisson_reconstruct(pc, PoissonConfig(depth=6))
        faces = int(mesh.face_count())
        target = max(faces // 2, 100)
        simp = simplify_mesh(mesh, target)
        out[str(n)] = {"faces": faces, "target": target,
                       "simplified_faces": int(simp.face_count()),
                       "radius_error": _radius_stats(simp.to_numpy()[0]),
                       "unsimplified_radius_error": _radius_stats(mesh.to_numpy()[0]),
                       "cpu_s": time.perf_counter() - t0}
    return out


def port():
    import torch

    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.reconstruction import pipeline

    torch.set_num_threads(os.cpu_count() or 1)
    cpu = torch.device("cpu")
    out = {"section": "port", "threads": torch.get_num_threads()}

    t0 = time.perf_counter()
    cloud = tt.PointCloud.from_numpy(chip_smoke.bumpy_sphere(chip_smoke.MESH_N,
                                                             chip_smoke.MESH_SIGMA), device=cpu)
    clean = tt.statistical_outlier_removal(cloud, k=10).cloud.compact()
    withn = tt.estimate_normals(clean, k=10)
    res = pipeline.auto_reconstruct_detailed(withn)
    faces = int(res.mesh.face_count())
    target = max(faces // 2, 100)
    simp = tt.simplify_mesh(res.mesh, target)
    near = tt.knn(cloud.points, cloud.mask, simp.vertices[simp.vertex_mask], None,
                  1).distances[:, 0].numpy() / res.characteristics.mean_spacing
    out["phase36"] = {"algorithm": res.algorithm.value,
                      "fallbacks": [a.value for a in res.fallbacks_used],
                      "points": int(clean.size()), "faces": faces, "target": target,
                      "simplified_faces": int(simp.face_count()),
                      "near_share": float((near <= chip_smoke.NEAR_SPACINGS).mean()),
                      "near_quantiles": np.quantile(near, [0.5, 0.9, 0.99, 1]).tolist(),
                      "characteristics": _characteristics(res.characteristics),
                      "cpu_s": time.perf_counter() - t0}

    inputs = {"alpha_shape": chip_smoke.fibonacci_sphere(chip_smoke.ALPHA_N),
              "ball_pivoting": chip_smoke.fibonacci_sphere(chip_smoke.BPA_N),
              "delaunay": chip_smoke.terrain(chip_smoke.DELAUNAY_N)}
    for name, pts in inputs.items():
        t0 = time.perf_counter()
        c = tt.estimate_normals(tt.PointCloud.from_numpy(pts, device=cpu), k=10)
        r = pipeline.auto_reconstruct_detailed(
            c, pipeline.PipelineConfig(preferred=pipeline.Algorithm(name)))
        out[name] = {"points": len(pts), "algorithm": r.algorithm.value,
                     "fallbacks": [a.value for a in r.fallbacks_used],
                     "faces": int(r.mesh.face_count()), "cpu_s": time.perf_counter() - t0}
    return out


def _near(knn, points, mask, vertices, spacing):
    d = np.asarray(knn(points, mask, vertices, None, 1).distances)[:, 0] / spacing
    return {"near_share": float((d <= chip_smoke.NEAR_SPACINGS).mean()),
            "near_quantiles": np.quantile(d, [0.5, 0.9, 0.99, 1]).tolist()}


def sheets():
    import torch

    import threecrate_tpu as jt
    import threecrate_tpu_torch as tt
    from threecrate_tpu.ops import neighbors as jn
    from threecrate_tpu.reconstruction import pipeline as jp
    from threecrate_tpu_torch.reconstruction import pipeline as tp

    pts = chip_smoke.bumpy_sphere(1200, 0.05)
    out = {"section": "sheets", "points": len(pts)}
    for name, pc, pipe, knn in (
            ("jax", jt.PointCloud.from_numpy(pts), jp, jn.knn),
            ("port", tt.PointCloud.from_numpy(pts, device=torch.device("cpu")), tp, tt.knn)):
        r = pipe.auto_reconstruct_detailed(pc)
        verts = r.mesh.vertices[r.mesh.vertex_mask] if name == "port" else \
            r.mesh.vertices[np.asarray(r.mesh.vertex_mask)]
        out[name] = {"algorithm": r.algorithm.value, "faces": int(r.mesh.face_count()),
                     **_near(knn, pc.points, pc.mask, verts, r.characteristics.mean_spacing)}
    return out


def main() -> int:
    sections = {"picks": picks, "poisson": poisson, "port": port, "sheets": sheets}
    names = sys.argv[1:] or list(sections)
    for name in names:
        print(json.dumps(sections[name]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
