"""Alpha shapes, ball pivoting, Delaunay, the auto-reconstruction
pipeline and ``ReconstructionModel``: the PyTorch port against the JAX
package on the same clouds, on the CPU.

Inputs, from numpy seeds: Fibonacci spheres (``conftest``), the bumpy
sphere of BASELINE config #5 (``benchmarks/r3_probe.py``'s generator:
radius 1 + 0.05·sin 3u plus normal noise σ), a wavy terrain height field
and a flat plane. Host loops (BPA, Delaunay) run at ≤ 800 points, as the
JAX package's own tests do (both BPA fronts are Python loops). Stated tolerances:
- alpha shapes: ``_circumspheres`` bit-equal on random triangles, α
  within 1e-6 relative (the kNN sums differ in the last bits), face sets
  equal, with the estimated α and with a fixed one;
- ball pivoting: candidate ids equal and distances within 2e-6; with
  explicit radii the meshes bit-equal (the float64 host loop is a copy);
  the adaptive radii within 1e-5 relative and faces within 1%;
  ``fill_boundary_holes`` bit-equal;
- Delaunay (host only): bit-equal for every projection;
- ``analyze_data``: categorical fields equal, floats within 1e-5
  relative (``noise_level`` near zero within 1e-7 absolute);
  ``select_algorithm`` equal;
- the pipeline and ``ReconstructionModel``: each input's algorithm is
  asserted for JAX first; the port picks the same, with the same
  fallbacks, faces within 1%;
- a device failure inside ``_execute`` leaves the port's chain at once.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import make_sphere_points  # noqa: E402

import threecrate_tpu as jt  # noqa: E402
from threecrate_tpu import simplification as jsimp  # noqa: E402
from threecrate_tpu.core.errors import AlgorithmError as JAlgorithmError  # noqa: E402
from threecrate_tpu.core.errors import InvalidDataError as JInvalid  # noqa: E402
from threecrate_tpu.ops import filtering as jfilt  # noqa: E402
from threecrate_tpu.ops import neighbors as jn  # noqa: E402
from threecrate_tpu.ops import normals as jnorm  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch.core.errors import AlgorithmError as TAlgorithmError  # noqa: E402
from threecrate_tpu_torch.core.errors import DeviceError  # noqa: E402
from threecrate_tpu_torch.core.errors import InvalidDataError as TInvalid  # noqa: E402

JA = importlib.import_module("threecrate_tpu.reconstruction.alpha_shape")
TA = importlib.import_module("threecrate_tpu_torch.reconstruction.alpha_shape")
JB = importlib.import_module("threecrate_tpu.reconstruction.ball_pivoting")
TB = importlib.import_module("threecrate_tpu_torch.reconstruction.ball_pivoting")
JD = importlib.import_module("threecrate_tpu.reconstruction.delaunay")
TD = importlib.import_module("threecrate_tpu_torch.reconstruction.delaunay")
JP = importlib.import_module("threecrate_tpu.reconstruction.pipeline")
TP = importlib.import_module("threecrate_tpu_torch.reconstruction.pipeline")

torch.set_num_threads(2)   # the suite runs several workers per host


def bumpy_sphere(n, sigma, seed):
    """BASELINE config #5's cloud (benchmarks/r3_probe.py:243-249)."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(0, 2 * np.pi, n), np.arccos(rng.uniform(-1, 1, n))
    sphere = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)], -1)
    return (sphere * (1 + 0.05 * np.sin(3 * u)[:, None])
            + rng.normal(0, sigma, (n, 3))).astype(np.float32)


def terrain(n, seed=5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2))
    z = 0.05 * np.sin(xy[:, 0] * 6) * np.cos(xy[:, 1] * 5)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def noisy_sphere(n, sigma, seed):
    rng = np.random.default_rng(seed)
    return (make_sphere_points(n) + sigma * rng.normal(size=(n, 3))).astype(np.float32)


def clouds(pts, **attrs):
    return (jt.PointCloud.from_numpy(pts, **attrs),
            tt.PointCloud.from_numpy(pts, device="cpu", **attrs))


def face_set(mesh):
    f = np.sort(mesh.to_numpy()[1], axis=1)
    return set(map(tuple, f.tolist()))


def same_mesh(jmesh, tmesh):
    jv, jf = jmesh.to_numpy()
    tv, tf = tmesh.to_numpy()
    assert tmesh.device.type == "cpu"
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


# ---------------------------------------------------------------- alpha shapes

def test_circumspheres_match_jax():
    tri = np.random.default_rng(0).normal(size=(20000, 3, 3)).astype(np.float32)
    tri[:50, 1] = tri[:50, 2] = tri[:50, 0]   # degenerate: one point
    jc, jr = JA._circumspheres(jnp.asarray(tri))
    tc, tr = TA._circumspheres(torch.from_numpy(tri))
    np.testing.assert_array_equal(tc.numpy()[50:], np.asarray(jc)[50:])
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert np.isinf(tr.numpy()[:50]).all()


ALPHA_INPUTS = {"sphere": make_sphere_points(500), "noisy": noisy_sphere(500, 0.01, 0)}


@pytest.mark.parametrize("name,alpha", [("sphere", None), ("noisy", None), ("noisy", 0.4)])
def test_alpha_shape_matches_jax(name, alpha):
    jc, tc = clouds(ALPHA_INPUTS[name])
    ja = JA.estimate_optimal_alpha(jc, 12, 2.0)
    ta = TA.estimate_optimal_alpha(tc, 12, 2.0)
    assert abs(ta - ja) <= 1e-6 * ja
    mode = "ADAPTIVE" if alpha is None else "FIXED"
    jm = JA.alpha_shape_reconstruction(jc, JA.AlphaShapeConfig(alpha, JA.AlphaMode[mode]))
    tm = TA.alpha_shape_reconstruction(tc, TA.AlphaShapeConfig(alpha, TA.AlphaMode[mode]))
    assert tm.device.type == "cpu" and int(tm.face_count()) > 500
    np.testing.assert_array_equal(tm.to_numpy()[0], jm.to_numpy()[0])
    assert face_set(tm) == face_set(jm)


def test_alpha_shape_errors_match_jax():
    cases = ((np.zeros((3, 3), np.float32), {}),
             (make_sphere_points(50), {"mode": "FIXED"}))
    for pts, kw in cases:
        jc, tc = clouds(pts)
        with pytest.raises(JInvalid) as je:
            JA.alpha_shape_reconstruction(jc, JA.AlphaShapeConfig(
                **{k: JA.AlphaMode[v] for k, v in kw.items()}))
        with pytest.raises(TInvalid) as te:
            TA.alpha_shape_reconstruction(tc, TA.AlphaShapeConfig(
                **{k: TA.AlphaMode[v] for k, v in kw.items()}))
        assert str(te.value) == str(je.value)
    # no face under a tiny alpha: an empty mesh on the cloud's device
    jc, tc = clouds(make_sphere_points(100))
    empty = TA.alpha_shape_reconstruction(tc, TA.AlphaShapeConfig(1e-4, TA.AlphaMode.FIXED))
    assert int(empty.face_count()) == 0 and empty.device.type == "cpu"
    assert int(JA.alpha_shape_reconstruction(
        jc, JA.AlphaShapeConfig(1e-4, JA.AlphaMode.FIXED)).face_count()) == 0


# ---------------------------------------------------------------- ball pivoting

@pytest.fixture(scope="module")
def bpa_clouds():
    return clouds(noisy_sphere(300, 0.005, 7))


def test_bpa_candidates_and_radii_match_jax(bpa_clouds):
    jc, tc = bpa_clouds
    n = 300
    res = jn.knn(jc.points, jc.mask, jc.points, jc.mask, 16, exclude_self=True)
    ids, ok, d = TB._candidates(tc, 16)
    np.testing.assert_array_equal(ids[:n], np.asarray(res.indices)[:n])
    np.testing.assert_array_equal(ok[:n], np.asarray(res.mask)[:n])
    # the expanded d² differs from XLA's by up to 4.8e-7, ~1.2e-6 in d at 0.2
    assert np.abs(d[:n] - np.asarray(res.distances)[:n])[ok[:n]].max() <= 2e-6
    jr = JB.estimate_radii(jc, JB.BallPivotingConfig())
    tr = TB.estimate_radii(tc, TB.BallPivotingConfig())
    np.testing.assert_allclose(tr, jr, rtol=1e-5)   # percentiles of those distances


@pytest.mark.parametrize("radii", [(0.18, 0.3), None])
def test_bpa_matches_jax(bpa_clouds, radii):
    jc, tc = bpa_clouds
    jm = JB.ball_pivoting_reconstruction(jc, JB.BallPivotingConfig(radii=radii))
    tm = TB.ball_pivoting_reconstruction(tc, TB.BallPivotingConfig(radii=radii))
    fj, ft = int(jm.face_count()), int(tm.face_count())
    assert fj > 250
    if radii is not None:
        same_mesh(jm, tm)
    else:
        assert abs(fj - ft) <= 0.01 * fj, (fj, ft)


def test_fill_boundary_holes_matches_jax():
    v = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                   np.float32)
    f = np.asarray([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5],
                    [3, 1, 5]], np.int32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    disk_v = np.concatenate([[[0, 0, 0]], np.stack([np.cos(ang), np.sin(ang), 0 * ang], -1)]
                            ).astype(np.float32)
    disk_f = np.asarray([[0, 1 + i, 1 + (i + 1) % 8] for i in range(8)], np.int32)
    for (vv, ff), cap in (((v, f), 12), ((disk_v, disk_f), 6), ((disk_v, disk_f), 8)):
        jm = JB.fill_boundary_holes(jt.TriangleMesh.from_numpy(vv, ff), cap)
        tm = TB.fill_boundary_holes(tt.TriangleMesh.from_numpy(vv, ff, device="cpu"), cap)
        same_mesh(jm, tm)
    assert int(tm.face_count()) == 14   # the 8-edge rim closed by 6 ears at cap 8


def test_bpa_errors_match_jax():
    jc, tc = clouds(np.zeros((2, 3), np.float32))
    with pytest.raises(JInvalid) as je:
        JB.ball_pivoting_reconstruction(jc)
    with pytest.raises(TInvalid) as te:
        TB.ball_pivoting_reconstruction(tc)
    assert str(te.value) == str(je.value)
    assert TB.BallPivotingConfig() == TB.BallPivotingConfig(None, 16, (50.0, 90.0), 1.3, 0.05,
                                                            500_000, True, 12)


# ---------------------------------------------------------------- Delaunay

@pytest.mark.parametrize("projection", ["AUTO", "PCA", "XY", "XZ", "YZ"])
def test_delaunay_matches_jax(projection):
    pts = terrain(300)
    if projection in ("XZ", "YZ"):
        pts = pts[:, [0, 2, 1]] if projection == "XZ" else pts[:, [2, 0, 1]]
    jc, tc = clouds(pts)
    for edge in (None, 0.1):
        jm = JD.delaunay_reconstruction(jc, JD.DelaunayConfig(JD.ProjectionPlane[projection],
                                                              edge))
        tm = TD.delaunay_reconstruction(tc, TD.DelaunayConfig(TD.ProjectionPlane[projection],
                                                              edge))
        same_mesh(jm, tm)
        assert int(tm.face_count()) > (400 if edge is None else 100)


def test_delaunay_errors_match_jax():
    for pts in (np.zeros((2, 3), np.float32), make_sphere_points(200)):
        jc, tc = clouds(pts)
        with pytest.raises((JInvalid, JAlgorithmError)) as je:
            JD.delaunay_reconstruction(jc)
        with pytest.raises((TInvalid, TAlgorithmError)) as te:
            TD.delaunay_reconstruction(tc)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)
    rng = np.random.default_rng(1)
    p2 = rng.uniform(size=(200, 2))
    np.testing.assert_array_equal(TD.delaunay_2d(p2), JD.delaunay_2d(p2))


# ---------------------------------------------------------------- pipeline

# noise_level is a median surface variation λ0/Σλ: on near-flat
# neighbourhoods its fp32 eigenvalue rounding is ~ε·λ2/Σλ ≈ 6e-8 absolute
# (measured 2.4e-8 on the sphere, 4.4e-10 against JAX's exact 0 on the plane)
NOISE_ABS_TOL = 1e-7

ANALYSIS_INPUTS = {
    "sphere_normals": (make_sphere_points(1500), True),
    "plane": (np.concatenate([np.random.default_rng(0).uniform(0, 1, (500, 2)),
                              np.zeros((500, 1))], 1).astype(np.float32), False),
    "bumpy": (bumpy_sphere(1500, 0.01, 11), False),
}


@pytest.mark.parametrize("name", list(ANALYSIS_INPUTS))
def test_analyze_data_and_selection_match_jax(name):
    pts, with_normals = ANALYSIS_INPUTS[name]
    attrs = {"normals": pts / np.linalg.norm(pts, axis=1, keepdims=True)} if with_normals else {}
    jc, tc = clouds(pts, **attrs)
    jch, tch = JP.analyze_data(jc), TP.analyze_data(tc)
    assert (tch.n_points, tch.distribution, tch.is_closed) == (jch.n_points, jch.distribution,
                                                               jch.is_closed)
    for key in ("density_uniformity", "noise_level", "mean_spacing"):
        got, ref = getattr(tch, key), getattr(jch, key)
        assert abs(got - ref) <= max(1e-5 * abs(ref), NOISE_ABS_TOL), (key, got, ref)
    for kw in ({}, {"use_case": "TERRAIN"}, {"preferred": "ALPHA_SHAPE"}):
        jcfg = JP.PipelineConfig(**{k: (JP.UseCase[v] if k == "use_case" else JP.Algorithm[v])
                                    for k, v in kw.items()})
        tcfg = TP.PipelineConfig(**{k: (TP.UseCase[v] if k == "use_case" else TP.Algorithm[v])
                                    for k, v in kw.items()})
        assert TP.select_algorithm(tch, tcfg).value == JP.select_algorithm(jch, jcfg).value


def test_pipeline_fallbacks_match_jax():
    """Delaunay's auto projection refuses a sphere, so the chain falls back
    (AlgorithmError, JAX's semantics); with no fallback left it raises
    JAX's message."""
    pts = make_sphere_points(300)
    jc, tc = clouds(pts)
    jr = JP.auto_reconstruct_detailed(jc, JP.PipelineConfig(
        preferred=JP.Algorithm.DELAUNAY, fallback_chain=(JP.Algorithm.ALPHA_SHAPE,)))
    tr = TP.auto_reconstruct_detailed(tc, TP.PipelineConfig(
        preferred=TP.Algorithm.DELAUNAY, fallback_chain=(TP.Algorithm.ALPHA_SHAPE,)))
    assert (tr.algorithm.value, [a.value for a in tr.fallbacks_used]) == (
        jr.algorithm.value, [a.value for a in jr.fallbacks_used]) == ("alpha_shape",
                                                                       ["delaunay"])
    assert face_set(tr.mesh) == face_set(jr.mesh)
    assert tr.quality == jr.quality
    with pytest.raises(JAlgorithmError) as je:
        JP.auto_reconstruct(jc, JP.PipelineConfig(preferred=JP.Algorithm.DELAUNAY,
                                                  fallback_chain=()))
    with pytest.raises(TAlgorithmError) as te:
        TP.auto_reconstruct(tc, TP.PipelineConfig(preferred=TP.Algorithm.DELAUNAY,
                                                  fallback_chain=()))
    assert str(te.value) == str(je.value)
    assert "all reconstruction algorithms failed" in str(te.value)


@pytest.mark.parametrize("error", [
    DeviceError("nvcc not found"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_device_failure_leaves_the_chain_at_once(monkeypatch, error):
    calls = []

    def failing(cloud, algo, ch):
        calls.append(algo)
        raise error

    monkeypatch.setattr(TP, "_execute", failing)
    _, tc = clouds(make_sphere_points(300))
    with pytest.raises(type(error)) as got:
        TP.auto_reconstruct_detailed(tc, TP.PipelineConfig(preferred=TP.Algorithm.POISSON))
    assert got.value is error
    assert calls == [TP.Algorithm.POISSON]


def test_algorithm_failure_still_falls_back(monkeypatch):
    """Any other exception moves the chain on, as in JAX."""
    real, calls = TP._execute, []

    def flaky(cloud, algo, ch):
        calls.append(algo)
        if algo == TP.Algorithm.DELAUNAY:
            raise RuntimeError("host failure")
        return real(cloud, algo, ch)

    monkeypatch.setattr(TP, "_execute", flaky)
    _, tc = clouds(make_sphere_points(300))
    res = TP.auto_reconstruct_detailed(tc, TP.PipelineConfig(
        preferred=TP.Algorithm.DELAUNAY, fallback_chain=(TP.Algorithm.ALPHA_SHAPE,)))
    assert calls == [TP.Algorithm.DELAUNAY, TP.Algorithm.ALPHA_SHAPE]
    assert res.fallbacks_used == [TP.Algorithm.DELAUNAY]


# ---------------------------------------------------------------- ReconstructionModel

MODEL_INPUTS = {
    # σ about half the point spacing: the median curvature (0.072) is well
    # above the 0.05 switch, so the analysis takes MLS
    "mls": (bumpy_sphere(1200, 0.05, 11), "mls"),
    # a height field: planar (smallest PCA ratio ~1e-3 < 0.01)
    "delaunay": (terrain(800), "delaunay"),
    # a closed scan whose normals face the default viewpoint: |mean sign|
    # 0.31 < 0.5 so not "closed", noise 0.0025, uniformity 0.71 > 0.6
    "ball_pivoting": (bumpy_sphere(500, 0.003, 1), "ball_pivoting"),
}


@pytest.mark.parametrize("name", list(MODEL_INPUTS))
def test_reconstruction_model_matches_jax(name, monkeypatch):
    """The JAX model's steps (SOR, compact, normals, auto reconstruction,
    simplification to half the faces) against ``tt.ReconstructionModel``,
    whose auto-reconstruction result is caught on its way through."""
    pts, expected = MODEL_INPUTS[name]
    jc, tc = clouds(pts)
    clean = jfilt.statistical_outlier_removal(jc, k=10).cloud.compact()
    withn = jnorm.estimate_normals(clean, k=10)
    jres = JP.auto_reconstruct_detailed(withn)
    assert jres.algorithm.value == expected and jres.fallbacks_used == []
    target = max(int(jres.mesh.face_count()) // 2, 100)
    jfaces = int(jsimp.simplify_mesh(jres.mesh, target).face_count())

    seen = []
    detailed = TP.auto_reconstruct_detailed

    def spy(cloud, config=TP.PipelineConfig()):
        seen.append(detailed(cloud, config))
        return seen[-1]

    monkeypatch.setattr(TP, "auto_reconstruct_detailed", spy)
    mesh = tt.ReconstructionModel(k=10, target_faces=target)(tc)
    (tres,) = seen
    assert tres.algorithm.value == expected and tres.fallbacks_used == []
    assert tres.characteristics.n_points == jres.characteristics.n_points
    fj, ft = int(jres.mesh.face_count()), int(tres.mesh.face_count())
    assert abs(ft - fj) <= 0.01 * fj, (fj, ft)
    ft = int(mesh.face_count())
    assert mesh.device.type == "cpu" and ft <= target + 8
    assert abs(ft - jfaces) <= 0.01 * jfaces, (jfaces, ft)
