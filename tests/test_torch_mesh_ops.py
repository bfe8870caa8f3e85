"""Mesh smoothing, mesh booleans and the typed clouds: the PyTorch port
(``threecrate_tpu_torch.ops.mesh_smoothing`` / ``.mesh_boolean``,
``core.typed_clouds``) against the JAX package on the same inputs, on
the CPU.

Stated tolerances:
- smoothing: the edge list and the smoothed vertices bit-equal (the
  one-ring scatter adds in index order, as XLA's does on the CPU, and
  the updates are fused where XLA:CPU fuses them) at each config's
  default iterations and at 25;
- booleans: a host copy, so the welded vertices and faces bit-equal;
- typed clouds: host views, the arrays they return equal.
Inputs, from numpy seeds: a noisy UV sphere (closed, 1,024 faces), a
noisy 20 x 20 grid (open) and unit cubes and UV spheres for the
booleans.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu import PointCloud as JCloud  # noqa: E402
from threecrate_tpu import TriangleMesh as JMesh  # noqa: E402
from threecrate_tpu.core import typed_clouds as jtc  # noqa: E402
from threecrate_tpu.core.errors import InvalidDataError as JInvalid  # noqa: E402
from threecrate_tpu.ops import mesh_boolean as jmb  # noqa: E402
from threecrate_tpu.ops import mesh_smoothing as jms  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import PointCloud as TCloud  # noqa: E402
from threecrate_tpu_torch import TriangleMesh as TMesh  # noqa: E402
from threecrate_tpu_torch.core import typed_clouds as ttc  # noqa: E402
from threecrate_tpu_torch.core.errors import InvalidDataError as TInvalid  # noqa: E402
from threecrate_tpu_torch.ops import mesh_boolean as tmb  # noqa: E402
from threecrate_tpu_torch.ops import mesh_smoothing as tms  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _uv_sphere(n_sub=16, noise=0.02, seed=0, center=(0, 0, 0), radius=1.0):
    rng = np.random.default_rng(seed)
    thetas = np.linspace(0.25, np.pi - 0.25, n_sub)
    phis = np.linspace(0, 2 * np.pi, n_sub * 2, endpoint=False)
    m = len(phis)
    v = np.stack([np.outer(np.sin(thetas), np.cos(phis)).ravel(),
                  np.outer(np.sin(thetas), np.sin(phis)).ravel(),
                  np.repeat(np.cos(thetas), m)], -1)
    f = []
    for i in range(n_sub - 1):
        for j in range(m):
            a, b = i * m + j, i * m + (j + 1) % m
            c, d = (i + 1) * m + j, (i + 1) * m + (j + 1) % m
            f += [[a, b, c], [b, d, c]]
    top, bot, last = len(v), len(v) + 1, (n_sub - 1) * m
    f += [[top, (j + 1) % m, j] for j in range(m)]
    f += [[bot, last + j, last + (j + 1) % m] for j in range(m)]
    v = np.concatenate([v, [[0, 0, 1], [0, 0, -1]]])
    v = (v + noise * rng.normal(size=v.shape)) * radius + np.asarray(center)
    return v.astype(np.float32), np.asarray(f, np.int32)


def _grid(n=20, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    z = noise * rng.normal(size=xs.shape)
    v = np.stack([xs.ravel(), ys.ravel(), z.ravel()], -1).astype(np.float32)
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b = i * n + j, i * n + j + 1
            c, d = (i + 1) * n + j, (i + 1) * n + j + 1
            f += [[a, b, c], [b, d, c]]
    return v, np.asarray(f, np.int32)


def _cube(center=(0, 0, 0), size=1.0):
    h = size / 2
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)],
                 np.float32) + np.asarray(center, np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                 np.int32)
    return v, f


MESHES = {"sphere": _uv_sphere(), "grid": _grid()}


def _meshes(arrays):
    return JMesh.from_numpy(*arrays), TMesh.from_numpy(*arrays, device="cpu")


def _same(jmesh, tmesh):
    jv, jf = jmesh.to_numpy()
    tv, tf = tmesh.to_numpy()
    assert tmesh.device.type == "cpu"
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("name", ["sphere", "grid"])
def test_edge_list_matches_jax(name):
    jm, tm = _meshes(MESHES[name])
    js, jd, jv = (np.asarray(x) for x in jms._edge_list(jm.faces, jm.face_mask,
                                                        jm.vertex_capacity))
    ts, td, tv = (x.numpy() for x in tms._edge_list(tm.faces, tm.face_mask))
    np.testing.assert_array_equal(ts[tv], js[jv])
    np.testing.assert_array_equal(td[tv], jd[jv])
    if name == "sphere":   # closed: every undirected edge twice, 3F directed edges
        assert int(tv.sum()) == 3 * len(MESHES[name][1])


SMOOTHERS = {"laplacian": ("smooth_laplacian", "LaplacianConfig"),
             "taubin": ("smooth_taubin", "TaubinConfig"),
             "hc": ("smooth_hc", "HcConfig")}


@pytest.mark.parametrize("name", ["sphere", "grid"])
@pytest.mark.parametrize("method", list(SMOOTHERS))
@pytest.mark.parametrize("iterations", [None, 25])
def test_smoothing_matches_jax(name, method, iterations):
    fn, cfg = SMOOTHERS[method]
    kw = {} if iterations is None else {"iterations": iterations}
    jm, tm = _meshes(MESHES[name])
    jout = getattr(jms, fn)(jm, getattr(jms, cfg)(**kw))
    tout = getattr(tms, fn)(tm, getattr(tms, cfg)(**kw))
    _same(jout, tout)
    assert torch.equal(tout.faces, tm.faces)
    v0 = MESHES[name][0]
    assert np.abs(tout.to_numpy()[0] - v0).max() > 1e-3   # it moved


def test_smoothing_entries_at_the_root():
    _, tm = _meshes(MESHES["grid"])
    _same(jms.smooth_taubin(JMesh.from_numpy(*MESHES["grid"])), tt.smooth_taubin(tm))
    assert tt.LaplacianConfig() == tms.LaplacianConfig(iterations=10, factor=0.5)
    assert tt.HcConfig() == tms.HcConfig(iterations=10, alpha=0.1, beta=0.6)
    assert tt.TaubinConfig() == tms.TaubinConfig(iterations=10, lambda_factor=0.5,
                                                 mu_factor=-0.53)


BOOLEAN_INPUTS = {
    "cubes_overlap": (_cube(), _cube((0.5, 0, 0))),
    "cubes_apart": (_cube(), _cube((5, 0, 0))),
    "cubes_tilted": (_cube(), _cube((0.3, 0.2, 0.1), 0.8)),
    "spheres": (_uv_sphere(6, 0.0), _uv_sphere(6, 0.0, center=(0.6, 0.1, 0.05))),
}


@pytest.mark.parametrize("inputs", list(BOOLEAN_INPUTS))
@pytest.mark.parametrize("op", ["UNION", "INTERSECTION", "DIFFERENCE"])
def test_mesh_boolean_matches_jax(inputs, op):
    a, b = BOOLEAN_INPUTS[inputs]
    ja, ta = _meshes(a)
    jb, tb = _meshes(b)
    jout = jmb.mesh_boolean(ja, jb, jmb.BooleanOp[op])
    tout = tmb.mesh_boolean(ta, tb, tmb.BooleanOp[op])
    _same(jout, tout)


def test_mesh_boolean_entries_and_errors_match_jax():
    (ja, ta), (jb, tb) = _meshes(_cube()), _meshes(_cube((0.5, 0, 0)))
    for name in ("mesh_union", "mesh_intersection", "mesh_difference"):
        _same(getattr(jmb, name)(ja, jb), getattr(tt, name)(ta, tb))
    with pytest.raises(JInvalid) as je:
        jmb.mesh_union(ja, JMesh.empty())
    with pytest.raises(TInvalid) as te:
        tmb.mesh_union(ta, TMesh.empty(device="cpu"))
    assert str(te.value) == str(je.value)
    # wholly inside: the intersection keeps the inner cube, the difference
    # of the inner from the outer keeps both shells
    (ji, ti) = _meshes(_cube(size=0.5))
    _same(jmb.mesh_intersection(ja, ji), tmb.mesh_intersection(ta, ti))
    _same(jmb.mesh_difference(ja, ji), tmb.mesh_difference(ta, ti))


@pytest.fixture(scope="module")
def cloud_arrays():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    return pts, nrm, cols


def test_typed_clouds_match_jax(cloud_arrays):
    pts, nrm, cols = cloud_arrays
    pairs = [
        (jtc.NormalPointCloud.from_numpy(pts, nrm),
         ttc.NormalPointCloud.from_numpy(pts, nrm, device="cpu")),
        (jtc.ColoredPointCloud.from_numpy(pts, cols),
         ttc.ColoredPointCloud.from_numpy(pts, cols, device="cpu")),
        (jtc.ColoredNormalPointCloud.from_numpy(pts, nrm, cols),
         ttc.ColoredNormalPointCloud.from_numpy(pts, nrm, cols, device="cpu")),
        (jtc.ColoredPointCloud.from_numpy(pts, cols / 255.0),
         ttc.ColoredPointCloud.from_numpy(pts, cols / 255.0, device="cpu")),
    ]
    for j, t in pairs:
        assert type(t).__name__ == type(j).__name__
        assert t.device.type == "cpu" and len(t) == len(j) == 50
        assert repr(t) == repr(j) and t.is_empty == j.is_empty is False
        np.testing.assert_array_equal(t.positions(), j.positions())
        for accessor in ("normals", "colors"):
            if hasattr(j, accessor) and callable(getattr(type(j), accessor, None)):
                np.testing.assert_array_equal(getattr(t, accessor)(), getattr(j, accessor)())
        assert isinstance(t.cloud, TCloud) and t.to_point_cloud() is t.cloud
        assert ttc.unwrap(t) is t.cloud
        # delegation to the wrapped cloud
        np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
        assert t.capacity == t.cloud.capacity


def test_wrap_typed_and_errors_match_jax(cloud_arrays):
    pts, nrm, cols = cloud_arrays
    cf = (cols / 255.0).astype(np.float32)
    for attrs in ({}, {"normals": nrm}, {"colors": cf}, {"normals": nrm, "colors": cf}):
        j = jtc.wrap_typed(JCloud.from_numpy(pts, **attrs))
        t = ttc.wrap_typed(TCloud.from_numpy(pts, device="cpu", **attrs))
        assert type(t).__name__ == type(j).__name__
    plain = TCloud.from_numpy(pts, device="cpu")
    assert ttc.unwrap(plain) is plain
    bad = [
        (lambda m: m.NormalPointCloud.from_numpy(pts, nrm[:10]), {}),
        (lambda m: m.ColoredPointCloud.from_numpy(pts, cols[:, :2]), {}),
        (lambda m: m.ColoredNormalPointCloud.from_numpy(pts, nrm, cols[:5]), {}),
        (lambda m: m.NormalPointCloud.from_numpy(pts[:, :2], nrm[:, :2]), {}),
    ]
    for make, _ in bad:
        with pytest.raises(JInvalid) as je:
            make(jtc)
        with pytest.raises(TInvalid) as te:
            make(ttc)
        assert str(te.value) == str(je.value)
    with pytest.raises(TInvalid) as te:
        ttc.NormalPointCloud(plain)
    with pytest.raises(JInvalid) as je:
        jtc.NormalPointCloud(JCloud.from_numpy(pts))
    assert str(te.value) == str(je.value)
    with pytest.raises(TInvalid, match="wraps a PointCloud"):
        ttc.ColoredPointCloud(pts)
    assert {"NormalPointCloud", "ColoredPointCloud", "ColoredNormalPointCloud"} <= set(tt.__all__)
