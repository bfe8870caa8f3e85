"""The port's reference-compatible root surface (``compat``) against the
JAX package's, on the CPU.

Every test of ``tests/test_compat.py`` as parity: the same NumPy inputs
(seeded) go through ``threecrate_tpu.<name>`` and
``threecrate_tpu_torch.<name>`` called with the reference's conventions
(scalars positionally, ``init_transform`` as a 4×4 array, uint8
colours), and the results are compared. Arrays reach the port with
``device="cpu"`` (its default is the card); clouds built on the CPU
stay there.

Stated tolerances: poses within 1e-5 (the ICP family, NDT, KISS-ICP:
the same loops, the last bits of their fp32 sums may differ), global
registration within 1e-3 (as ``RegistrationModel`` is held in
``tests/test_torch_global_registration.py``); filtered clouds, normals
(within 1e-4), FPFH rows (within 1e-4 of each row's scale), clusters,
meshes and their face counts (Poisson's within 0.1%), the ``.tcz`` bytes, colours and the
PointCloud2 bytes as stated in each test; errors of the same class.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu as tc  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import compat  # noqa: E402

from conftest import make_sphere_points  # noqa: E402
from test_compat import (FROZEN_CLASSES, FROZEN_FUNCTIONS, REFERENCE_LIB,  # noqa: E402
                         _parse_reference_registration)

torch.set_num_threads(2)   # the suite runs several workers per host

CPU = {"device": "cpu"}


def _tc(pts, **attrs):
    return tt.PointCloud.from_numpy(pts, device="cpu", **attrs)


def _pose(res):
    return np.asarray(res.transformation, np.float64)


def _same_cloud(t, j, atol=0.0):
    """Two clouds hold the same valid points in the same order."""
    a, b = t.to_numpy(), j.to_numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _same_mesh(t, j, atol=0.0):
    tv, tf = t.to_numpy()
    jv, jf = j.to_numpy()
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=atol, rtol=0)


def _close_face_count(t, j):
    """Poisson meshes: face counts within 0.1% of JAX's (χ is held within
    1e-4 of max|χ| in ``tests/test_torch_poisson.py``, so a few cubes
    near the level set may cut differently)."""
    nt, nj = int(t.face_mask.sum()), int(np.asarray(j.face_mask).sum())
    assert nj > 0 and abs(nt - nj) <= 1e-3 * nj, (nt, nj)


@pytest.fixture(scope="module")
def sphere():
    return make_sphere_points(400, seed=3).astype(np.float32)


@pytest.fixture(scope="module")
def misaligned(sphere):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, -0.02, 0.03]
    return (sphere @ T[:3, :3].T + T[:3, 3]).astype(np.float32), T


# ---------------------------------------------------------------------------
# the reference's names
# ---------------------------------------------------------------------------

class TestReferenceNameParity:
    def test_frozen_list_matches_reference(self):
        """The port holds JAX's frozen lists of the reference's registration
        block; where the reference source is on disk they equal what it
        registers, and each name is a class in both packages or a function
        in both."""
        if REFERENCE_LIB.exists():
            classes, functions = _parse_reference_registration()
            assert sorted(classes) == sorted(FROZEN_CLASSES)
            assert sorted(functions) == sorted(FROZEN_FUNCTIONS)
        for name in FROZEN_CLASSES:
            assert isinstance(getattr(tt, name), type) == isinstance(getattr(tc, name), type)
        for name in FROZEN_FUNCTIONS:
            assert callable(getattr(tt, name)) and callable(getattr(tc, name))

    def test_every_class_exists(self):
        missing = [c for c in FROZEN_CLASSES if not hasattr(tt, c)]
        assert not missing, f"missing reference classes: {missing}"

    def test_every_function_exists(self):
        missing = [f for f in FROZEN_FUNCTIONS
                   if not callable(getattr(tt, f, None))]
        assert not missing, f"missing reference functions: {missing}"


@pytest.mark.parametrize("name", compat.__all__[1:] + [
    "as_point_cloud", "transform_point_cloud", "voxel_downsample"])
def test_adapter_signature_matches_jax(name):
    """Each adapter and ``api`` helper takes JAX's parameters in JAX's
    order with JAX's defaults; the port adds only its keyword-only
    ``device`` (the card by default)."""
    t, j = getattr(tt, name), getattr(tc, name)
    assert t.__module__.replace("threecrate_tpu_torch", "threecrate_tpu") == j.__module__
    tp = {k: p for k, p in inspect.signature(t).parameters.items() if k != "device"}
    jp = inspect.signature(j).parameters
    assert list(tp) == list(jp)
    for k in jp:
        assert (tp[k].kind, tp[k].default) == (jp[k].kind, jp[k].default), k
    dev = inspect.signature(t).parameters.get("device")
    if dev is not None:
        assert dev.kind == dev.KEYWORD_ONLY and dev.default == "cuda"


def test_arrays_go_to_the_card_without_a_fallback(sphere):
    """An array reaches the card unless ``device="cpu"`` is passed; with
    no card the adapters raise, as the readers do, and never fall back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py holds the card's side")
    for call in (lambda: tt.estimate_normals(sphere),
                 lambda: tt.icp(sphere, sphere, 5),
                 lambda: tt.voxel_downsample(sphere, 0.25)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    pc = _tc(sphere)
    assert tt.estimate_normals(pc).device.type == "cpu"


# ---------------------------------------------------------------------------
# the 13 shared root names on the reference's inputs
# ---------------------------------------------------------------------------

def test_shared_names_are_the_adapters():
    """As in JAX's ``api.py``, the adapters come after the native names:
    the 13 names both layers define resolve to ``compat``'s."""
    shared = ["icp", "icp_point_to_plane", "gicp", "kiss_icp", "ndt_registration",
              "global_registration", "global_registration_with_normals",
              "estimate_normals", "segment_plane", "extract_fpfh_features",
              "simplify_mesh", "colorize_point_cloud", "poisson_reconstruct"]
    for name in shared:
        assert getattr(tt, name) is getattr(compat, name)
        assert getattr(tc, name).__module__ == "threecrate_tpu.compat"
        assert getattr(tt.api, name) is getattr(compat, name)


def test_estimate_normals_on_an_array():
    """``estimate_normals(p)`` and ``estimate_normals(p, k_neighbors=8)``
    on a (500, 3) array return a PointCloud with normals, as JAX's do
    (the port raised ``AttributeError`` and ``TypeError`` before its
    root took the adapters); normals within 1e-4 of JAX's (the
    eigensolve's last bits; ``tests/test_torch_normals.py`` holds them
    within 1°)."""
    p = np.random.default_rng(5).normal(size=(500, 3)).astype(np.float32)
    for kw in ({}, {"k_neighbors": 8}):
        t, j = tt.estimate_normals(p, **kw, **CPU), tc.estimate_normals(p, **kw)
        assert isinstance(t, tt.PointCloud) and t.normals is not None
        np.testing.assert_allclose(t.attr_to_numpy("normals"), j.attr_to_numpy("normals"),
                                   atol=1e-4, rtol=0)


def test_icp_takes_init_transform():
    """``icp(src, tgt, 30, init_transform=m4)``: the pose within 1e-5 of
    JAX's, iterations and convergence equal, ``transformation`` a
    callable 4×4 ndarray."""
    rng = np.random.default_rng(6)
    tgt = rng.normal(size=(500, 3)).astype(np.float32)
    src = tgt + np.float32([0.04, -0.03, 0.02])
    m4 = np.eye(4, dtype=np.float32)
    m4[:3, 3] = [-0.03, 0.02, -0.01]
    t = tt.icp(src, tgt, 30, init_transform=m4, **CPU)
    j = tc.icp(src, tgt, 30, init_transform=m4)
    assert isinstance(t.transformation, np.ndarray) and t.transformation().shape == (4, 4)
    np.testing.assert_allclose(_pose(t), _pose(j), atol=1e-5, rtol=0)
    assert (int(t.iterations), bool(t.converged)) == (int(j.iterations), bool(j.converged))
    np.testing.assert_allclose(t.as_transform().matrix.numpy(), _pose(j), atol=1e-5)


def test_simplify_mesh_takes_a_ratio(sphere):
    """``simplify_mesh(mesh)`` (ratio 0.5) and ``simplify_mesh(mesh, 0.3)``
    keep JAX's face count and faces; a ratio outside [0, 1] raises
    ``ValueError`` in both."""
    jm = tc.alpha_shape_reconstruct(sphere, 0.5)
    v, f = jm.to_numpy()
    tm = tt.TriangleMesh.from_numpy(v, f, device="cpu")
    for args in ((), (0.3,)):
        _same_mesh(tt.simplify_mesh(tm, *args), tc.simplify_mesh(jm, *args), atol=1e-5)
    for bad in (1.5, -0.1):
        with pytest.raises(ValueError):
            tc.simplify_mesh(jm, bad)
        with pytest.raises(ValueError):
            tt.simplify_mesh(tm, bad)


# ---------------------------------------------------------------------------
# each entry point called as the reference's docstrings show
# ---------------------------------------------------------------------------

class TestReferenceConventions:

    def test_filtering(self, sphere):
        pc, jc = _tc(sphere), tc.PointCloud.from_numpy(sphere)
        kept = tt.remove_statistical_outliers(pc, 20, 2.0)
        assert isinstance(kept, tt.PointCloud)
        _same_cloud(kept, tc.remove_statistical_outliers(jc, 20, 2.0))
        _same_cloud(tt.remove_radius_outliers(pc, 0.5, 2), tc.remove_radius_outliers(jc, 0.5, 2))
        down = tt.voxel_downsample(sphere, 0.25, **CPU)
        assert len(down) < len(pc)
        _same_cloud(down, tc.voxel_downsample(sphere, 0.25), atol=1e-6)

    def test_estimate_normals_k_neighbors_kwarg(self, sphere):
        t = tt.estimate_normals(_tc(sphere), k_neighbors=10)
        j = tc.estimate_normals(tc.PointCloud.from_numpy(sphere), k_neighbors=10)
        np.testing.assert_allclose(t.attr_to_numpy("normals"), j.attr_to_numpy("normals"),
                                   atol=1e-4, rtol=0)

    def test_icp_reference_convention(self, sphere, misaligned):
        src, T = misaligned
        res = tt.icp(src, sphere, 25, init_transform=np.eye(4), **CPU)
        ref = tc.icp(src, sphere, 25, init_transform=np.eye(4))
        M = res.transformation()
        assert isinstance(M, np.ndarray) and M.shape == (4, 4)
        np.testing.assert_allclose(M, _pose(ref), atol=1e-5, rtol=0)
        assert abs(float(res.mse) - float(ref.mse)) <= 1e-6
        assert int(res.iterations) == int(ref.iterations) <= 25
        assert bool(res.converged) == bool(ref.converged)
        assert np.asarray(res.transformation).shape == (4, 4)
        np.testing.assert_allclose(M[:3, 3], -T[:3, 3], atol=5e-3)

    def test_icp_point_to_plane_reference_convention(self, sphere, misaligned):
        src, _ = misaligned
        tgt = tt.estimate_normals(_tc(sphere), 10)
        jtgt = tc.estimate_normals(tc.PointCloud.from_numpy(sphere), 10)
        res = tt.icp_point_to_plane(src, tgt, 20, np.eye(4), **CPU)
        ref = tc.icp_point_to_plane(src, jtgt, 20, np.eye(4))
        assert res.transformation().shape == (4, 4)
        np.testing.assert_allclose(_pose(res), _pose(ref), atol=1e-5, rtol=0)

    def test_gicp_reference_convention(self, sphere, misaligned):
        src, _ = misaligned
        res = tt.gicp(src, sphere, 10, 1.0, 1e-6, 15, **CPU)
        ref = tc.gicp(src, sphere, 10, 1.0, 1e-6, 15)
        assert res.transformation().shape == (4, 4)
        np.testing.assert_allclose(_pose(res), _pose(ref), atol=1e-5, rtol=0)

    def test_gicp_native_convention(self, sphere, misaligned):
        from threecrate_tpu.ops.gicp import GicpConfig
        src, _ = misaligned
        res = tt.gicp(_tc(src), _tc(sphere), tt.GicpConfig(max_iterations=5))
        ref = tc.gicp(tc.PointCloud.from_numpy(src), tc.PointCloud.from_numpy(sphere),
                      GicpConfig(max_iterations=5))
        np.testing.assert_allclose(_pose(res), _pose(ref), atol=1e-5, rtol=0)

    def test_kiss_icp_reference_convention(self, sphere, misaligned):
        src, _ = misaligned
        res = tt.kiss_icp(src, sphere, 0.5, 100.0, 0.0, 10, **CPU)
        ref = tc.kiss_icp(src, sphere, 0.5, 100.0, 0.0, 10)
        assert res.transformation().shape == (4, 4)
        np.testing.assert_allclose(_pose(res), _pose(ref), atol=1e-5, rtol=0)

    def test_ndt_reference_convention(self, sphere, misaligned):
        src, _ = misaligned
        res = tt.ndt_registration(src, sphere, None, 1.0, 0.1, 5, **CPU)
        ref = tc.ndt_registration(src, sphere, None, 1.0, 0.1, 5)
        assert res.transformation().shape == (4, 4)
        np.testing.assert_allclose(_pose(res), _pose(ref), atol=1e-5, rtol=0)
        assert int(res.iterations) == int(ref.iterations)

    def test_global_registration_reference_convention(self, sphere, misaligned):
        src, _ = misaligned
        args = (2000, 0.1, 0.05, 0.5, 10, 10, False)
        res = tt.global_registration(src, sphere, *args, **CPU)
        ref = tc.global_registration(src, sphere, *args)
        assert res.transformation().shape == (4, 4)
        float(res.inlier_ratio)
        np.testing.assert_allclose(_pose(res), _pose(ref), atol=1e-3, rtol=0)

    def test_extract_fpfh_reference_convention(self, sphere):
        feats = tt.extract_fpfh_features(_tc(sphere), 0.5, 10)
        ref = tc.extract_fpfh_features(tc.PointCloud.from_numpy(sphere), 0.5, 10)
        assert isinstance(feats, np.ndarray) and feats.dtype == np.float32
        assert feats.shape == ref.shape == (len(sphere), 33)
        scale = np.abs(ref).sum(1, keepdims=True)
        assert (np.abs(feats - ref) <= 1e-4 * np.maximum(scale, 1.0)).all()
        # the bare call keeps the native result
        assert isinstance(tt.extract_fpfh_features(_tc(sphere)), tt.FpfhResult)

    def test_segment_plane_threshold_kwarg(self, rng):
        plane = np.concatenate(
            [rng.uniform(-1, 1, (300, 2)),
             rng.normal(scale=0.002, size=(300, 1))], 1).astype(np.float32)
        res = tt.segment_plane(plane, threshold=0.02, max_iterations=200, **CPU)
        ref = tc.segment_plane(plane, threshold=0.02, max_iterations=200)
        assert int(res.num_inliers) == int(np.asarray(ref.num_inliers)) > 250
        np.testing.assert_array_equal(res.inlier_mask.numpy(), np.asarray(ref.inlier_mask))

    def test_extract_clusters(self, rng):
        a = rng.normal(scale=0.2, size=(150, 3)).astype(np.float32)
        b = a[:80] + np.float32([10, 0, 0])
        pts = np.concatenate([a, b])
        clusters = tt.extract_clusters(pts, tolerance=1.0, min_cluster_size=10,
                                       max_cluster_size=100000, **CPU)
        ref = tc.extract_clusters(pts, tolerance=1.0, min_cluster_size=10,
                                  max_cluster_size=100000)
        assert [len(c) for c in clusters] == [len(c) for c in ref] == [150, 80]
        for t, j in zip(clusters, ref):
            assert isinstance(t, tt.PointCloud) and t.device.type == "cpu"
            _same_cloud(t, j)

    def test_mesh_pipeline_reference_conventions(self, sphere):
        mesh = tt.alpha_shape_reconstruct(sphere, 0.5, **CPU)
        jmesh = tc.alpha_shape_reconstruct(sphere, 0.5)
        _same_mesh(mesh, jmesh, atol=1e-6)
        n_faces = int(mesh.face_mask.sum())
        assert n_faces > 50
        sm = tt.smooth_mesh_taubin(tt.smooth_mesh_laplacian(mesh, 3, 0.5), 2, 0.5, -0.53)
        sm = tt.smooth_mesh_hc(sm, 2, 0.0, 0.5)
        jsm = tc.smooth_mesh_taubin(tc.smooth_mesh_laplacian(jmesh, 3, 0.5), 2, 0.5, -0.53)
        jsm = tc.smooth_mesh_hc(jsm, 2, 0.0, 0.5)
        _same_mesh(sm, jsm, atol=1e-5)
        simp = tt.simplify_mesh(mesh, 0.5)
        assert int(simp.face_mask.sum()) == int(np.asarray(tc.simplify_mesh(jmesh, 0.5)
                                                            .face_mask).sum())
        assert int(simp.face_mask.sum()) <= int(0.62 * n_faces)
        simp2 = tt.simplify_mesh(mesh, 100)
        _same_mesh(simp2, tc.simplify_mesh(jmesh, 100), atol=1e-5)

    def test_reconstruct_family(self, sphere, rng):
        t, j = tt.reconstruct(sphere, **CPU), tc.reconstruct(sphere)
        _close_face_count(t, j)
        _same_mesh(tt.ball_pivoting_reconstruct(sphere, 0.4, **CPU),
                   tc.ball_pivoting_reconstruct(sphere, 0.4), atol=1e-6)
        plane = np.concatenate(
            [rng.uniform(-1, 1, (150, 2)),
             rng.normal(scale=0.01, size=(150, 1))], 1).astype(np.float32)
        _same_mesh(tt.delaunay_triangulate(plane, **CPU), tc.delaunay_triangulate(plane),
                   atol=1e-6)

    def test_poisson_takes_normal_point_cloud(self, sphere):
        nc = tt.estimate_normals(_tc(sphere), 10)
        jnc = tc.estimate_normals(tc.PointCloud.from_numpy(sphere), 10)
        mesh = tt.poisson_reconstruct(tt.NormalPointCloud(nc))
        ref = tc.poisson_reconstruct(tc.NormalPointCloud(jnc))
        _close_face_count(mesh, ref)
        assert int(mesh.face_mask.sum()) > 100

    def test_compress_decompress(self, sphere):
        pc = _tc(sphere)
        blob = tt.compress(pc, 14, 7)
        assert isinstance(blob, bytes)
        assert blob == tc.compress(tc.PointCloud.from_numpy(sphere), 14, 7)
        back = tt.decompress(blob, **CPU)
        assert back.device.type == "cpu" and len(back) == len(pc)
        _same_cloud(back, tc.decompress(blob))

    def test_colorize_reference_convention(self, sphere, rng):
        img = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 3.0  # camera 3 units back
        args = (img.tobytes(), 32, 24, 20.0, 20.0, 16.0, 12.0, w2c)
        out = tt.colorize_point_cloud(_tc(sphere), *args)
        ref = tc.colorize_point_cloud(tc.PointCloud.from_numpy(sphere), *args)
        assert isinstance(out, tt.ColoredPointCloud)
        cols = out.colors()
        assert cols.dtype == np.uint8 and cols.shape == (len(sphere), 3)
        np.testing.assert_array_equal(cols, ref.colors())
        with pytest.raises(tt.InvalidDataError):
            tt.colorize_point_cloud(_tc(sphere), img.tobytes()[:-1], *args[1:])


class TestTypedClouds:
    def test_normal_point_cloud(self, sphere, rng):
        normals = rng.normal(size=sphere.shape).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        npc = tt.NormalPointCloud.from_numpy(sphere, normals, **CPU)
        ref = tc.NormalPointCloud.from_numpy(sphere, normals)
        assert len(npc) == len(ref) == len(sphere) and not npc.is_empty
        np.testing.assert_array_equal(npc.positions(), ref.positions())
        np.testing.assert_array_equal(npc.normals(), ref.normals())
        _same_cloud(tt.voxel_grid_filter(npc.cloud, 0.5), tc.voxel_grid_filter(ref.cloud, 0.5),
                    atol=1e-6)

    def test_colored_point_cloud_uint8_contract(self, sphere, rng):
        colors = rng.integers(0, 255, sphere.shape).astype(np.uint8)
        got = tt.ColoredPointCloud.from_numpy(sphere, colors, **CPU).colors()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, colors)
        np.testing.assert_array_equal(got, tc.ColoredPointCloud.from_numpy(sphere, colors)
                                      .colors())

    def test_colored_normal_point_cloud(self, sphere, rng):
        normals = np.tile(np.float32([0, 0, 1]), (len(sphere), 1))
        colors = rng.integers(0, 255, sphere.shape).astype(np.uint8)
        c = tt.ColoredNormalPointCloud.from_numpy(sphere, normals, colors, **CPU)
        j = tc.ColoredNormalPointCloud.from_numpy(sphere, normals, colors)
        np.testing.assert_array_equal(c.normals(), j.normals())
        np.testing.assert_array_equal(c.colors(), j.colors())
        assert c.colors().dtype == np.uint8

    def test_missing_attribute_rejected(self, sphere):
        with pytest.raises(tc.InvalidDataError):
            tc.NormalPointCloud(tc.PointCloud.from_numpy(sphere))
        with pytest.raises(tt.InvalidDataError):
            tt.NormalPointCloud(_tc(sphere))


class TestPointCloud2Data:
    def test_reference_surface(self, sphere):
        msg = tt.xyz_to_pointcloud2(_tc(sphere))
        ref = tc.xyz_to_pointcloud2(tc.PointCloud.from_numpy(sphere))
        assert isinstance(msg, tt.PointCloud2Data)
        for attr in ("point_step", "width", "height", "row_step", "is_bigendian", "is_dense"):
            assert getattr(msg, attr) == getattr(ref, attr), attr
        assert msg.data() == ref.data() and msg.fields() == ref.fields()
        assert repr(msg) == repr(ref)

    def test_roundtrip_through_wrapper(self, sphere):
        msg = tt.xyz_to_pointcloud2(_tc(sphere))
        back = tt.from_pointcloud2(msg, **CPU)
        np.testing.assert_array_equal(back.to_numpy(), sphere)
        back2 = tt.pointcloud2_to_xyz(msg.data(), msg.fields(), msg.point_step, msg.width,
                                      msg.height, **CPU)
        np.testing.assert_array_equal(back2.to_numpy(), sphere)

    def test_typed_converters_return_typed_clouds(self, sphere, rng):
        normals = np.tile(np.float32([0, 0, 1]), (len(sphere), 1))
        colors = rng.uniform(0, 1, sphere.shape).astype(np.float32)
        cloud = _tc(sphere, normals=normals, colors=colors)
        jcloud = tc.PointCloud.from_numpy(sphere, normals=normals, colors=colors)
        for to_msg, from_msg, kind in (
                ("normals_to_pointcloud2", "pointcloud2_to_normals", "NormalPointCloud"),
                ("colored_to_pointcloud2", "pointcloud2_to_colored", "ColoredPointCloud"),
                ("colored_normals_to_pointcloud2", "pointcloud2_to_colored_normals",
                 "ColoredNormalPointCloud")):
            m, jm = getattr(tt, to_msg)(cloud), getattr(tc, to_msg)(jcloud)
            assert m.data() == jm.data()
            out = getattr(tt, from_msg)(m.data(), m.fields(), m.point_step, m.width, m.height,
                                        **CPU)
            assert isinstance(out, getattr(tt, kind))
            np.testing.assert_array_equal(out.positions(), sphere)


class TestDracoHonesty:
    def test_real_draco_header_rejected(self):
        fake_drc = b"DRACO" + bytes([1, 3, 0, 1, 0, 0]) + b"\x00" * 64
        for fn in (tt.decompress, tt.decompress_draco, tt.decompress_point_cloud):
            with pytest.raises(tt.UnsupportedFormatError, match="draco_decoder") as got:
                fn(fake_drc)
        with pytest.raises(tc.UnsupportedFormatError) as ref:
            tc.decompress(fake_drc)
        assert str(got.value) == str(ref.value)

    def test_garbage_still_invalid_data(self):
        with pytest.raises(tt.InvalidDataError) as got:
            tt.decompress(b"XXXXnot-a-container")
        with pytest.raises(tc.InvalidDataError) as ref:
            tc.decompress(b"XXXXnot-a-container")
        assert str(got.value) == str(ref.value)
