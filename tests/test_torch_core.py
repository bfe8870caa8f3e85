"""PyTorch port vs the JAX package: data model, Morton keys, small
linear algebra, exact kNN, interop, and the port's import boundary.

Inputs come from numpy seeds and go to both packages as numpy arrays.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.core import errors as jerr  # noqa: E402
from threecrate_tpu.core import transform as jtf  # noqa: E402
from threecrate_tpu.ops import linalg as jla  # noqa: E402
from threecrate_tpu.ops import morton as jmo  # noqa: E402
from threecrate_tpu.ops import neighbors as jnb  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.core import errors as terr  # noqa: E402
from threecrate_tpu_torch.core import transform as ttf  # noqa: E402
from threecrate_tpu_torch.ops import linalg as tla  # noqa: E402
from threecrate_tpu_torch.ops import morton as tmo  # noqa: E402
from threecrate_tpu_torch.ops import neighbors as tnb  # noqa: E402
from threecrate_tpu_torch.utils import padding, profiling  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

ERRORS = ["ThreeCrateError", "IoError", "InvalidDataError", "AlgorithmError",
          "DeviceError", "VisualizationError", "UnsupportedError",
          "UnsupportedFormatError"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _scan(n, seed, scale=1.0):
    from bench import _kitti_like
    return (_kitti_like(n, seed) * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize("name", ERRORS)
def test_error_hierarchy_matches(name):
    j, t = getattr(jerr, name), getattr(terr, name)
    assert [c.__name__ for c in t.__mro__] == [c.__name__ for c in j.__mro__]
    assert getattr(tt, name) is t


def test_round_up():
    assert padding.LANE == 128
    for n in (1, 127, 128, 129, 1_000_000):
        assert padding.round_up(n) == -(-n // 128) * 128
    assert padding.round_up(1000, 256) == 1024


def test_point_cloud_roundtrip_and_bbox(rng):
    pts = rng.normal(0, 3, (300, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (300, 3)).astype(np.float32)
    jc = tc.PointCloud.from_numpy(pts)
    c = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask), device="cpu")
    assert c.capacity == jc.capacity and len(c) == 300
    for a, b in zip(c.bounding_box(), jc.bounding_box()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c = c.with_normals(_t(nrm))
    assert c.normals.shape == (c.capacity, 3)
    pts_np, mask_np, attrs = interop.cloud_to_numpy(c)
    np.testing.assert_array_equal(pts_np, np.asarray(jc.points))
    np.testing.assert_array_equal(attrs["normals"][:300], nrm)
    own = tt.PointCloud.from_numpy(pts, device="cpu", normals=nrm)
    assert own.capacity == 384 and int(own.mask.sum()) == 300
    sub = tt.PointCloud(own.points, own.mask & (own.points[:, 0] > 0), own.attrs)
    packed = sub.compact()
    np.testing.assert_array_equal(packed.to_numpy(), pts[pts[:, 0] > 0])
    np.testing.assert_array_equal(packed.normals[:len(packed)].numpy(),
                                  nrm[pts[:, 0] > 0])
    with pytest.raises(terr.InvalidDataError):
        tt.PointCloud.from_numpy(pts[:, :2], device="cpu")
    with pytest.raises(terr.InvalidDataError):
        c.with_normals(torch.zeros(c.capacity + 1, 3))


def test_from_numpy_places_clouds_on_the_card():
    """The default device is the card; without CUDA, torch's own error
    comes through (no CPU fallback)."""
    pts = np.zeros((10, 3), np.float32)
    if torch.cuda.is_available():
        assert tt.PointCloud.from_numpy(pts).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tt.PointCloud.from_numpy(pts)
    assert tt.PointCloud.from_numpy(pts, device="cpu").device.type == "cpu"


def test_transform_matches_jax(rng):
    xi = rng.normal(0, 0.3, 6).astype(np.float32)
    pts = rng.normal(0, 10, (500, 3)).astype(np.float32)
    jt = jtf.Transform.from_exp_coords(jnp.asarray(xi))
    t = ttf.Transform.from_exp_coords(_t(xi))
    np.testing.assert_allclose(t.matrix.numpy(), np.asarray(jt.matrix), atol=1e-6)
    np.testing.assert_allclose(t.apply(_t(pts)).numpy(),
                               np.asarray(jt.apply(jnp.asarray(pts))), atol=1e-5)
    np.testing.assert_allclose((t @ t.inverse()).matrix.numpy(), np.eye(4),
                               atol=1e-6)
    np.testing.assert_allclose(ttf.skew(_t(xi[:3])).numpy(),
                               np.asarray(jtf.skew(jnp.asarray(xi[:3]))))
    # the small-angle Taylor branch
    tiny = np.array([1e-7, -2e-7, 0, 1, 2, 3], np.float32)
    np.testing.assert_allclose(ttf.se3_exp(_t(tiny)).numpy(),
                               np.asarray(jtf.se3_exp(jnp.asarray(tiny))),
                               atol=1e-7)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_morton_keys_bit_equal(scale):
    """Keys equal bit for bit in every pass, with an invalid tail, and in
    a fixed frame that other points fall outside of (clamped cells)."""
    pts = _scan(5000, 1, scale)
    mask = np.ones(5000, bool)
    mask[-300:] = False
    for p in range(4):
        ref = np.asarray(jmo.morton_keys(jnp.asarray(pts), jnp.asarray(mask), p))
        got = tmo.morton_keys(_t(pts), _t(mask), p).numpy()
        np.testing.assert_array_equal(got, ref)
    mn_j, sc_j = jmo.frame(jnp.asarray(pts), jnp.asarray(mask))
    mn_t, sc_t = tmo.frame(_t(pts), _t(mask))
    np.testing.assert_array_equal(mn_t.numpy(), np.asarray(mn_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    # points far outside the frame: the lattice coordinate overflows int32
    far = np.concatenate([pts[:100] * 3, pts[:100] + 1e12 * scale,
                          pts[:100] - 1e12 * scale]).astype(np.float32)
    ones = np.ones(len(far), bool)
    ref = np.asarray(jmo.keys_in_frame(jnp.asarray(far), jnp.asarray(ones),
                                       mn_j, sc_j))
    got = tmo.keys_in_frame(_t(far), _t(ones), mn_t, sc_t).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).all()


def test_morton_invalid_points_get_int32_max():
    pts = np.zeros((4, 3), np.float32)
    mask = np.array([True, False, True, False])
    keys = tmo.morton_keys(_t(pts), _t(mask)).numpy()
    assert keys.dtype == np.int32
    assert (keys[~mask] == 2 ** 31 - 1).all()


def _sym(rng, n, scale):
    a = rng.normal(0, 1, (n, 3, 3)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    cov[: n // 4, 2, :] = 0          # planar neighbourhoods (rank 2)
    cov[: n // 4, :, 2] = 0
    cov[n // 4: n // 3] = np.eye(3, dtype=np.float32)   # isotropic
    return (cov * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-10, 1e-6, 1e-3, 1.0, 1e3, 1e6])
def test_eigensolver_parity_across_scales(rng, scale):
    cov = _sym(rng, 400, scale)
    jv = np.asarray(jla.eigvals_sym3x3(jnp.asarray(cov)))
    tv = tla.eigvals_sym3x3(_t(cov)).numpy()
    # fp32 closed form: each eigenvalue within 1e-5 of its matrix's largest
    top = np.abs(jv).max(-1, keepdims=True)
    assert (np.abs(tv - jv) <= 1e-5 * top).all()
    jn, _ = jla.smallest_eigenvector_sym3x3(jnp.asarray(cov))
    tn, _ = tla.smallest_eigenvector_sym3x3(_t(cov))
    cos = np.abs((np.asarray(jn) * tn.numpy()).sum(-1))
    assert (cos > 1 - 1e-4).all()
    # eigenpairs hold: A v = λ v for the port's own decomposition
    vals, vecs = tla.eigh3x3(_t(cov))
    av = torch.einsum("nij,njk->nik", _t(cov), vecs)
    np.testing.assert_allclose(av.numpy(), (vecs * vals[:, None, :]).numpy(),
                               atol=2e-4 * scale * 10)


def test_kabsch_and_transform_points_match_jax(rng):
    src = rng.normal(0, 5, (2000, 3)).astype(np.float32)
    xi = np.array([0.1, -0.2, 0.05, 0.3, -0.1, 0.2], np.float32)
    m = np.asarray(jtf.se3_exp(jnp.asarray(xi)))
    tgt = (src @ m[:3, :3].T + m[:3, 3] + rng.normal(0, 0.01, src.shape)
           ).astype(np.float32)
    w = (rng.uniform(0, 1, 2000) > 0.2).astype(np.float32)
    ref = np.asarray(jla.kabsch(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w)))
    got = tla.kabsch(_t(src), _t(tgt), _t(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    ref_p = np.asarray(jla.transform_points(jnp.asarray(m), jnp.asarray(src)))
    got_p = tla.transform_points(_t(m), _t(src)).numpy()
    np.testing.assert_allclose(got_p, ref_p, rtol=1e-6, atol=1e-6)
    # reflection fix: a mirrored target still yields a proper rotation
    mir = src * np.array([1, 1, -1], np.float32)
    r = tla.kabsch(_t(src), _t(mir), torch.ones(2000))[:3, :3]
    assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5


@pytest.mark.parametrize("k", [1, 10])
def test_knn_matches_jax(rng, k):
    db = rng.normal(0, 1, (1500, 3)).astype(np.float32)
    q = rng.normal(0, 1, (700, 3)).astype(np.float32)
    dm = rng.uniform(0, 1, 1500) > 0.1
    qm = rng.uniform(0, 1, 700) > 0.1
    ref = jnb.knn(jnp.asarray(db), jnp.asarray(dm), jnp.asarray(q),
                  jnp.asarray(qm), k)
    got = tnb.knn(_t(db), _t(dm), _t(q), _t(qm), k, query_chunk=256)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    m = got.mask.numpy()
    np.testing.assert_allclose(got.distances.numpy()[m],
                               np.asarray(ref.distances)[m], atol=1e-5)
    assert np.isinf(got.distances.numpy()[~m]).all()
    np.testing.assert_array_equal(got.indices.numpy()[m],
                                  np.asarray(ref.indices)[m])
    one = tnb.nearest_one(_t(db), _t(dm), _t(q), max_distance=0.05)
    assert (one.distances.numpy()[one.mask.numpy()] <= 0.05).all()


def test_interop_transform_roundtrip(rng):
    m = np.asarray(jtf.se3_exp(jnp.asarray(rng.normal(0, 0.2, 6), jnp.float32)))
    t = interop.transform_from_numpy(m, device="cpu")
    np.testing.assert_array_equal(interop.transform_to_numpy(t), m)


def test_import_leaves_jax_out():
    code = ("import sys, threecrate_tpu_torch as t; "
            "t.PerceptionStep(device='cpu'); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('threecrate_tpu.') or m == "
            "'threecrate_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_identity_and_cloud_transform_match_jax(rng):
    """``Transform.identity`` and ``PointCloud.transform``: points within
    1e-6 of JAX's, normals rotated with them, mask and other attributes
    kept."""
    np.testing.assert_array_equal(ttf.Transform.identity().matrix.numpy(),
                                  np.asarray(jtf.Transform.identity().matrix))
    m = np.asarray(jtf.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
    pts = rng.normal(0, 5, (300, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (300, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, 300).astype(np.float32)
    jc = tc.PointCloud.from_numpy(pts, normals=nrm, intensity=inten)
    jc = jc.with_mask(jc.mask & (jnp.arange(jc.capacity) % 3 != 0))
    pc = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask),
                                  {k: np.asarray(v) for k, v in jc.attrs.items()}, device="cpu")
    jout = jc.transform(jtf.Transform(jnp.asarray(m)))
    tout = pc.transform(interop.transform_from_numpy(m, device="cpu"))
    np.testing.assert_allclose(tout.points.numpy(), np.asarray(jout.points), atol=1e-5)
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    assert set(tout.attrs) == set(jout.attrs)
    for k in tout.attrs:
        np.testing.assert_allclose(tout.attrs[k].numpy(), np.asarray(jout.attrs[k]), atol=1e-6)


def test_no_module_of_the_port_imports_jax():
    """Every module under threecrate_tpu_torch/, imported one by one in a
    fresh interpreter, leaves jax and the JAX package out of
    sys.modules; no source line there or in chip_smoke.py imports them."""
    root = Path(__file__).resolve().parent.parent
    code = ("import pkgutil, sys, importlib, threecrate_tpu_torch as t\n"
            "for m in pkgutil.walk_packages(t.__path__, 'threecrate_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'threecrate_tpu' or m.startswith('threecrate_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|threecrate_tpu)(\s|\.|$)", re.M)
    for path in [*sorted((root / "threecrate_tpu_torch").rglob("*.py")), root / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_median_time_needs_the_card():
    if torch.cuda.is_available():
        assert profiling.median_time(lambda: torch.ones(8, device="cuda"),
                                     warmup=1, iters=3) > 0
    else:
        with pytest.raises(RuntimeError):
            profiling.median_time(lambda: None)


def test_transform_constructors_and_quaternions_match_jax(rng):
    """``from_scaling``, ``from_quaternion``, ``from_euler_xyz``,
    ``apply_point``, ``apply_vector`` and the quaternion maps: within 1e-6
    of JAX's (the 3x3 products and sin/cos may round the last bit
    differently), points within 1e-5 at 5 m."""
    for _ in range(20):
        ang = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
        t = rng.normal(0, 2, 3).astype(np.float32)
        jm = np.asarray(jtf.Transform.from_euler_xyz(jnp.asarray(ang), jnp.asarray(t)).matrix)
        tm = ttf.Transform.from_euler_xyz(_t(ang), _t(t))
        np.testing.assert_allclose(tm.matrix.numpy(), jm, rtol=0, atol=1e-6)
        q = rng.normal(0, 1, 4).astype(np.float32)
        jq = jtf.Transform.from_quaternion(jnp.asarray(q), jnp.asarray(t))
        tq = ttf.Transform.from_quaternion(_t(q), _t(t))
        np.testing.assert_allclose(tq.matrix.numpy(), np.asarray(jq.matrix), atol=1e-6)
        r = np.asarray(jq.matrix)[:3, :3]
        np.testing.assert_allclose(ttf.matrix_to_quaternion(_t(r)).numpy(),
                                   np.asarray(jtf.matrix_to_quaternion(jnp.asarray(r))),
                                   atol=1e-6)
        np.testing.assert_allclose(ttf.quaternion_to_matrix(_t(q)).numpy(),
                                   np.asarray(jtf.quaternion_to_matrix(jnp.asarray(q))),
                                   atol=1e-6)
        p = rng.normal(0, 5, 3).astype(np.float32)
        np.testing.assert_allclose(tm.apply_point(_t(p)).numpy(),
                                   np.asarray(jtf.Transform(jnp.asarray(jm)).apply_point(p)),
                                   atol=1e-5)
        vs = rng.normal(0, 1, (7, 3)).astype(np.float32)
        np.testing.assert_allclose(tm.apply_vector(_t(vs)).numpy(),
                                   np.asarray(jtf.Transform(jnp.asarray(jm)).apply_vector(vs)),
                                   atol=1e-6)
    for s in (2.5, [1.0, 2.0, 0.5]):
        np.testing.assert_array_equal(ttf.Transform.from_scaling(s).matrix.numpy(),
                                      np.asarray(jtf.Transform.from_scaling(s).matrix))
    # the quaternion of the identity and of a half turn (a zero pivot)
    for r in (np.eye(3, dtype=np.float32), np.diag([1.0, -1.0, -1.0]).astype(np.float32)):
        np.testing.assert_allclose(ttf.matrix_to_quaternion(_t(r)).numpy(),
                                   np.asarray(jtf.matrix_to_quaternion(jnp.asarray(r))),
                                   atol=1e-7)


def test_organized_cloud_matches_jax(rng):
    """``OrganizedPointCloud`` and ``CameraIntrinsics``: a u16 depth image
    back-projected (zero depth invalid), a grid with NaN holes, the
    accessors and the conversions, against JAX's (points within 1e-6)."""
    from threecrate_tpu.core import organized as jorg
    from threecrate_tpu_torch.core import organized as torg

    intr_j = jorg.CameraIntrinsics(525.0, 520.0, 31.5, 23.5)
    intr_t = tt.CameraIntrinsics(525.0, 520.0, 31.5, 23.5)
    np.testing.assert_array_equal(intr_t.as_matrix(), intr_j.as_matrix())
    depth = rng.integers(0, 4000, (48, 64)).astype(np.uint16)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0
    jo = jorg.OrganizedPointCloud.from_depth_image(depth, intr_j)
    to = tt.OrganizedPointCloud.from_depth_image(depth, intr_t, device="cpu")
    np.testing.assert_allclose(to.points.numpy(), np.asarray(jo.points), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
    assert (to.height, to.width) == (jo.height, jo.width) == (48, 64)
    assert int(to.size()) == int(jo.size()) and bool(to.is_dense()) == bool(jo.is_dense())
    for got, ref in ((to.at(5, 7), jo.at(5, 7)), (to.row(3), jo.row(3)), (to.ring(9), jo.ring(9))):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(to.to_numpy(), jo.to_numpy(), atol=1e-6)
    flat = to.to_unorganized()
    assert flat.capacity == 48 * 64 and len(flat) == int(jo.size())
    pts = rng.normal(0, 1, (6, 5, 3)).astype(np.float32)
    pts[1, 2, 0] = np.nan
    jg, tg = jorg.OrganizedPointCloud.from_numpy(pts), torg.OrganizedPointCloud.from_numpy(
        pts, device="cpu")
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
    assert not bool(tg.is_dense()) and int(tg.size()) == 29
    mask = rng.uniform(size=(6, 5)) < 0.5
    np.testing.assert_array_equal(
        torg.OrganizedPointCloud.from_numpy(pts, mask, device="cpu").mask.numpy(), mask)
    for bad in (np.zeros((4, 3)), np.zeros((2, 2, 2))):
        with pytest.raises(terr.InvalidDataError):
            torg.OrganizedPointCloud.from_numpy(bad, device="cpu")
    with pytest.raises(terr.InvalidDataError):
        torg.OrganizedPointCloud.from_depth_image(np.zeros(5), intr_t, device="cpu")
