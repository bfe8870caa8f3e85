"""GICP: the PyTorch port (``threecrate_tpu_torch.ops.gicp``) against the
JAX package on the same clouds.

The clouds are the JAX package's own GICP fixtures
(``tests/test_registration.py``: ``TestGicp``, ``TestGicpWindow`` and
``TestGicpAdversarialCovariances``, whose 100x density contrast runs at
``w_tiles=6``) and one noisy pair. The window paths are forced
(``method="window"``): the JAX side runs the union kernels and
``icp_match`` in interpret mode, the port their plain versions.

Stated tolerances:
- ``inv3x3`` and the covariance column packing: equal; the expanded
  normal equations within 1e-6 of the largest entry of h (of g), at unit,
  mm (1e-3) and 100 m scales, on near-singular and singular matrices too
  (the 1e-30 determinant floor);
- ``point_covariances``: validity masks equal; exact path, covariances
  within 1e-5 of the cloud's largest entry where both select the same
  20 neighbours (>= 99% of points; elsewhere a near-tied 20th neighbour);
  window path, within 1e-3 of each point's query-centred second moment
  on >= 99% of points and 1e-2 everywhere (the union sums' own
  differences against the interpret-mode kernels, carried over);
- ``gicp`` and ``_gicp_loop``: the transform within 1e-4, the same
  iteration count, convergence flag and correspondence count, the MSE
  within 1e-2 relative. A noiseless pair's MSE is fp32 rounding noise
  (1e-16-1e-10 m²), so there it is also allowed 1e-9 m² absolute; the
  noisy pair (σ = 1 cm) is held to 1e-2 relative alone;
- the empty and degenerate clouds raise the JAX package's error types
  with its messages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu import PointCloud, Transform  # noqa: E402
from threecrate_tpu.core.errors import AlgorithmError as JaxAlgorithmError  # noqa: E402
from threecrate_tpu.core.errors import InvalidDataError as JaxInvalidDataError  # noqa: E402
from threecrate_tpu.ops import gicp as jg  # noqa: E402
from threecrate_tpu.ops import neighbors as jnb  # noqa: E402
from threecrate_tpu.ops import normals as jnm  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.core.errors import AlgorithmError, InvalidDataError  # noqa: E402
from threecrate_tpu_torch.ops import gicp as tg  # noqa: E402
from threecrate_tpu_torch.ops import neighbors as tnb  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _surface(n, seed):
    """``surface_cloud`` of the JAX tests: a wavy ±2 m surface."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def _apply(t, pts):
    m = np.asarray(t.matrix)
    return (pts @ m[:3, :3].T + m[:3, 3]).astype(np.float32)


def _slab():
    rng = np.random.default_rng(31)
    n = 4000
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.normal(0, 0.005, n)], -1).astype(np.float32)
    pts[:, 2] += (0.2 * np.sin(pts[:, 0] * 2.0) * np.cos(pts[:, 1] * 1.5)).astype(np.float32)
    t = Transform.from_axis_angle([1.0, 0.3, 0], 0.02) @ \
        Transform.from_translation([0.03, -0.02, 0.01])
    return pts, _apply(t, pts)


def _mixed_density():
    rng = np.random.default_rng(32)
    sparse = rng.uniform(-3, 3, (1500, 3)).astype(np.float32)
    sparse[:, 2] = 0.3 * np.sin(sparse[:, 0]) + 0.2 * np.cos(sparse[:, 1])
    dense = (rng.normal(0, 0.05, (3500, 3)) + [1.0, -0.8, 0.5]).astype(np.float32)
    pts = np.concatenate([sparse, dense]).astype(np.float32)
    t = Transform.from_axis_angle([0, 1.0, 0.2], 0.02) @ \
        Transform.from_translation([0.02, 0.03, -0.02])
    return pts, _apply(t, pts)


def _segments():
    rng = np.random.default_rng(33)
    segs = []
    for _ in range(14):
        t = rng.uniform(0, 1, 300)[:, None]
        a = rng.uniform(-2, 2, 3)
        b = rng.uniform(-2, 2, 3)
        segs.append(a + t * (b - a) + rng.normal(0, 0.004, (300, 3)))
    pts = np.concatenate(segs).astype(np.float32)
    t = Transform.from_axis_angle([0.2, 0.3, 1.0], 0.02) @ \
        Transform.from_translation([0.03, -0.01, 0.02])
    return pts, _apply(t, pts)


def _noisy():
    rng = np.random.default_rng(7)
    pts = _surface(2000, 7)
    tgt = _apply(Transform.from_translation([0.04, -0.02, 0.01]), pts)
    return pts, (tgt + rng.normal(0, 0.01, pts.shape)).astype(np.float32)


FIXTURES = {
    "gicp600": lambda: (_surface(600, 0), _apply(
        Transform.from_translation([0.04, -0.02, 0.01]), _surface(600, 0))),
    "window1200": lambda: (_surface(1200, 3), _apply(
        Transform.from_translation([0.03, -0.015, 0.01]), _surface(1200, 3))),
    "thin_slab": _slab,
    "mixed_density": _mixed_density,
    "segments": _segments,
    "noisy": _noisy,
}


def _clouds(src, tgt):
    js, jt = PointCloud.from_numpy(src), PointCloud.from_numpy(tgt)

    def port(c):
        return interop.cloud_from_numpy(np.asarray(c.points), np.asarray(c.mask), device="cpu")

    return js, jt, port(js), port(jt)


def _assert_same(jres, tres, noiseless=True):
    np.testing.assert_allclose(tres.transformation.numpy(),
                               np.asarray(jres.transformation), atol=1e-4)
    assert tres.iterations == int(jres.iterations)
    assert tres.converged == bool(jres.converged)
    assert tres.correspondences == int(jres.correspondences)
    np.testing.assert_allclose(float(tres.mse), float(jres.mse), rtol=1e-2,
                               atol=1e-9 if noiseless else 0.0)


def _matrices(kind, scale, n=400, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (n, 3, 3))
    if kind == "spd":
        m = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)
    elif kind == "near_singular":            # condition number 1e5
        u = np.linalg.qr(a)[0]
        m = (u * np.array([1.0, 1e-2, 1e-5])) @ u.transpose(0, 2, 1)
    else:                                    # rank 1, and every 7th all zero
        v = rng.normal(0, 1, (n, 3, 1))
        m = v @ v.transpose(0, 2, 1)
        m[::7] = 0.0
    return (m * scale).astype(np.float32)


SCALES = [1.0, 1e-3, 100.0]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("kind", ["spd", "near_singular", "singular"])
def test_inv3x3_matches_jax(kind, scale):
    """The adjugate over the floored determinant: the same fp32 operations
    in the same order, so the same bits (singular rows at 1e30·adj)."""
    m = _matrices(kind, scale)
    ref = np.asarray(jg.inv3x3(jnp.asarray(m)))
    got = tg.inv3x3(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cov_columns_match_jax():
    """(N, 3, 3) ↔ (N, 6) and (6, N) columns: equal both ways."""
    m = _matrices("spd", 1.0, n=50)
    cols = np.asarray(jg._cov_to_cols(jnp.asarray(m)))
    np.testing.assert_array_equal(tg._cov_to_cols(torch.from_numpy(m)).numpy(), cols)
    for c in (cols, np.ascontiguousarray(cols.T)):
        np.testing.assert_array_equal(tg._cols_to_cov(torch.from_numpy(c.copy())).numpy(),
                                      np.asarray(jg._cols_to_cov(jnp.asarray(c))))


@pytest.mark.parametrize("scale", SCALES)
def test_normal_equations_match_jax(scale):
    """500 rows of metres-scaled points and residuals against a symmetric
    W in 1/scale²: h and g within 1e-6 of their largest entry (the sums
    run in another order)."""
    rng = np.random.default_rng(1)
    moved = (rng.normal(0, 5, (500, 3)) * scale).astype(np.float32)
    r = (rng.normal(0, 1, (500, 3)) * scale).astype(np.float32)
    w = rng.normal(0, 1, (500, 3, 3))
    w = ((w + w.transpose(0, 2, 1)) / scale ** 2).astype(np.float32)
    hj, gj = (np.asarray(x) for x in jg._normal_equations(
        jnp.asarray(moved), jnp.asarray(r), jnp.asarray(w)))
    ht, gt = tg._normal_equations(*(torch.from_numpy(x) for x in (moved, r, w)))
    assert np.abs(ht.numpy() - hj).max() <= 1e-6 * np.abs(hj).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-6 * np.abs(gj).max()
    np.testing.assert_array_equal(ht.numpy(), ht.numpy().T)


@pytest.mark.parametrize("fixture", ["window1200", "thin_slab", "segments", "mixed_density"])
def test_exact_point_covariances_match_jax(fixture):
    """k = 20 (GICP's default), exact kNN: equal masks; covariances within
    1e-5 of the cloud's largest entry wherever both packages select the
    same 20 neighbours, which is >= 99% of the points (elsewhere the 20th
    neighbour is near-tied and XLA:CPU's FMA-contracted d² picks the
    other one)."""
    src, _ = FIXTURES[fixture]()
    js, _, ts, _ = _clouds(src, src)
    jc, jok = jg.point_covariances(js.points, js.mask, 20, jnp.float32(1e-4), False)
    tc, tok = tg.point_covariances(ts.points, ts.mask, 20, float(np.float32(1e-4)), False)
    jc, jok = np.asarray(jc), np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    jset = np.sort(np.asarray(jnb.knn(js.points, js.mask, js.points, js.mask, 20).indices), 1)
    tset = np.sort(tnb.knn(ts.points, ts.mask, ts.points, ts.mask, 20).indices.numpy(), 1)
    same = (jset == tset).all(1) & jok
    assert same.sum() >= 0.99 * jok.sum()
    assert np.abs(tc.numpy() - jc)[same].max() <= 1e-5 * np.abs(jc[jok]).max()


@pytest.mark.parametrize("fixture", ["window1200", "thin_slab", "segments", "mixed_density"])
def test_window_point_covariances_match_jax(fixture):
    """k = 20 through the union-window sums, scattered back to input
    order: equal masks (the counts are equal); each covariance within
    1e-3 of its point's query-centred second moment tr(S2)/n on >= 99% of
    the valid points and within 1e-2 everywhere. cov = S2/n − (S1/n)²
    carries the union sums' differences over whole: on the line segments
    the sums themselves differ by up to 5.4e-3 of that scale at equal
    counts (0.8% of points above 1e-3; a scan's are held to 1e-3 on
    99.9% in tests/test_torch_kernels.py)."""
    src, _ = FIXTURES[fixture]()
    js, _, ts, _ = _clouds(src, src)
    jc, jok = jg.point_covariances(js.points, js.mask, 20, jnp.float32(1e-4), True)
    tc, tok = tg.point_covariances(ts.points, ts.mask, 20, float(np.float32(1e-4)), True)
    jc, jok = np.asarray(jc), np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    s, _, _, perm = jnm._union_window_sums(js.points, js.mask, 20)
    s, perm = np.asarray(s), np.asarray(perm)
    scale = np.empty(len(s), np.float32)
    scale[perm] = (s[:, 4] + s[:, 5] + s[:, 6]) / np.maximum(s[:, 0], 1.0)
    err = np.abs(tc.numpy() - jc).reshape(len(jc), -1).max(1)[jok] / scale[:len(jc)][jok]
    assert np.mean(err <= 1e-3) >= 0.99, np.quantile(err, [0.5, 0.99])
    assert err.max() <= 1e-2, err.max()


@pytest.mark.parametrize("method,subsample", [("exact", 1), ("exact", 2),
                                              ("window", 1), ("window", 2)])
def test_gicp_matches_jax(method, subsample):
    """``TestGicp``'s 600-point pair, both methods; on the window path
    subsample 2 runs the coarse phase on every 2nd source tile."""
    js, jt, ts, tt_ = _clouds(*FIXTURES["gicp600"]())
    kw = dict(method=method, subsample=subsample)
    _assert_same(jg.gicp(js, jt, jg.GicpConfig(**kw)), tg.gicp(ts, tt_, tg.GicpConfig(**kw)))


@pytest.mark.parametrize("subsample", [1, 2])
def test_gicp_window_matches_jax(subsample):
    """``TestGicpWindow``'s 1,200-point pair on the window path."""
    js, jt, ts, tt_ = _clouds(*FIXTURES["window1200"]())
    kw = dict(method="window", subsample=subsample)
    _assert_same(jg.gicp(js, jt, jg.GicpConfig(**kw)), tg.gicp(ts, tt_, tg.GicpConfig(**kw)))


@pytest.mark.parametrize("method", ["exact", "window"])
@pytest.mark.parametrize("fixture", ["thin_slab", "mixed_density", "segments"])
def test_gicp_adversarial_matches_jax(fixture, method):
    """``TestGicpAdversarialCovariances``: a 5 mm slab, the 100x density
    contrast (at ``w_tiles=6``, as the JAX test runs it) and noisy line
    segments."""
    js, jt, ts, tt_ = _clouds(*FIXTURES[fixture]())
    kw = dict(method=method, w_tiles=6 if fixture == "mixed_density" else None)
    _assert_same(jg.gicp(js, jt, jg.GicpConfig(**kw)), tg.gicp(ts, tt_, tg.GicpConfig(**kw)))


@pytest.mark.parametrize("method,subsample", [("exact", 1), ("window", 1), ("window", 2)])
def test_gicp_noisy_matches_jax(method, subsample):
    """σ = 1 cm target noise: the MSE (~3e-4 m²) is held to 1e-2 relative."""
    js, jt, ts, tt_ = _clouds(*FIXTURES["noisy"]())
    kw = dict(method=method, subsample=subsample)
    _assert_same(jg.gicp(js, jt, jg.GicpConfig(**kw)), tg.gicp(ts, tt_, tg.GicpConfig(**kw)),
                 noiseless=False)


@pytest.mark.parametrize("cov_window", [False, True])
def test_gicp_loop_matches_jax(cov_window):
    """``_gicp_loop`` called directly as the JAX test's covariance
    isolation does: exact correspondences, covariances from either path,
    on the line-segment fixture."""
    src, tgt = FIXTURES["segments"]()
    js, jt, ts, tt_ = _clouds(src, tgt)
    eps = float(np.float32(1e-4))
    jsc, jsok = jg.point_covariances(js.points, js.mask, 20, jnp.float32(eps), cov_window)
    jtc, jtok = jg.point_covariances(jt.points, jt.mask, 20, jnp.float32(eps), cov_window)
    jout = jg._gicp_loop(js.points, jsok, jsc, jt.points, jtok, jtc,
                         jnp.eye(4, dtype=jnp.float32), 50, jnp.float32(1e-6),
                         jnp.float32(1.0), False, 3)
    tsc, tsok = tg.point_covariances(ts.points, ts.mask, 20, eps, cov_window)
    ttc, ttok = tg.point_covariances(tt_.points, tt_.mask, 20, eps, cov_window)
    tout = tg._gicp_loop(ts.points, tsok, tsc, tt_.points, ttok, ttc, torch.eye(4), 50,
                         1e-6, 1.0, False, 3)
    _assert_same(tg.ICPResult(*jout), tg.ICPResult(*tout))


def test_empty_and_degenerate_clouds_raise_as_jax():
    """Capacity 0 → InvalidDataError; a line → AlgorithmError naming the
    source; the same messages as the JAX package."""
    empty_j = PointCloud(jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), bool))
    empty_t = interop.cloud_from_numpy(np.zeros((0, 3), np.float32), np.zeros(0, bool),
                                       device="cpu")
    line = np.stack([np.linspace(0, 1, 50), np.zeros(50), np.zeros(50)], -1).astype(np.float32)
    js, _, ts, _ = _clouds(line, line)
    for (jsrc, jtgt), (tsrc, ttgt), jerr, terr in (
            ((empty_j, js), (empty_t, ts), JaxInvalidDataError, InvalidDataError),
            ((js, empty_j), (ts, empty_t), JaxInvalidDataError, InvalidDataError),
            ((js, js), (ts, ts), JaxAlgorithmError, AlgorithmError)):
        with pytest.raises(jerr) as je:
            jg.gicp(jsrc, jtgt)
        with pytest.raises(terr) as te:
            tg.gicp(tsrc, ttgt)
        assert str(te.value) == str(je.value)


def test_gicp_defaults_match_jax():
    assert tg.GicpConfig() == tg.GicpConfig(**{
        f: getattr(jg.GicpConfig(), f) for f in tg.GicpConfig.__dataclass_fields__})
    assert set(tg.GicpConfig.__dataclass_fields__) == set(jg.GicpConfig.__dataclass_fields__)


def test_gicp_config_from_carries_every_field():
    cfg = jg.GicpConfig(max_iterations=7, max_correspondence_distance=0.3,
                        convergence_threshold=1e-5, k_correspondences=12,
                        covariance_epsilon=1e-3, method="window", w_tiles=5, subsample=4,
                        full_iters=3)
    got = interop.gicp_config_from(cfg)
    assert isinstance(got, tg.GicpConfig)
    for f in jg.GicpConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(cfg, f), f
