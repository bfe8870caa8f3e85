"""Normal estimation: the PyTorch port against the JAX package.

Both packages get the same padded cloud (``interop.cloud_from_numpy``
of the JAX cloud's arrays). Stated tolerance: >= 99% of valid normals
within 1° of the JAX normal (sign included), curvature within 1e-3
absolute on >= 99% of points, and the same validity mask.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.ops import normals as jn  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import normals as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _scan(n, seed, scale=1.0):
    from bench import _kitti_like
    return (_kitti_like(n, seed) * np.float32(scale)).astype(np.float32)


def _both(pts, config_kw):
    jc = tc.PointCloud.from_numpy(pts)
    tcl = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask))
    jr = jn.estimate_normals_detailed(jc, jn.NormalEstimationConfig(**config_kw))
    tr = tn.estimate_normals_detailed(tcl, tn.NormalEstimationConfig(**config_kw))
    return jr, tr


def _assert_close(jr, tr):
    jv, tv = np.asarray(jr.valid), tr.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    jnrm, tnrm = np.asarray(jr.normals)[jv], tr.normals.numpy()[jv]
    cos = np.clip((jnrm * tnrm).sum(1), -1, 1)
    ang = np.degrees(np.arccos(cos))
    assert np.mean(ang < 1.0) >= 0.99, np.quantile(ang, [0.5, 0.99])
    curv = np.abs(np.asarray(jr.curvature) - tr.curvature.numpy())
    assert np.mean(curv < 1e-3) >= 0.99
    np.testing.assert_allclose(np.linalg.norm(tr.normals.numpy()[jv], axis=1), 1.0,
                               atol=1e-5)
    assert (tr.normals.numpy()[~jv] == 0).all()


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_exact_normals_match_jax(scale):
    """2,048 points: below the threshold, the exact kNN path."""
    jr, tr = _both(_scan(2000, 3, scale), dict(k_neighbors=10))
    _assert_close(jr, tr)


def test_radius_normals_match_jax():
    jr, tr = _both(_scan(2000, 4), dict(k_neighbors=12, radius=1.5))
    _assert_close(jr, tr)


def test_union_normals_match_jax(monkeypatch):
    """8,000 points with the auto threshold lowered in BOTH packages, so
    the two-window union (and its kernels) carries the estimate."""
    monkeypatch.setattr(jn, "AUTO_WINDOW_THRESHOLD", 4096)
    monkeypatch.setattr(tn, "AUTO_WINDOW_THRESHOLD", 4096)
    pts = _scan(8000, 5)
    jr, tr = _both(pts, dict(k_neighbors=10))
    _assert_close(jr, tr)
    with_n = tn.estimate_normals(interop.cloud_from_numpy(
        np.asarray(tc.PointCloud.from_numpy(pts).points),
        np.asarray(tc.PointCloud.from_numpy(pts).mask)), k=10)
    torch.testing.assert_close(with_n.normals, tr.normals)


@pytest.mark.parametrize("bad", [dict(method="fast"), dict(window_passes=0),
                                 dict(window_merge="best"),
                                 dict(method="window", radius=0.5),
                                 dict(method="window_fast", radius=0.5)])
def test_validation_errors_match(bad):
    pts = _scan(256, 6)
    with pytest.raises(ValueError) as je:
        _both(pts, bad)
    jc = tc.PointCloud.from_numpy(pts)
    tcl = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask))
    with pytest.raises(ValueError) as te:
        tn.estimate_normals_detailed(tcl, tn.NormalEstimationConfig(**bad))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("cfg", [dict(method="window"),
                                 dict(method="window_fast"),
                                 dict(method="window_fast", window_passes=1,
                                      window_merge="union")])
def test_unported_methods_name_their_roadmap_item(cfg):
    c = interop.cloud_from_numpy(np.zeros((256, 3), np.float32), np.ones(256, bool))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tn.estimate_normals_detailed(c, tn.NormalEstimationConfig(**cfg))


def test_window_fast_union_is_the_union_path():
    """method="window_fast" with window_merge="union" is the union in the
    JAX package too, so it runs here."""
    pts = _scan(2000, 7)
    jr, tr = _both(pts, dict(method="window_fast", window_merge="union"))
    _assert_close(jr, tr)


def test_viewpoint_orientation():
    pts = _scan(1000, 8)
    vp = (0.0, 0.0, 100.0)
    jr, tr = _both(pts, dict(viewpoint=vp))
    _assert_close(jr, tr)
    v = tr.valid.numpy()[:1000]
    n, p = tr.normals.numpy()[:1000][v], pts[v]
    assert ((np.asarray(vp) - p) * n).sum(1).min() >= 0
