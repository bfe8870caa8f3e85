"""Outlier filters: the PyTorch port against the JAX package.

Both packages get the same padded cloud. The window SOR runs the
two-pass window kNN on both sides (the Pallas kernel in interpret mode,
the port's plain version); the exact paths run each package's tiled
brute-force ``knn``.

Stated tolerances: keep masks equal on >= 99.9% of points, thresholds
within 1e-5 relative, per-point mean distances within 1e-4 relative on
>= 99.9% of valid points (both ``knn`` implementations expand
‖q‖² + ‖p‖² − 2q·p, and the two CPU matmuls round q·p differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.ops import filtering as jflt  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop, kernels  # noqa: E402
from threecrate_tpu_torch.ops import filtering as tflt  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _both(pts):
    jc = tc.PointCloud.from_numpy(pts)
    return jc, interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask), device="cpu")


def _noisy_scan(n, seed):
    """A scan with a few far outliers planted."""
    from bench import _kitti_like
    rng = np.random.default_rng(seed)
    pts = _kitti_like(n, seed)
    far = rng.choice(n, n // 200, replace=False)
    pts[far] += rng.normal(0, 40.0, (len(far), 3)).astype(np.float32)
    return pts, far


def _assert_keep_close(tres, jres):
    tk, jk = tres.inlier_mask.numpy(), np.asarray(jres.inlier_mask)
    assert np.mean(tk == jk) >= 0.999, np.mean(tk == jk)
    np.testing.assert_array_equal(tres.cloud.mask.numpy(), tk)
    torch.testing.assert_close(tres.cloud.points, torch.from_numpy(np.array(jres.cloud.points)))


@pytest.mark.parametrize("method", ["window", "exact"])
def test_statistical_outlier_removal_matches_jax(method):
    pts, far = _noisy_scan(3000, 0)
    jc, pc = _both(pts)
    jr = jflt.statistical_outlier_removal(jc, k=8, std_multiplier=1.0, method=method)
    kernels.reset_launch_counts()
    tr = tt.statistical_outlier_removal(pc, k=8, std_multiplier=1.0, method=method)
    _assert_keep_close(tr, jr)
    keep = tr.inlier_mask.numpy()
    assert not keep[3000:].any() and 0.5 < keep[:3000].mean() < 0.99
    assert (~keep[far]).mean() > 0.9                       # planted outliers go


def test_window_sor_means_and_threshold_match_jax():
    """The window branch's per-point means and threshold."""
    pts, _ = _noisy_scan(2500, 1)
    jc, pc = _both(pts)
    _, jm, jt = jflt._statistical_mask(jc.points, jc.mask, 8, np.float32(2.0), window=True)
    _, tm, tth = tflt._statistical_mask(pc.points, pc.mask, 8, 2.0, window=True)
    jm, tm = np.asarray(jm), tm.numpy()
    v = np.asarray(jc.mask)
    np.testing.assert_array_equal(np.isfinite(tm), np.isfinite(jm))
    assert np.mean(np.isclose(tm[v], jm[v], rtol=1e-4, atol=0)) >= 0.999
    assert tth.item() == pytest.approx(float(jt), rel=1e-5)


def test_sor_with_threshold_matches_jax():
    pts, _ = _noisy_scan(2000, 2)
    jc, pc = _both(pts)
    jr, jm, jt = jflt.statistical_outlier_removal_with_threshold(jc, k=6,
                                                                 std_multiplier=1.5)
    tr, tm, tth = tt.statistical_outlier_removal_with_threshold(pc, k=6,
                                                                std_multiplier=1.5)
    _assert_keep_close(tr, jr)
    v = np.asarray(jc.mask)
    assert np.mean(np.isclose(tm.numpy()[v], np.asarray(jm)[v], rtol=1e-4)) >= 0.999
    assert tth.item() == pytest.approx(float(jt), rel=1e-5)
    assert tth.dtype == torch.float32


def test_auto_method_threshold(monkeypatch):
    """"auto" takes the window search above AUTO_WINDOW_THRESHOLD points
    (262,144, as the JAX package); lowered here so a small cloud takes it."""
    from threecrate_tpu_torch.ops import neighbors as tn
    assert tflt.AUTO_WINDOW_THRESHOLD == jflt.AUTO_WINDOW_THRESHOLD == 262144
    calls = []
    real = tn.knn_window_sorted
    monkeypatch.setattr(tn, "knn_window_sorted",
                        lambda *a, **kw: calls.append(a[2]) or real(*a, **kw))
    pts, _ = _noisy_scan(1200, 3)
    _, pc = _both(pts)
    tt.statistical_outlier_removal(pc)
    assert calls == []
    monkeypatch.setattr(tflt, "AUTO_WINDOW_THRESHOLD", 1024)
    tt.statistical_outlier_removal(pc)
    assert calls == [9]                          # k + 1, the self slot included


@pytest.mark.parametrize("min_neighbors", [2, 5])
def test_radius_outlier_removal_matches_jax(min_neighbors):
    rng = np.random.default_rng(min_neighbors)
    pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    pts[:20] += 5.0                                  # a sparse far cluster
    jc, pc = _both(pts)
    jr = jflt.radius_outlier_removal(jc, radius=0.2, min_neighbors=min_neighbors,
                                     max_neighbors=4)
    tr = tt.radius_outlier_removal(pc, radius=0.2, min_neighbors=min_neighbors,
                                   max_neighbors=4)
    _assert_keep_close(tr, jr)
    assert not tr.inlier_mask.numpy()[:20].any()


def test_point_cloud_mask_helpers():
    pc = tt.PointCloud.from_numpy(np.zeros((5, 3), np.float32), capacity=8,
                                 device="cpu")
    keep = torch.tensor([True, False, True, True, False, True, True, True])
    sel = pc.select(keep)
    assert sel.mask.tolist() == [True, False, True, True, False, False, False, False]
    assert sel.points is pc.points and len(sel) == 3
    assert pc.with_mask(keep).mask is keep
