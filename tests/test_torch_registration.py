"""Point-to-point ICP: the PyTorch port against the JAX package.

Both packages get the same padded clouds. The target is the source
moved by a small rigid motion plus noise, so the final MSE is well
above fp32 rounding and can be compared. The brute-force path gets a
±2 m surface: its distances come from ‖q‖² + ‖p‖² − 2q·p in both
packages, whose fp32 cancellation at 100 m LiDAR ranges (~1e-3 m²) is
larger than the MSE itself. Stated tolerances: the
transform's translation and rotation entries within 1e-4, the MSE
within 1e-2 relative, the same iteration count and convergence flag.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.core.transform import se3_exp  # noqa: E402
from threecrate_tpu.ops import registration as jr  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import registration as tr  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _surface(n, rng):
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def _pair(n, seed, noise=0.01, scan=True):
    from bench import _kitti_like
    rng = np.random.default_rng(seed)
    src = _kitti_like(n, seed) if scan else _surface(n, rng)
    m = np.asarray(se3_exp(jnp.asarray([0.004, -0.003, 0.006, 0.05, -0.03, 0.02],
                                       jnp.float32)))
    tgt = (src @ m[:3, :3].T + m[:3, 3] + rng.normal(0, noise, src.shape)
           ).astype(np.float32)
    return src, tgt


def _clouds(src, tgt):
    js, jt = tc.PointCloud.from_numpy(src), tc.PointCloud.from_numpy(tgt)
    ts = interop.cloud_from_numpy(np.asarray(js.points), np.asarray(js.mask))
    tt_ = interop.cloud_from_numpy(np.asarray(jt.points), np.asarray(jt.mask))
    return js, jt, ts, tt_


def _assert_same(jres, tres):
    np.testing.assert_allclose(tres.transformation.numpy(),
                               np.asarray(jres.transformation), atol=1e-4)
    np.testing.assert_allclose(float(tres.mse), float(jres.mse), rtol=1e-2)
    assert tres.iterations == int(jres.iterations)
    assert tres.converged == bool(jres.converged)


def test_exact_icp_matches_jax():
    """2,048 points: below the pair threshold, brute-force 1-NN."""
    js, jt, ts, tt_ = _clouds(*_pair(2000, 0, scan=False))
    jres = jr.icp_point_to_point(js, jt, max_iterations=15)
    tres = tr.icp_point_to_point(ts, tt_, max_iterations=15)
    _assert_same(jres, tres)
    assert 1000 < tres.correspondences <= 2000


@pytest.mark.parametrize("subsample", [1, 2])
def test_window_icp_matches_jax(subsample):
    """16,640 points on the static-sort window path; subsample=2 runs the
    coarse/fine ladder (coarse phase on every 2nd source tile)."""
    js, jt, ts, tt_ = _clouds(*_pair(16_640, 1))
    kw = dict(max_iterations=10, correspondence="window", subsample=subsample)
    jres = jr.icp_point_to_point(js, jt, **kw)
    tres = tr.icp_point_to_point(ts, tt_, **kw)
    _assert_same(jres, tres)


def test_max_correspondence_distance_matches_jax():
    """5% of the target lifted by 1 m: the 0.3 m limit drops them."""
    src, tgt = _pair(2000, 2, scan=False)
    tgt[::20, 2] += 1.0
    js, jt, ts, tt_ = _clouds(src, tgt)
    kw = dict(max_iterations=8, max_correspondence_distance=0.3)
    _assert_same(jr.icp_point_to_point(js, jt, **kw),
                 tr.icp_point_to_point(ts, tt_, **kw))


@pytest.mark.parametrize("n,invalid", [(1000, 0.0), (1001, 0.3), (1000, 0.6),
                                       (1001, 0.6), (9, 1.0)])
def test_percentile_matches_jnp(n, invalid):
    """The trimming gate's median, with inf entries from unmatched
    points: more than half invalid puts the median among the infs (NaN
    in jnp's formula for odd lengths, inf for even ones)."""
    rng = np.random.default_rng(n)
    x = rng.exponential(1.0, n).astype(np.float32)
    x[rng.uniform(0, 1, n) < invalid] = np.inf
    ref = np.asarray(jnp.percentile(jnp.asarray(x), 50.0))
    got = tr.percentile(torch.from_numpy(x), 50.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_auto_choices_match_jax():
    for n_src in (1, 10_000, 50_000, 200_000, 800_000, 2_000_000):
        assert tr.auto_subsample(n_src) == jr.auto_subsample(n_src)
        for ratio in (0.25, 1.0, 1.5, 4.0, 40.0):
            n_tgt = int(n_src * ratio)
            assert tr.auto_w_tiles(n_src, n_tgt) == jr.auto_w_tiles(n_src, n_tgt)
    assert tr.CORRESPONDENCE_WINDOW_THRESHOLD == jr.CORRESPONDENCE_WINDOW_THRESHOLD


def test_use_window_dispatch():
    src, tgt = _pair(256, 3)
    _, _, ts, tt_ = _clouds(src, tgt)
    assert not tr._use_window(ts, tt_, "auto")
    assert tr._use_window(ts, tt_, "window")
    assert not tr._use_window(ts, tt_, "exact")
    res = tr.icp(ts, tt_, max_iterations=2)
    assert res.iterations == 2 and res.as_transform().matrix.shape == (4, 4)
