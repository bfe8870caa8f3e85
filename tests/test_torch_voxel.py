"""Segmented run sums, the voxel grid and the crops: the PyTorch port
against the JAX package.

Both packages get the same padded cloud (``interop.cloud_from_numpy`` of
the JAX cloud's arrays). Stated tolerances: run sums within 1e-5 of the
run's Σ|value| (both sum each run at run magnitude, in other orders);
voxel counts, output masks and inverse maps equal; centroids within
1e-4 m (fp32 sums, in other orders, of coordinates up to ~200 m from the
cloud minimum, where one ulp is 1.5e-5 m) and averaged attributes within
1e-6; crop masks equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.ops import filtering as jf  # noqa: E402
from threecrate_tpu.ops import segmented as js  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import filtering as tf  # noqa: E402
from threecrate_tpu_torch.ops import segmented as ts  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _scan(n, seed):
    from bench import _kitti_like
    return _kitti_like(n, seed)


def _clouds(pts, mask=None, **attrs):
    """The same padded cloud in both packages."""
    mask = np.ones(len(pts), bool) if mask is None else mask
    jc = tc.PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                       attrs={k: jnp.asarray(v) for k, v in attrs.items()})
    pc = interop.cloud_from_numpy(pts, mask, attrs, device="cpu")
    return jc, pc


@pytest.mark.parametrize("first_start", [True, False])
def test_sorted_run_sums_match_jax(first_start):
    """Runs of 1-9 rows, 30% invalid rows (run heads included), and with
    ``first_start=False`` rows before the first run start (no run)."""
    rng = np.random.default_rng(int(first_start))
    n = 1500
    vals = rng.normal(0, 10, (n, 4)).astype(np.float32)
    new_run = np.zeros(n, bool)
    new_run[np.cumsum(rng.integers(1, 10, n))[:n // 2] % n] = True
    new_run[0] = first_start
    valid = rng.uniform(0, 1, n) > 0.3
    assert (new_run & ~valid).any()
    ref = np.asarray(js.sorted_run_sums(jnp.asarray(vals), jnp.asarray(new_run),
                                        jnp.asarray(valid)))
    got = ts.sorted_run_sums(torch.from_numpy(vals), torch.from_numpy(new_run),
                             torch.from_numpy(valid)).numpy()
    assert got.shape == ref.shape == (n, 5)
    np.testing.assert_array_equal(got[:, 4], ref[:, 4])
    np.testing.assert_array_equal(got[~new_run], 0.0)
    ids = np.cumsum(new_run) - 1
    scale = np.zeros(n)
    np.add.at(scale, ids[ids >= 0], np.abs(np.where(valid[:, None], vals, 0)).sum(1)[ids >= 0])
    err = np.abs(got[:, :4] - ref[:, :4]).max(1)[new_run]
    assert (err <= 1e-5 * np.maximum(scale[ids[new_run]], 1.0)).all()
    means, cnt = ts.sorted_run_means(torch.from_numpy(vals), torch.from_numpy(new_run),
                                     torch.from_numpy(valid))
    jm, jcnt = js.sorted_run_means(jnp.asarray(vals), jnp.asarray(new_run),
                                   jnp.asarray(valid))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(means.numpy(), np.asarray(jm), atol=1e-5)


def test_sorted_run_sums_without_runs():
    got = ts.sorted_run_sums(torch.ones(5, 2), torch.zeros(5, dtype=torch.bool),
                             torch.ones(5, dtype=torch.bool))
    assert got.shape == (5, 3) and not got.any()


def _assert_voxel_close(jres, tres):
    assert int(tres.num_voxels) == int(jres.num_voxels)
    np.testing.assert_array_equal(tres.cloud.mask.numpy(), np.asarray(jres.cloud.mask))
    np.testing.assert_array_equal(tres.voxel_index.numpy(), np.asarray(jres.voxel_index))
    np.testing.assert_allclose(tres.cloud.points.numpy(), np.asarray(jres.cloud.points),
                               atol=1e-4, rtol=0)
    assert set(tres.cloud.attrs) == set(jres.cloud.attrs)
    for k, v in jres.cloud.attrs.items():
        assert tres.cloud.attrs[k].shape == v.shape
        np.testing.assert_allclose(tres.cloud.attrs[k].numpy(), np.asarray(v), atol=1e-6)


@pytest.mark.parametrize("voxel", [0.2, 1.0, 5.0])
def test_voxel_grid_detailed_matches_jax(voxel):
    """6,000 points of a scan with 10% masked rows, a (N, 3) colour and a
    (N,) intensity attribute: centroids, attributes, count and inverse."""
    rng = np.random.default_rng(5)
    pts = _scan(6000, 5)
    mask = rng.uniform(0, 1, 6000) > 0.1
    colors = rng.uniform(0, 1, (6000, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, 6000).astype(np.float32)
    jc, pc = _clouds(pts, mask, colors=colors, intensity=inten)
    _assert_voxel_close(jf.voxel_grid_filter_detailed(jc, voxel),
                        tf.voxel_grid_filter_detailed(pc, voxel))


@pytest.mark.parametrize("average_attrs", [True, False])
def test_voxel_grid_filter_matches_jax(average_attrs):
    pts = _scan(3000, 6)
    nrm = np.random.default_rng(6).normal(0, 1, (3000, 3)).astype(np.float32)
    jc, pc = _clouds(pts, normals=nrm)
    jo = jf.voxel_grid_filter(jc, 0.5, average_attrs=average_attrs)
    to = tf.voxel_grid_filter(pc, 0.5, average_attrs=average_attrs)
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
    np.testing.assert_allclose(to.points.numpy(), np.asarray(jo.points), atol=1e-4)
    assert set(to.attrs) == set(jo.attrs)
    if average_attrs:
        np.testing.assert_allclose(to.normals.numpy(), np.asarray(jo.normals), atol=1e-6)


def test_voxel_grid_matches_numpy_oracle():
    """A float64 oracle on the same fp32 keys (the JAX tests' PCL
    semantics): one centroid per occupied voxel, in (z, y, x) key order."""
    pts = _scan(5000, 7)
    _, pc = _clouds(pts)
    res = tf.voxel_grid_filter_detailed(pc, 0.3)
    keys = np.floor((pts - pts.min(0)) / np.float32(0.3)).astype(np.int64)
    uniq, inv = np.unique(keys[:, ::-1], axis=0, return_inverse=True)
    cent = np.zeros((len(uniq), 3))
    np.add.at(cent, inv.reshape(-1), pts.astype(np.float64))
    cent /= np.bincount(inv.reshape(-1))[:, None]
    assert int(res.num_voxels) == len(uniq)
    np.testing.assert_allclose(res.cloud.points[:len(uniq)].numpy(), cent, atol=1e-4)
    np.testing.assert_array_equal(res.voxel_index.numpy(), inv.reshape(-1))


def test_all_masked_cloud_matches_jax():
    pts = _scan(500, 8)
    jc, pc = _clouds(pts, np.zeros(500, bool), intensity=np.ones(500, np.float32))
    jres, tres = jf.voxel_grid_filter_detailed(jc, 0.5), tf.voxel_grid_filter_detailed(pc, 0.5)
    _assert_voxel_close(jres, tres)
    assert int(tres.num_voxels) == 0 and (tres.voxel_index.numpy() == -1).all()


@pytest.mark.parametrize("size", [0.0, -0.1])
def test_voxel_size_must_be_positive(size):
    jc, pc = _clouds(_scan(100, 9))
    with pytest.raises(ValueError) as je:
        jf.voxel_grid_filter(jc, size)
    with pytest.raises(ValueError) as te:
        tf.voxel_grid_filter(pc, size)
    assert str(te.value) == str(je.value)
    # An explained difference: JAX's voxel_grid_filter_detailed divides by
    # the size unchecked; the port's keeps the guard and raises the
    # message of JAX's non-detailed entry (ROADMAP.md §3).
    with pytest.raises(ValueError) as td:
        tf.voxel_grid_filter_detailed(pc, size)
    assert str(td.value) == str(je.value)


@pytest.mark.parametrize("axis,lo,hi", [(0, -10.0, 5.0), (2, 0.0, 1.0), (1, 3.0, 2.0)])
def test_passthrough_matches_jax(axis, lo, hi):
    pts = _scan(2000, 10)
    mask = np.random.default_rng(10).uniform(0, 1, 2000) > 0.2
    jc, pc = _clouds(pts, mask)
    jr, tr = jf.passthrough_filter(jc, axis, lo, hi), tf.passthrough_filter(pc, axis, lo, hi)
    np.testing.assert_array_equal(tr.inlier_mask.numpy(), np.asarray(jr.inlier_mask))
    np.testing.assert_array_equal(tr.cloud.mask.numpy(), np.asarray(jr.cloud.mask))


@pytest.mark.parametrize("origin", [None, (5.0, -3.0, 0.5)])
def test_range_filter_matches_jax(origin):
    pts = _scan(2000, 11)
    jc, pc = _clouds(pts)
    jr = jf.range_filter(jc, 5.0, 30.0, origin=origin)
    tr = tf.range_filter(pc, 5.0, 30.0, origin=origin)
    np.testing.assert_array_equal(tr.inlier_mask.numpy(), np.asarray(jr.inlier_mask))
    assert 0.2 < tr.inlier_mask.numpy().mean() < 0.9
