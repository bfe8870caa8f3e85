"""Grid kNN, the search wrappers, the point-cloud ops and the profiling
helpers: the PyTorch port (``threecrate_tpu_torch.ops.neighbors``,
``.ops.point_cloud_ops``, ``.utils.profiling``) against the JAX package
on the same clouds, on the CPU.

Stated tolerances:
- ``knn_grid``: slot validity equal, distances within 1e-6 slot by slot,
  ids equal wherever the slot's distance is apart from its neighbouring
  slots' by more than 1e-6 (both sides' top-k may order ties
  differently; the port forms d² with each product rounded, XLA may
  fuse them), ``estimate_cell_size`` the same float;
- ``KdTree``/``BruteForceSearch`` and the point ops on clouds inside the
  unit box: d² within 2e-6 slot by slot and ids equal where apart by
  more (the exact search's expanded d² = ‖q‖² + ‖p‖² − 2q·p rounds at a
  few ulp of ‖q‖² + ‖p‖² ≤ 6 in both packages, in different orders);
- ``batch_distances_squared`` in the unit box: within 2e-6 (the same
  expansion);
- ``sync``'s checksum: within 1e-6 of Σ|x| (summation order);
- ``concatenate``: bit-equal.
Inputs: seeded uniform, clustered and sheet clouds of 1,500-3,000 points.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu import PointCloud as JCloud  # noqa: E402
from threecrate_tpu.ops import neighbors as jn  # noqa: E402
from threecrate_tpu.ops import point_cloud_ops as jops  # noqa: E402
from threecrate_tpu.utils import profiling as jprof  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import PointCloud as TCloud  # noqa: E402
from threecrate_tpu_torch.ops import neighbors as tn  # noqa: E402
from threecrate_tpu_torch.ops import point_cloud_ops as tops  # noqa: E402
from threecrate_tpu_torch.utils import profiling as tprof  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _uniform(n=2500, seed=1, scale=2.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (n, 3)).astype(np.float32)


def _clustered(n=3000, seed=2):
    """Dense blobs and a sparse background: cells from empty to over
    capacity."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (6, 3))
    blobs = centers[rng.integers(0, 6, n - 600)] + rng.normal(0, 0.08, (n - 600, 3))
    return np.concatenate([blobs, rng.uniform(-2.5, 2.5, (600, 3))]).astype(np.float32)


def _surface(n=2500, seed=3):
    """A wavy sheet, the 2-D manifold ``estimate_cell_size`` assumes."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    return np.c_[xy, 0.2 * np.sin(2 * xy[:, 0]) + 0.01 * rng.normal(size=n)].astype(np.float32)


CLOUDS = {"uniform": _uniform(), "clustered": _clustered(), "surface": _surface()}


def _pair(pts):
    return JCloud.from_numpy(pts), TCloud.from_numpy(pts, device="cpu")


def _unit(pts):
    """``pts`` scaled into the unit box."""
    return (pts / np.abs(pts).max()).astype(np.float32)


def _assert_knn_close(t, j, n, tol=1e-6, squared=False):
    """``t`` (port) against ``j`` (JAX) on the first ``n`` query rows:
    validity equal, distances (d² with ``squared``) within ``tol`` slot
    by slot, ids equal where the slot's value is apart from its
    neighbouring slots' by more than ``tol``."""
    tm, jm = t.mask[:n].numpy(), np.asarray(j.mask)[:n]
    np.testing.assert_array_equal(tm, jm)
    td, jd = t.distances[:n].numpy(), np.asarray(j.distances)[:n]
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    if squared:
        td, jd = td * td, jd * jd
    np.testing.assert_allclose(td[fin], jd[fin], atol=tol, rtol=0)
    pad = np.full((n, 1), np.inf)
    dd = np.where(fin, jd, np.inf)
    with np.errstate(invalid="ignore"):      # inf − inf between padded slots
        gap = np.minimum(np.abs(np.diff(np.c_[-pad, dd], axis=1)),
                         np.abs(np.diff(np.c_[dd, pad], axis=1)))
    apart = jm & (gap > tol)
    assert apart.sum() >= 0.5 * jm.sum()
    np.testing.assert_array_equal(t.indices[:n].numpy()[apart], np.asarray(j.indices)[:n][apart])
    assert t.indices.dtype == torch.int64


@pytest.mark.parametrize("name", sorted(CLOUDS))
@pytest.mark.parametrize("k", [1, 10])
def test_estimate_cell_size_matches_jax(name, k):
    jc, tc = _pair(CLOUDS[name])
    assert tn.estimate_cell_size(tc.points, tc.mask, k) == \
        jn.estimate_cell_size(jc.points, jc.mask, k)


GRID_CASES = {
    "k10": dict(k=10),
    "k10_exclude_self": dict(k=10, exclude_self=True),
    "k4_ring2": dict(k=4, ring=2, cap_per_cell=8),
    "k16_cap4": dict(k=16, cap_per_cell=4),
    "k40_pads": dict(k=40, cap_per_cell=1),          # fewer candidates than k
    "k10_chunks": dict(k=10, query_chunk=700),
}


# every case on the clustered cloud (cells from empty to overfull), the
# defaults on the other two
GRID_RUNS = [("clustered", c) for c in sorted(GRID_CASES)] + \
    [(n, c) for n in ("surface", "uniform") for c in ("k10", "k10_exclude_self")]


@pytest.mark.parametrize("name,case", GRID_RUNS)
def test_knn_grid_matches_jax(name, case):
    pts = CLOUDS[name]
    jc, tc = _pair(pts)
    kw = dict(GRID_CASES[case])
    k = kw.pop("k")
    cell = jn.estimate_cell_size(jc.points, jc.mask, k)
    j = jn.knn_grid(jc.points, jc.mask, jc.points, jc.mask, k, cell, **kw)
    t = tn.knn_grid(tc.points, tc.mask, tc.points, tc.mask, k, cell, **kw)
    _assert_knn_close(t, j, len(pts))


def test_knn_grid_separate_queries_and_masks_match_jax():
    pts = CLOUDS["clustered"]
    jc, tc = _pair(pts)
    keep = np.arange(jc.capacity) % 3 != 0
    jm, tm = jc.mask & jnp.asarray(keep), tc.mask & torch.from_numpy(keep[:tc.capacity])
    q = _uniform(900, seed=9, scale=2.2)
    qmask = np.arange(900) % 4 != 0
    cell = 0.3
    j = jn.knn_grid(jc.points, jm, jnp.asarray(q), jnp.asarray(qmask), 8, cell)
    t = tn.knn_grid(tc.points, tm, torch.from_numpy(q), torch.from_numpy(qmask), 8, cell)
    _assert_knn_close(t, j, 900)
    assert not t.mask[~torch.from_numpy(qmask)].any()


def test_knn_grid_is_exact_within_its_ring():
    """Every neighbour within ring · cell of the query is found when no
    cell overflows: against the exact search."""
    tc = TCloud.from_numpy(_unit(CLOUDS["uniform"]), device="cpu")
    cell = 0.25
    got = tn.knn_grid(tc.points, tc.mask, tc.points, tc.mask, 6, cell, cap_per_cell=64)
    ref = tn.knn(tc.points, tc.mask, tc.points, tc.mask, 6)
    inside = (ref.mask & (ref.distances < cell)).all(1)
    assert inside.float().mean() > 0.9
    torch.testing.assert_close(got.distances[inside] ** 2, ref.distances[inside] ** 2,
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("name", ["clustered", "uniform"])
def test_kdtree_matches_jax(name):
    pts = _unit(CLOUDS[name])
    jc, tc = _pair(pts)
    q = _uniform(300, seed=11, scale=1.0)
    jt, tt_ = jn.KdTree(jc), tn.KdTree(tc)
    assert tn.KdTree is tn.BruteForceSearch and tt.KdTree is tn.KdTree
    _assert_knn_close(tt_.find_k_nearest(q, 7), jt.find_k_nearest(q, 7), 300, 2e-6, True)
    _assert_knn_close(tt_.find_radius_neighbors(q, 0.12, 12),
                      jt.find_radius_neighbors(q, 0.12, 12), 300, 2e-6, True)
    _assert_knn_close(tt_.find_k_nearest(q[0], 3), jt.find_k_nearest(q[0], 3), 1, 2e-6, True)


def test_batch_distances_squared_matches_jax():
    a, b = _uniform(300, 4, 1.0), _uniform(200, 5, 1.0)
    np.testing.assert_allclose(tn.batch_distances_squared(torch.from_numpy(a),
                                                          torch.from_numpy(b)).numpy(),
                               np.asarray(jn.batch_distances_squared(a, b)), rtol=0,
                               atol=2e-6)
    d = tn.batch_distances_squared(torch.from_numpy(a), torch.from_numpy(a))
    assert float(d.min()) >= 0.0 and d.shape == (300, 300)


# ---------------------------------------------------------------------------
# point-cloud ops
# ---------------------------------------------------------------------------

def _attr_clouds():
    rng = np.random.default_rng(6)
    a, b, c = _uniform(300, 7), _uniform(200, 8), _uniform(130, 9)
    na = rng.normal(size=(300, 3)).astype(np.float32)
    cb = rng.uniform(size=(200, 3)).astype(np.float32)
    ic = rng.uniform(size=130).astype(np.float32)
    j = [JCloud.from_numpy(a, normals=na), JCloud.from_numpy(b, colors=cb),
         JCloud.from_numpy(c, intensity=ic)]
    t = [TCloud.from_numpy(a, normals=na, capacity=j[0].capacity, device="cpu"),
         TCloud.from_numpy(b, colors=cb, capacity=j[1].capacity, device="cpu"),
         TCloud.from_numpy(c, intensity=ic, capacity=j[2].capacity, device="cpu")]
    return j, t


def test_concatenate_matches_jax():
    j, t = _attr_clouds()
    jc, tc = jops.concatenate(j), tops.concatenate(t)
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    assert sorted(tc.attrs) == sorted(jc.attrs)
    for k in jc.attrs:
        np.testing.assert_array_equal(tc.attrs[k].numpy(), np.asarray(jc.attrs[k]))
    assert tops.concatenate(t[:1]) is t[0]
    with pytest.raises(Exception) as je:
        jops.concatenate([])
    with pytest.raises(Exception) as te:
        tops.concatenate([])
    assert type(te.value).__name__ == type(je.value).__name__ and str(te.value) == str(je.value)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_k_nearest_neighbors_matches_jax(exclude_self):
    jc, tc = _pair(_unit(CLOUDS["surface"][:1500]))
    _assert_knn_close(tc.k_nearest_neighbors(6, exclude_self),
                      jops.k_nearest_neighbors(jc, 6, exclude_self), 1500, 2e-6, True)


def test_single_query_ops_match_jax():
    pts = _unit(CLOUDS["clustered"])
    jc, tc = _pair(pts)
    for q in ([0.1, -0.2, 0.3], pts[10] + 0.01, pts[2900]):
        ji, jd = jops.nearest_neighbor(jc, q)
        ti, td = tc.nearest_neighbor(q)
        assert ti == ji and isinstance(ti, int) and abs(td * td - jd * jd) <= 2e-6
        got = tc.neighbors_within(q, 0.05, 32)
        np.testing.assert_array_equal(np.sort(got), np.sort(jops.neighbors_within(jc, q, 0.05, 32)))
        np.testing.assert_array_equal(tops.neighbors_within(tc, q, 0.05, 32), got)
        np.testing.assert_array_equal(np.sort(tops.neighbors_within(tc, q, 0.05)),
                                      np.sort(jops.neighbors_within(jc, q, 0.05)))
    assert len(tc.neighbors_within(pts[10], 0.05, 32)) > 5
    assert tops.k_nearest_neighbors(tc, 3).indices.shape == (tc.capacity, 3)


def test_root_names():
    for name in ("concatenate", "k_nearest_neighbors", "nearest_neighbor", "neighbors_within"):
        assert getattr(tt, name) is getattr(tops, name) and name in tt.__all__
    for name in ("BruteForceSearch", "KdTree", "knn_grid"):
        assert getattr(tt, name) is getattr(tn, name) and name in tt.__all__


# ---------------------------------------------------------------------------
# profiling helpers
# ---------------------------------------------------------------------------

def test_sync_checksums_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    x[3, 1] = np.nan
    b = rng.uniform(size=40) < 0.3
    for jo, to in (((jnp.asarray(x), 1), (torch.from_numpy(x), 1)),
                   (jnp.asarray(b), torch.from_numpy(b)),
                   ({"a": jnp.asarray(x)}, {"a": torch.from_numpy(x)}),
                   (JCloud.from_numpy(x[:10]), TCloud.from_numpy(x[:10], device="cpu")),
                   ((), ())):
        assert abs(tprof.sync(to) - jprof.sync(jo)) <= 1e-6 * np.nansum(np.abs(x))


def test_timer_reports_like_jax(monkeypatch):
    jt, t = jprof.Timer(), tprof.Timer()
    for timer in (jt, t):
        clock = iter([0.0, 0.004, 0.004, 0.005, 0.005, 0.0075])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        for name in ("read", "fit", "read"):
            with timer.section(name):
                pass
    assert t.sections == jt.sections and t.report() == jt.report()


def test_trace_names_a_profiler_range(tmp_path):
    """``trace(log_dir)`` yields the directory, as JAX's does, and writes
    a Chrome trace there that holds the block's operators."""
    import json
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir=log_dir) as got:
        with torch.profiler.record_function("tc_segment"):
            torch.ones(4).sum()
    assert got == log_dir
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"tc_segment", "aten::sum"} <= names


def test_memory_helpers_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU answers; on the card tests/test_torch_cuda.py holds them")
    assert tprof.device_memory_stats() == {}
    out, peak = tprof.measure_peak_memory(lambda: torch.ones(10))
    assert peak == 0 and torch.equal(out, torch.ones(10))
    assert tprof.program_memory(lambda x: x + 1, torch.ones(3)) == {}
