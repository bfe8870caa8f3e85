"""Plane RANSAC and Euclidean clustering: the PyTorch port
(``threecrate_tpu_torch.ops.segmentation``) against the JAX package on
the same clouds, on the CPU.

Stated tolerances:
- the plane scorer fed JAX's own triples (``jax.random.choice`` with
  JAX's key): the chosen normal within 1e-6, d within 1e-6 and every
  hypothesis's inlier count equal (the point-plane product is XLA's
  FMA chain, ``neighbors._cross``);
- ``segment_plane`` end to end, where the port draws its own triples
  (a CPU ``torch.Generator``: torch cannot reproduce JAX's sampler):
  |cos| between the normals >= 0.9999 and inlier counts within 0.5%;
- clustering: labels, ``n_clusters`` and sizes equal to JAX's on the
  separated-blob fixtures of ``tests/test_segmentation.py`` and on
  masked, capped and size-filtered variants;
- the config's validation errors: the same type and message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from threecrate_tpu import PointCloud as JCloud  # noqa: E402
from threecrate_tpu.ops import segmentation as js  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import PointCloud as TCloud  # noqa: E402
from threecrate_tpu_torch.ops import segmentation as ts  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def plane_with_outliers(n_plane=500, n_out=50, seed=0):
    """``tests/test_segmentation.py``'s planted plane with outliers."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n_plane, 2))
    plane = np.stack([xy[:, 0], xy[:, 1], 0.002 * rng.normal(size=n_plane)], -1)
    outliers = rng.uniform(-2, 2, (n_out, 3)) + np.array([0, 0, 3.0])
    return np.concatenate([plane, outliers]).astype(np.float32)


def tilted_plane(seed=1, n=1500, noise=0.004, n_out=300):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=3)
    nrm /= np.linalg.norm(nrm)
    basis = np.linalg.svd(nrm[None])[2][1:]
    uv = rng.uniform(-3, 3, (n, 2))
    pts = uv @ basis + (0.5 + noise * rng.normal(size=(n, 1))) * nrm
    out = rng.uniform(-3, 3, (n_out, 3))
    return np.concatenate([pts, out]).astype(np.float32)


def two_planes(seed=2):
    """A floor with a smaller wall: the floor must win."""
    rng = np.random.default_rng(seed)
    floor = np.c_[rng.uniform(-4, 4, (2000, 2)), 0.01 * rng.normal(size=2000)]
    wall = np.c_[rng.uniform(-4, 4, 800), 2.0 + 0.01 * rng.normal(size=800),
                 rng.uniform(0, 3, 800)]
    return np.concatenate([floor, wall]).astype(np.float32)


SCENES = {"plane_with_outliers": (plane_with_outliers(2000, 300), 0.02),
          "tilted": (tilted_plane(), 0.02),
          "two_planes": (two_planes(), 0.05)}


def _clouds(pts, drop_every=0):
    """The JAX and CPU port clouds of ``pts``; with ``drop_every`` every
    such row is masked out (padding inside the valid range)."""
    jc = JCloud.from_numpy(pts)
    tc = TCloud.from_numpy(pts, capacity=jc.capacity, device="cpu")
    if drop_every:
        keep = np.arange(jc.capacity) % drop_every != 0
        jc = jc.with_mask(jc.mask & jnp.asarray(keep))
        tc = tc.with_mask(tc.mask & torch.from_numpy(keep))
    return jc, tc


def _jax_triples(jc, n_hyp, seed):
    probs = jc.mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return jax.random.choice(jax.random.PRNGKey(seed), jc.capacity, shape=(n_hyp, 3), p=probs)


def _jax_counts(jc, idx, thr):
    """Every hypothesis's count as JAX's ``_plane_ransac`` forms it."""
    tri = jc.points[idx]
    nrm = jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = jnp.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / jnp.maximum(nn, 1e-30)
    d = -jnp.sum(nrm * tri[:, 0], axis=1)
    inl = (jnp.abs(jc.points @ nrm.T + d[None, :]) <= thr) & jc.mask[:, None]
    return np.asarray(jnp.where(nn[:, 0] > 1e-12, jnp.sum(inl, axis=0), -1))


@pytest.mark.parametrize("drop_every", [0, 5])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scorer_fed_jax_triples_picks_jax_hypothesis(scene, drop_every):
    pts, thr = SCENES[scene]
    jc, tc = _clouds(pts, drop_every)
    for seed, n_hyp in ((0, 64), (3, 256)):
        idx = _jax_triples(jc, n_hyp, seed)
        jn, jd, jcount = js._plane_ransac(jax.random.PRNGKey(seed), jc.points, jc.mask,
                                          n_hyp, jnp.float32(thr))
        tn, td, tcount, counts = ts._plane_ransac(
            tc.points, tc.mask, torch.tensor(np.asarray(idx)).long(), thr)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
        np.testing.assert_allclose(td.item(), float(jd), atol=1e-6)
        assert tcount.item() == int(jcount)
        np.testing.assert_array_equal(counts.numpy(), _jax_counts(jc, idx, thr))


def test_scorer_chunks_do_not_change_counts(monkeypatch):
    pts, thr = SCENES["tilted"]
    _, tc = _clouds(pts)
    idx = ts._sample_triples(tc.mask, 128, 7)
    whole = ts._plane_ransac(tc.points, tc.mask, idx, thr)
    monkeypatch.setattr(ts, "_SCORE_ELEMENTS", 128 * 97)      # 97 rows a chunk
    chunked = ts._plane_ransac(tc.points, tc.mask, idx, thr)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_scorer_takes_the_first_of_tied_counts():
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5], [6, 5, 5], [5, 6, 5]],
                   np.float32)
    tc = TCloud.from_numpy(pts, device="cpu")
    idx = torch.tensor([[0, 0, 1], [3, 4, 5], [0, 1, 2]])      # collinear, then two ties
    nrm, d, count, counts = ts._plane_ransac(tc.points, tc.mask, idx, 0.01)
    assert counts.tolist() == [-1, 3, 3] and count.item() == 3
    torch.testing.assert_close(d, -(nrm * tc.points[3]).sum())   # the plane of row 1


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_segment_plane_matches_jax(scene, refine):
    pts, thr = SCENES[scene]
    jc, tc = _clouds(pts)
    jr = js.segment_plane(jc, thr, 256, seed=0, refine=refine)
    tr = ts.segment_plane(tc, thr, 256, seed=0, refine=refine)
    cos = abs(float(np.dot(tr.model.normal.numpy(), np.asarray(jr.model.normal))))
    assert cos >= 0.9999, cos
    assert abs(int(tr.inlier_count) - int(jr.inlier_count)) <= 0.005 * int(jr.inlier_count)
    assert int(tr.inlier_count) == tr.num_inliers == int(tr.inlier_mask.sum())
    assert tr.inlier_count.dtype == torch.int32
    assert ts.segment_plane_parallel is ts.segment_plane


def test_plane_result_surface_matches_jax():
    pts, thr = SCENES["plane_with_outliers"]
    jc, tc = _clouds(pts)
    jr = js.segment_plane(jc, thr, 256)
    tr = ts.segment_plane(tc, thr, 256)
    coef = tr.plane_coefficients()
    assert coef.dtype == np.float32 and coef.shape == (4,)
    np.testing.assert_allclose(np.abs(coef), np.abs(jr.plane_coefficients()), atol=1e-4)
    np.testing.assert_array_equal(tr.inlier_indices(), jr.inlier_indices())
    assert tr.num_inliers == jr.num_inliers
    np.testing.assert_array_equal(tr.inlier_cloud(tc).to_numpy(),
                                  np.asarray(jr.inlier_cloud(jc).to_numpy()))
    d = tr.model.distances(tc.points)
    np.testing.assert_allclose(d.numpy(), np.asarray(jr.model.distances(jc.points)), atol=1e-5)
    for negative in (False, True):
        te = ts.extract_plane(tc, tr, negative)
        je = js.extract_plane(jc, jr, negative)
        np.testing.assert_array_equal(te.mask.numpy(), np.asarray(je.mask))


def test_sampler_is_seeded_and_draws_valid_rows():
    pts, _ = SCENES["tilted"]
    _, tc = _clouds(pts, drop_every=3)
    a = ts._sample_triples(tc.mask, 500, 4)
    assert torch.equal(a, ts._sample_triples(tc.mask, 500, 4))
    assert not torch.equal(a, ts._sample_triples(tc.mask, 500, 5))
    assert a.shape == (500, 3) and a.dtype == torch.int64 and bool(tc.mask[a].all())


def test_too_few_points_raises_like_jax():
    with pytest.raises(Exception) as je:
        js.segment_plane(JCloud(jnp.zeros((2, 3)), jnp.ones((2,), bool), {}))
    with pytest.raises(Exception) as te:
        ts.segment_plane(TCloud(torch.zeros(2, 3), torch.ones(2, dtype=torch.bool), {}))
    assert type(te.value).__name__ == type(je.value).__name__ == "InvalidDataError"
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# euclidean clustering
# ---------------------------------------------------------------------------

def _blobs(seed=0):
    """``tests/test_segmentation.py``'s three separated blobs."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.05, (100, 3)) + [0, 0, 0]
    b = rng.normal(0, 0.05, (60, 3)) + [2, 0, 0]
    c = rng.normal(0, 0.05, (30, 3)) + [0, 2, 0]
    return np.concatenate([a, b, c]).astype(np.float32)


def _chain():
    xs = np.arange(100, dtype=np.float32) * 0.1
    return np.stack([xs, np.zeros(100), np.zeros(100)], -1).astype(np.float32)


def _many_blobs(seed=3):
    """Twelve blobs, some of equal size (ranking ties), with noise; near
    the origin, where the expanded d² of both packages' exact search
    rounds alike."""
    rng = np.random.default_rng(seed)
    sizes = [40, 25, 25, 60, 25, 12, 40, 8, 3, 25, 60, 1]
    parts = [rng.normal(0, 0.02, (s, 3)) + [0.8 * (i % 4) - 1.2, 0.8 * (i // 4) - 0.8, 0]
             for i, s in enumerate(sizes)]
    noise = rng.uniform(-1.2, 1.2, (30, 3)) + [0, 0, 2]
    return np.concatenate(parts + [noise]).astype(np.float32)


CLUSTER_CASES = {
    "blobs": (_blobs(), dict(tolerance=0.3, min_cluster_size=5), 0),
    "blobs_with_lone_point": (np.concatenate([_blobs(), [[10, 10, 10]]]).astype(np.float32),
                              dict(tolerance=0.3, min_cluster_size=5), 0),
    "chain": (_chain(), dict(tolerance=0.15), 0),
    "chain_masked": (_chain(), dict(tolerance=0.15), 7),
    "many_blobs": (_many_blobs(), dict(tolerance=0.12, min_cluster_size=5), 0),
    "many_blobs_max_size": (_many_blobs(), dict(tolerance=0.12, min_cluster_size=2,
                                                max_cluster_size=40), 0),
    "many_blobs_few_neighbours": (_many_blobs(), dict(tolerance=0.12, max_neighbors=4), 0),
    "many_blobs_masked": (_many_blobs(), dict(tolerance=0.12, min_cluster_size=3), 4),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_clusters_match_jax(case):
    pts, cfg, drop = CLUSTER_CASES[case]
    jc, tc = _clouds(pts, drop)
    jr = js.extract_euclidean_clusters(jc, js.EuclideanClusterConfig(**cfg))
    ts.reset_counts()
    tr = ts.extract_euclidean_clusters(tc, ts.EuclideanClusterConfig(**cfg))
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    assert int(tr.n_clusters) == int(jr.n_clusters)
    np.testing.assert_array_equal(tr.sizes.numpy(), np.asarray(jr.sizes))
    assert tr.labels.dtype == tr.sizes.dtype == tr.n_clusters.dtype == torch.int32
    assert ts.counts["iterations"] >= 1 and ts.counts["syncs"] == ts.counts["iterations"]
    for cid in range(int(tr.n_clusters)):
        np.testing.assert_array_equal(ts.cluster_indices(tr, cid), js.cluster_indices(jr, cid))


def test_chain_needs_many_propagation_rounds():
    """Pointer jumping halves a chain's depth twice an iteration, but the
    min-label step moves one hop: a 100-point chain takes several rounds,
    each with one host sync."""
    tc = TCloud.from_numpy(_chain(), device="cpu")
    ts.reset_counts()
    res = ts.extract_euclidean_clusters(tc, ts.EuclideanClusterConfig(tolerance=0.15))
    assert int(res.n_clusters) == 1 and int(res.sizes[0]) == 100
    assert ts.counts["iterations"] > 3 and ts.counts["syncs"] == ts.counts["iterations"]


CONFIG_ERRORS = [dict(tolerance=0.0), dict(tolerance=-1.0), dict(min_cluster_size=0),
                 dict(min_cluster_size=5, max_cluster_size=4), dict(max_neighbors=0)]


@pytest.mark.parametrize("kw", CONFIG_ERRORS, ids=lambda kw: "-".join(map(str, kw.items())))
def test_config_validation_matches_jax(kw):
    with pytest.raises(Exception) as je:
        js.EuclideanClusterConfig(**kw)
    with pytest.raises(Exception) as te:
        ts.EuclideanClusterConfig(**kw)
    assert type(te.value) is type(je.value) is ValueError
    assert str(te.value) == str(je.value)


def test_config_defaults_match_jax():
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(ts.EuclideanClusterConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(js.EuclideanClusterConfig)]


def test_root_names():
    """The root names are the module's, except ``segment_plane``, which is
    the reference-convention adapter of ``compat``, as the JAX package's
    root name is."""
    import threecrate_tpu as tc
    for name in ("ClusterResult", "EuclideanClusterConfig", "PlaneModel",
                 "PlaneSegmentationResult", "extract_euclidean_clusters", "extract_plane",
                 "segment_plane_parallel"):
        assert getattr(tt, name) is getattr(ts, name) and name in tt.__all__
    assert tt.segment_plane is tt.compat.segment_plane and "segment_plane" in tt.__all__
    assert tc.segment_plane.__module__ == "threecrate_tpu.compat"
