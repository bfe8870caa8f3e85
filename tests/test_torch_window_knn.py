"""The window kNN family: the PyTorch port against the JAX package.

On the CPU ``knn_window_tiles`` runs its plain PyTorch version; the
Pallas kernel runs in interpret mode, as tests/test_kernels.py runs it.
The kernel tests give both sides the same sorted arrays. Module tests
give both sides the same points; ``knn_window`` is called on the JAX
side with ``backend="pallas"`` (on the CPU its "auto" takes an XLA
branch with wrap-around windows, where the port takes the kernel, as
the JAX package does on its TPU), ``knn_window_sorted`` and
``knn_window_cross`` always run the Pallas kernel. ``lax.sort`` is not
documented as stable, but on XLA:CPU it keeps tied Morton keys in input
order, as the port's stable sort does: ``knn_window_sorted``'s
permutations are compared exactly on a scan with tied keys.

Stated tolerances (XLA:CPU contracts the reference's d² into FMAs, so
the last bit of −d² can differ and near-ties can swap):
* kernel: −d² within 1e-6 relative (−inf exactly where −inf; 80-96% of
  slots are bit-equal on these fixtures), ids and coordinates equal in
  every slot whose distance is more than 1e-6 relative from its
  neighbours' in the list, and in every −inf slot;
* module searches: distances within 1e-6 relative (and 1e-12 absolute),
  validity equal, ids equal wherever the distance is distinct as above;
* ``radius_neighbors_window`` against the JAX "auto" (XLA) branch: the
  in-radius neighbour sets equal on >= 99% of points (the XLA branch's
  first and last tiles also see the tiles across the wrap), distances
  of equal sets within 1e-6 relative;
* ``_merge_topk``: exact equality, ties and duplicate ids included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.kernels.knn_pallas import knn_window_tiles as pallas_knn  # noqa: E402
from threecrate_tpu.ops import neighbors as jn  # noqa: E402

from threecrate_tpu_torch import kernels  # noqa: E402
from threecrate_tpu_torch.kernels import _build  # noqa: E402
from threecrate_tpu_torch.kernels.knn_window import (  # noqa: E402
    knn_window_plain, knn_window_tiles)
from threecrate_tpu_torch.ops import neighbors as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

REL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _distinct(neg):
    """Slots whose −d² is more than REL from both list neighbours'."""
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(neg, axis=-1)) > REL * np.maximum(
            np.abs(neg[..., 1:]), np.abs(neg[..., :-1])) + 1e-12
    ok = np.isfinite(neg)
    ok[..., 1:] &= gap
    ok[..., :-1] &= gap
    return ok


def _assert_neg_close(got, ref):
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=REL, atol=1e-12)


def _kernel_case(seed=0, n_tiles=9, tile=128):
    """Sorted-order inputs: clustered points with exact duplicates, an
    invalid padded tail, and tiles 3-5 holding 5 valid points in all (so
    tile 4's queries have fewer valid candidates than k)."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile
    pts = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0).astype(np.float32)
    pts[10:14] = pts[10]                    # forced ties
    pts[n // 2:n // 2 + 2] = pts[n // 2]
    valid = np.ones((1, n), np.float32)
    valid[0, -100:] = 0
    if n_tiles >= 6:
        valid[0, 3 * tile:6 * tile] = 0
        valid[0, [3 * tile + 5, 4 * tile, 4 * tile + 9, 5 * tile + 1, 5 * tile + 100]] = 1
    ids = rng.permutation(n).astype(np.int32)[None]
    return pts.T.copy(), valid, ids, tile


@pytest.mark.parametrize("k,with_coords,exclude_self",
                         [(1, False, False), (4, True, False), (10, False, True),
                          (64, True, True)])
def test_knn_window_kernel_matches_pallas(k, with_coords, exclude_self):
    pts, valid, ids, tile = _kernel_case()
    ref = [np.asarray(a) for a in pallas_knn(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(ids), k, tile,
        interpret=True, with_coords=with_coords, exclude_self=exclude_self)]
    got = [a.numpy() for a in knn_window_tiles(_t(pts), _t(valid), _t(ids), k, tile,
                                               with_coords=with_coords,
                                               exclude_self=exclude_self)]
    assert len(got) == len(ref) == (3 if with_coords else 2)
    assert got[0].shape == (k, pts.shape[1]) and got[1].dtype == np.int32
    _assert_neg_close(got[0], ref[0])
    same = _distinct(ref[0].T).T | ~np.isfinite(ref[0])
    np.testing.assert_array_equal(got[1][same], ref[1][same])
    if with_coords:
        sel = np.repeat(same, 3, axis=0)
        np.testing.assert_array_equal(got[2][sel], ref[2][sel])
    if k >= 10:                                  # tile 4 reached the -inf slots
        assert np.isinf(got[0][:, 4 * tile:5 * tile]).any()
    if exclude_self:
        fin = np.isfinite(got[0])
        assert not (got[1] == ids)[fin].any()


def test_knn_window_plain_is_a_stable_sort():
    """An oracle check of the plain version: the k best window columns
    by (−d² descending, column ascending), −inf slots on column 0."""
    pts, valid, ids, tile = _kernel_case(seed=1, n_tiles=3)
    neg, idx, crd = knn_window_plain(_t(pts), _t(valid), _t(ids), 6, tile, with_coords=True)
    q = pts[:, tile + 7]                      # a query in the middle tile
    d2 = ((pts - q[:, None]) ** 2).sum(0)
    order = np.argsort(np.where(valid[0] > 0.5, d2, np.inf), kind="stable")[:6]
    np.testing.assert_array_equal(idx.numpy()[:, tile + 7], ids[0, order])
    np.testing.assert_array_equal(crd.numpy()[:, tile + 7].reshape(6, 3), pts[:, order].T)
    # nothing valid: every slot is window column 0, the first column of
    # the prev tile, and tile 0's prev tile is tile 0 itself
    neg0, idx0 = knn_window_plain(_t(pts), _t(np.zeros_like(valid)), _t(ids), 3, tile)
    first = ids[0, np.maximum(np.arange(3 * tile) // tile - 1, 0) * tile]
    assert np.isinf(neg0.numpy()).all()
    np.testing.assert_array_equal(idx0.numpy(), np.broadcast_to(first, (3, 3 * tile)))


def test_knn_window_wrappers_refuse_bad_inputs():
    pts, valid, ids, tile = _kernel_case(n_tiles=2)
    with pytest.raises(ValueError, match="128"):
        knn_window_tiles(_t(pts), _t(valid), _t(ids), 129, tile)
    with pytest.raises(ValueError, match="3·tile"):
        knn_window_tiles(_t(pts[:, :64]), _t(valid[:, :64]), _t(ids[:, :64]), 100, 16)
    with pytest.raises(ValueError):
        knn_window_tiles(_t(pts), _t(valid), _t(ids), 4, 96)       # not a power of two
    with pytest.raises(TypeError):
        knn_window_tiles(_t(pts), _t(valid), _t(ids.astype(np.int64)), 4, tile)


def test_cpu_calls_never_build_or_count(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call tried to build the kernels")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "lib", no_build)
    kernels.reset_launch_counts()
    pts = np.random.default_rng(2).uniform(0, 1, (700, 3)).astype(np.float32)
    tn.knn_window(_t(pts), torch.ones(700, dtype=torch.bool), 5, tile=128)
    tn.knn_window_sorted(_t(pts), torch.ones(700, dtype=torch.bool), 5)
    assert not any(kernels.launch_counts().values())


# ------------------------------------------------------------ _merge_topk


def _merge_case(rng, n, ka, kb, with_pts):
    """Best-first lists with integer-valued (tied) values, −inf holes and
    ids drawn from a small range (duplicates within and across lists)."""
    def lst(kk):
        v = -rng.integers(0, 6, (n, kk)).astype(np.float32)
        v[rng.uniform(size=(n, kk)) < 0.2] = -np.inf
        return -np.sort(-v, 1), rng.integers(0, 12, (n, kk)).astype(np.int32)

    (na, ia), (nb, ib) = lst(ka), lst(kb)
    pa = rng.normal(0, 1, (n, ka, 3)).astype(np.float32) if with_pts else None
    pb = rng.normal(0, 1, (n, kb, 3)).astype(np.float32) if with_pts else None
    return na, ia, nb, ib, pa, pb


@pytest.mark.parametrize("ka,kb,k,with_pts", [(4, 4, 4, False), (10, 10, 10, True),
                                              (3, 8, 8, False), (64, 64, 64, False)])
def test_merge_topk_equals_jax(ka, kb, k, with_pts):
    rng = np.random.default_rng(ka * 100 + kb)
    na, ia, nb, ib, pa, pb = _merge_case(rng, 300, ka, kb, with_pts)
    extra = (jnp.asarray(pa), jnp.asarray(pb)) if with_pts else ()
    ref = jn._merge_topk(jnp.asarray(na), jnp.asarray(ia), jnp.asarray(nb),
                         jnp.asarray(ib), k, *extra)
    got = tn._merge_topk(_t(na), _t(ia), _t(nb), _t(ib), k,
                         *((_t(pa), _t(pb)) if with_pts else ()))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert np.isinf(got[0].numpy()).any()          # unfilled slots were exercised


def test_merge_topk_row_chunks(monkeypatch):
    """Chunking the rows changes nothing."""
    rng = np.random.default_rng(9)
    na, ia, nb, ib, pa, pb = _merge_case(rng, 250, 6, 6, True)
    args = (_t(na), _t(ia), _t(nb), _t(ib), 6, _t(pa), _t(pb))
    whole = tn._merge_topk(*args)
    monkeypatch.setattr(tn, "_MERGE_ROWS", 7)
    for a, b in zip(tn._merge_topk(*args), whole):
        assert torch.equal(a, b)


# ------------------------------------------------------------ modules


def _cloud(n, seed, n_invalid=0):
    """A scan-like cloud (with tied Morton keys) and an invalid tail."""
    from bench import _kitti_like
    pts = _kitti_like(n, seed)
    mask = np.ones(n, bool)
    if n_invalid:
        mask[-n_invalid:] = False
    return pts, mask


def _assert_results_close(got, ref):
    gd, rd = got.distances.numpy(), np.asarray(ref.distances)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    _assert_neg_close(-gd ** 2, -rd ** 2)
    same = _distinct(-rd ** 2)
    np.testing.assert_array_equal(got.indices.numpy()[same], np.asarray(ref.indices)[same])


@pytest.mark.parametrize("k,exclude_self", [(8, False), (6, True)])
def test_knn_window_matches_jax_pallas_branch(k, exclude_self):
    pts, mask = _cloud(3000, 0, n_invalid=40)
    ref = jn.knn_window(jnp.asarray(pts), jnp.asarray(mask), k, tile=128,
                        exclude_self=exclude_self, backend="pallas")
    got = tn.knn_window(_t(pts), _t(mask), k, tile=128, exclude_self=exclude_self)
    _assert_results_close(got, ref)
    assert got.indices.dtype == torch.int64
    assert got.mask.numpy()[:2960].mean() > 0.99


def test_knn_window_return_points():
    pts, mask = _cloud(1500, 1)
    ref, ref_pts = jn.knn_window(jnp.asarray(pts), jnp.asarray(mask), 5, tile=128,
                                 return_points=True, backend="pallas")
    got, got_pts = tn.knn_window(_t(pts), _t(mask), 5, tile=128, return_points=True)
    _assert_results_close(got, ref)
    m = got.mask.numpy()
    np.testing.assert_array_equal(got_pts.numpy()[m], pts[got.indices.numpy()][m])
    with pytest.raises(ValueError, match="window=1"):
        tn.knn_window(_t(pts), _t(mask), 5, window=2, return_points=True)


@pytest.mark.parametrize("window", [1, 2])
def test_knn_window_tensor_branch_matches_jax_xla(window):
    """backend="xla" (and any window != 1): the kernel-free search with
    wrap-around windows and an exact top-k, as JAX's XLA branch."""
    pts, mask = _cloud(2000, 2, n_invalid=30)
    ref = jn.knn_window(jnp.asarray(pts), jnp.asarray(mask), 6, tile=128, window=window,
                        recall_target=1.0, exclude_self=True, backend="xla")
    got = tn.knn_window(_t(pts), _t(mask), 6, tile=128, window=window,
                        exclude_self=True, backend="xla")
    _assert_results_close(got, ref)


def test_knn_window_sorted_matches_jax():
    pts, mask = _cloud(3000, 3, n_invalid=25)
    ref = jn.knn_window_sorted(jnp.asarray(pts), jnp.asarray(mask), 9, tile=128)
    got = tn.knn_window_sorted(_t(pts), _t(mask), 9, tile=128)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))      # perm_a
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))      # sorted points
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))      # sorted mask
    rn, gn = np.asarray(ref[0]), got[0].numpy()
    _assert_neg_close(gn, rn)
    same = _distinct(rn)
    np.testing.assert_array_equal(got[1].numpy()[same], np.asarray(ref[1])[same])


@pytest.mark.parametrize("k", [1, 3])
def test_knn_window_cross_matches_jax(k):
    rng = np.random.default_rng(5)
    db = rng.normal(0, 1, (900, 3)).astype(np.float32)
    q = rng.normal(0, 1, (500, 3)).astype(np.float32)
    dm, qm = np.ones(900, bool), np.ones(500, bool)
    dm[::17] = False
    qm[::23] = False
    ref = jn.knn_window_cross(jnp.asarray(db), jnp.asarray(dm), jnp.asarray(q),
                              jnp.asarray(qm), k, tile=128)
    got = tn.knn_window_cross(_t(db), _t(dm), _t(q), _t(qm), k, tile=128)
    _assert_results_close(got, ref)
    d2 = ((q[:, None] - db[None]) ** 2).sum(-1)
    exact = np.sqrt(np.where(dm[None], d2, np.inf).min(1))
    assert np.isclose(got.distances.numpy()[qm, 0], exact[qm], rtol=1e-4).mean() > 0.97


def test_radius_neighbors_window_matches_jax():
    pts, mask = _cloud(4000, 4, n_invalid=50)
    ref = jn.radius_neighbors_window(jnp.asarray(pts), jnp.asarray(mask), 1.5, 16,
                                     exclude_self=True)
    got = tn.radius_neighbors_window(_t(pts), _t(mask), 1.5, 16, exclude_self=True)
    gm, rm = got.mask.numpy(), np.asarray(ref.mask)
    gi, ri = got.indices.numpy(), np.asarray(ref.indices)
    same = np.array([set(gi[i][gm[i]]) == set(ri[i][rm[i]]) for i in range(len(gm))])
    assert same.mean() >= 0.99, same.mean()
    assert gm.sum(1).mean() > 3                     # real neighbourhoods
    g = np.sort(np.where(gm, got.distances.numpy(), np.inf), 1)[same]
    r = np.sort(np.where(rm, np.asarray(ref.distances), np.inf), 1)[same]
    np.testing.assert_allclose(g, r, rtol=REL)
    assert (got.distances.numpy()[gm] <= np.float32(1.5)).all()
    assert not (gi == np.arange(4000)[:, None])[gm].any()
