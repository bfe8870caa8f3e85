"""The sorted voxel-hash grid: the PyTorch port
(``threecrate_tpu_torch.ops.voxel_hash``) against the JAX package.

Both packages get the same padded clouds: ``TestVoxelHash``'s two
uniform clouds (``tests/test_registration.py``, the ``rng`` fixture's
seed) and one cloud with 30% of its rows masked out. Stated tolerance:
every integer field of the grid, and of ``lookup``, ``range_of`` and
``gather_neighbors``, equals JAX's exactly; the origin and cell size are
equal floats. ``perm`` is int64 in the port (int32 in JAX), the same
values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu import PointCloud  # noqa: E402
from threecrate_tpu.ops import voxel_hash as jv  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import voxel_hash as tv  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

FIELDS = ("origin", "dims", "cell", "sorted_keys", "perm", "unique_keys", "cell_starts",
          "cell_counts", "n_cells")


def _case(name):
    """(JAX cloud, port cloud, cell size)."""
    rng = np.random.default_rng(0)
    if name == "lookup":            # TestVoxelHash.test_lookup_roundtrip
        pts, cell, keep = rng.uniform(0, 4, (200, 3)).astype(np.float32), 1.0, None
    elif name == "gather":          # TestVoxelHash.test_gather_neighbors_covers_radius
        pts, cell, keep = rng.uniform(0, 3, (150, 3)).astype(np.float32), 0.5, None
    else:                           # masked rows, a negative origin
        pts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
        cell, keep = 0.7, rng.uniform(0, 1, 3000) < 0.7
    jc = PointCloud.from_numpy(pts)
    mask = np.asarray(jc.mask).copy()
    if keep is not None:
        mask[:len(keep)] &= keep
    tc = interop.cloud_from_numpy(np.asarray(jc.points), mask, device="cpu")
    return PointCloud(jc.points, jnp.asarray(mask), {}), tc, cell


def _grids(name):
    jc, tc, cell = _case(name)
    return (jc, jv.build_voxel_grid(jc.points, jc.mask, jnp.float32(cell)),
            tc, tv.build_voxel_grid(tc.points, tc.mask, cell))


CASES = ["lookup", "gather", "masked"]


@pytest.mark.parametrize("name", CASES)
def test_build_voxel_grid_matches_jax(name):
    _, gj, _, gt = _grids(name)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", CASES)
def test_lookup_and_range_match_jax(name):
    """Keys of the cloud's own points and of query points partly outside
    the grid (INVALID_KEY there)."""
    jc, gj, tc, gt = _grids(name)
    rng = np.random.default_rng(1)
    q = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    for jp, tp in ((jc.points, tc.points), (jnp.asarray(q), torch.from_numpy(q))):
        jk, tk = gj.key_of(jp), gt.key_of(tp)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        for jout, tout in zip((*gj.lookup(jk), *gj.range_of(jk)),
                              (*gt.lookup(tk), *gt.range_of(tk))):
            np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tv.INVALID_KEY == int(jv._INVALID_KEY)


@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_gather_neighbors_matches_jax(name, ring):
    jc, gj, tc, gt = _grids(name)
    ji, jvalid = gj.gather_neighbors(jc.points, cap_per_cell=8, ring=ring)
    ti, tvalid = gt.gather_neighbors(tc.points, cap_per_cell=8, ring=ring)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_gather_neighbors_covers_radius():
    """``TestVoxelHash``'s coverage property on the port alone: every
    point within one cell of a query is among its gathered candidates."""
    _, _, tc, gt = _grids("gather")
    idx, valid = gt.gather_neighbors(tc.points, cap_per_cell=32)
    pts = tc.points.numpy()[:150]
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    for q in range(0, 150, 17):
        assert set(np.nonzero(d2[q] <= 0.25)[0]) <= set(idx[q][valid[q]].tolist())
