"""Marching cubes: the PyTorch port (``threecrate_tpu_torch.reconstruction
.marching_cubes``) against the JAX package on the same grids, on the CPU.

The grids are ``tests/test_reconstruction.py``'s: ``create_sphere_volume``
at 33³ and 38³, ``create_cube_volume(40)``, the anisotropic 30×30×28
field at iso 0.05 and the 17³ noise field, from the same numpy seeds.
Stated tolerances:
- the tables (``EDGE_CORNERS``, ``TRI_TABLE``, ``N_TRIS``, ``TRI_PACKED``
  and the tetrahedra tables) equal element for element;
- fixture values, ``extract_soup`` and ``extract_soup_cubes`` soups,
  banded and auto soups: mask and every vertex row bit-equal to JAX's
  (the same fp32 operations in the same order; the world coordinate is
  one fused multiply-add, as XLA forms it);
- banded = dense as triangle multisets (rounded to 5 decimals, as the
  JAX test compares them), the padded 38³ grid and the auto fallback
  included;
- host and device welds: vertices and faces equal to JAX's meshes;
- ``from_point_cloud``: origin and spacing equal, distances within
  2.5e-5 (measured 1.8e-5: the exact kNN's expanded d² differs from
  XLA's in the last bits near zero, where the square root magnifies it);
  ``reconstruct_marching_cubes``: vertex and face counts within 1%,
  every vertex within 0.01 voxel of the other mesh.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import make_sphere_points  # noqa: E402

import threecrate_tpu as jt  # noqa: E402
from threecrate_tpu.reconstruction import mc_tables as jtab  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch.reconstruction import mc_tables as ttab  # noqa: E402

# both packages' reconstruction/__init__ bind the name marching_cubes to
# the function, so the modules come by their full names
JM = importlib.import_module("threecrate_tpu.reconstruction.marching_cubes")
TM = importlib.import_module("threecrate_tpu_torch.reconstruction.marching_cubes")

torch.set_num_threads(2)   # the suite runs several workers per host


def _aniso():
    rng = np.random.default_rng(0)
    f = rng.normal(0, 1, (6, 5, 7)).astype(np.float32)
    return np.kron(f, np.ones((5, 6, 4), np.float32))   # (30, 30, 28)


def _noise():
    return np.random.default_rng(1).normal(0, 1, (17, 17, 17)).astype(np.float32)


def _jax_grid(name):
    if name == "sphere33":
        return JM.create_sphere_volume(33)
    if name == "sphere38":
        return JM.create_sphere_volume(38)
    if name == "cube40":
        return JM.create_cube_volume(40)
    vals = _aniso() if name == "aniso" else _noise()
    return JM.VolumetricGrid(jnp.asarray(vals), jnp.zeros(3), jnp.float32(0.1))


def _torch_grid(name):
    if name == "sphere33":
        return TM.create_sphere_volume(33, device="cpu")
    if name == "sphere38":
        return TM.create_sphere_volume(38, device="cpu")
    if name == "cube40":
        return TM.create_cube_volume(40, device="cpu")
    vals = _aniso() if name == "aniso" else _noise()
    return TM.VolumetricGrid(torch.from_numpy(vals), torch.zeros(3), torch.tensor(0.1))


ISO = {"sphere33": 0.0, "sphere38": 0.0, "cube40": 0.0, "aniso": 0.05, "noise": 0.0}
SOUP_GRIDS = ("sphere33", "cube40", "aniso", "noise")


@pytest.fixture(scope="module")
def grids():
    return {n: (_jax_grid(n), _torch_grid(n)) for n in ISO}


@pytest.fixture(scope="module")
def dense_soups(grids):
    """(JAX soup, port soup) of extract_soup_cubes per grid."""
    return {n: (JM.extract_soup_cubes(jg, jnp.float32(ISO[n])),
                TM.extract_soup_cubes(tg, ISO[n])) for n, (jg, tg) in grids.items()}


def _soup_equal(js, ts):
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.vertices.numpy(), np.asarray(js.vertices))


def _soup_set(soup):
    """The soup's live triangles as a sorted multiset (JAX's
    ``TestBandedMarchingCubes._soup_set``)."""
    tri = soup.vertices.numpy().reshape(-1, 3, 3)[soup.mask.numpy()]
    return np.sort(np.ascontiguousarray(tri.round(5).reshape(-1, 9)).view(
        [("", np.float32)] * 9), axis=None)


def test_tables_equal_jax():
    for name in ("EDGE_CORNERS", "TRI_TABLE", "N_TRIS", "TRI_PACKED"):
        np.testing.assert_array_equal(getattr(ttab, name), getattr(jtab, name))
        assert getattr(ttab, name).dtype == getattr(jtab, name).dtype
    assert ttab.EDGES == jtab.EDGES
    for name in ("_TET_EDGES", "_MT_TRIS", "_CUBE_TETS", "_CORNER_OFFSET"):
        np.testing.assert_array_equal(getattr(TM, name), getattr(JM, name))


@pytest.mark.parametrize("name", ["sphere33", "sphere38", "cube40"])
def test_fixture_volumes_equal_jax(grids, name):
    jg, tg = grids[name]
    np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert tg.spacing.item() == float(jg.spacing)
    assert tg.resolution == tuple(jg.resolution)


@pytest.mark.parametrize("name", SOUP_GRIDS)
def test_cubes_soup_bit_equal(dense_soups, name):
    _soup_equal(*dense_soups[name])


@pytest.mark.parametrize("name", SOUP_GRIDS)
def test_tetrahedra_soup_bit_equal(grids, name):
    jg, tg = grids[name]
    _soup_equal(JM.extract_soup(jg, jnp.float32(ISO[name])), TM.extract_soup(tg, ISO[name]))


def test_index_offset_shifts_by_whole_cubes(grids):
    jg, tg = grids["aniso"]
    off = (8, 16, 0)
    _soup_equal(JM.extract_soup_cubes(jg, jnp.float32(0.05), index_offset=jnp.asarray(off)),
                TM.extract_soup_cubes(tg, 0.05, index_offset=off))


@pytest.mark.parametrize("name", ["sphere33", "sphere38", "aniso"])
def test_banded_equals_dense_and_jax(grids, dense_soups, name):
    jg, tg = grids[name]
    tb = TM.extract_soup_cubes_banded(tg, ISO[name], block=8, max_blocks=4096)
    a, b = _soup_set(dense_soups[name][1]), _soup_set(tb)
    assert a.shape == b.shape and (a == b).all()
    _soup_equal(JM.extract_soup_cubes_banded(jg, jnp.float32(ISO[name]), block=8,
                                             max_blocks=4096), tb)


@pytest.mark.parametrize("name", ["noise", "cube40"])
def test_auto_equals_dense_and_jax(grids, dense_soups, name):
    """The 17³ noise field crosses nearly every block (the dense fallback);
    the cube SDF takes the banded path with a sized cap."""
    jg, tg = grids[name]
    ta = TM.extract_soup_cubes_auto(tg)
    a, b = _soup_set(dense_soups[name][1]), _soup_set(ta)
    assert a.shape == b.shape and (a == b).all()
    _soup_equal(JM.extract_soup_cubes_auto(jg), ta)
    n_act = TM._block_active_count(tg.values, 0.0)
    assert n_act.dtype == torch.int32
    assert int(n_act) == int(JM._block_active_count(jg.values, jnp.float32(0.0)))


def test_banded_cap_drops_blocks_past_it(grids):
    """A cap below the active count keeps the lowest block ids, as JAX's."""
    jg, tg = grids["sphere33"]
    _soup_equal(JM.extract_soup_cubes_banded(jg, jnp.float32(0.0), block=8, max_blocks=16),
                TM.extract_soup_cubes_banded(tg, 0.0, block=8, max_blocks=16))


@pytest.mark.parametrize("method", ["host", "device"])
@pytest.mark.parametrize("name", ["sphere33", "cube40"])
def test_welds_equal_jax(dense_soups, name, method):
    js, ts = dense_soups[name]
    jv, jf = JM.soup_to_mesh(js, method=method).to_numpy()
    mesh = TM.soup_to_mesh(ts, method=method)
    tv, tf = mesh.to_numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert mesh.vertices.device.type == "cpu"


def test_device_weld_matches_host(dense_soups):
    """JAX's TestDeviceWeld on the port: same counts, same rounded
    triangle multiset."""
    ts = dense_soups["sphere33"][1]
    tris = []
    for method in ("host", "device"):
        v, f = TM.soup_to_mesh(ts, method=method).to_numpy()
        tris.append(np.sort(np.ascontiguousarray(v[f].round(5).reshape(-1, 9)).view(
            [("", np.float32)] * 9), axis=None))
    assert tris[0].shape == tris[1].shape and (tris[0] == tris[1]).all()


def test_device_weld_counts_and_empty():
    g = TM.VolumetricGrid(torch.ones((8, 8, 8)), torch.zeros(3), torch.tensor(0.1))
    soup = TM.extract_soup_cubes(g, 0.0)
    assert int(TM.soup_to_mesh(soup, method="device").face_count()) == 0
    assert int(TM.soup_to_mesh(soup, method="host").face_count()) == 0
    with pytest.raises(ValueError, match="unknown weld method"):
        TM.soup_to_mesh(soup, method="gpu")


@pytest.mark.parametrize("method", ["cubes", "tetrahedra"])
def test_marching_cubes_entry_equals_jax(grids, method):
    jg, tg = grids["sphere38"]
    jv, jf = JM.marching_cubes(jg, 0.0, method=method).to_numpy()
    tv, tf = TM.marching_cubes(tg, 0.0, method=method).to_numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


SHELL_RES = 32   # from_point_cloud and reconstruct_marching_cubes share one kNN shape


@pytest.fixture(scope="module")
def shell_cloud():
    pts = make_sphere_points(3000)
    return (jt.PointCloud.from_numpy(pts), tt.PointCloud.from_numpy(pts, device="cpu"))


def test_from_point_cloud_matches_jax(shell_cloud):
    jpc, tpc = shell_cloud
    jg = JM.VolumetricGrid.from_point_cloud(jpc, (SHELL_RES,) * 3)
    tg = TM.VolumetricGrid.from_point_cloud(tpc, (SHELL_RES,) * 3)
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert tg.spacing.item() == float(jg.spacing)
    np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg.values), rtol=0, atol=2.5e-5)


def test_reconstruct_marching_cubes_matches_jax(shell_cloud):
    jpc, tpc = shell_cloud
    jv, jf = JM.reconstruct_marching_cubes(jpc, resolution=SHELL_RES).to_numpy()
    tv, tf = TM.reconstruct_marching_cubes(tpc, resolution=SHELL_RES).to_numpy()
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv)
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    voxel = 2.2 / (SHELL_RES - 1)   # the sphere's bounding box, padded 5% a side
    for a, b in ((tv, jv), (jv, tv)):
        assert _nearest(a, b).max() <= 0.01 * voxel
    r = np.linalg.norm(tv, axis=1)
    assert len(tf) > 500 and 0.8 < np.median(r) < 1.2


def _nearest(a, b, chunk=2048):
    """Distance from each row of ``a`` to its nearest row of ``b``."""
    bt = torch.from_numpy(b).double()
    out = [torch.cdist(torch.from_numpy(a[i:i + chunk]).double(), bt).min(1).values
           for i in range(0, len(a), chunk)]
    return torch.cat(out).numpy()
