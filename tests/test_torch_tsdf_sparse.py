"""Block-sparse TSDF fusion: the PyTorch port
(``threecrate_tpu_torch.ops.tsdf_sparse``) against the JAX package on the
same frames, on the CPU.

The inputs are ``tests/test_tsdf_sparse.py``'s: the wavy 120×160 frame
(noise from a numpy seed) fused from three poses into an 8³-block grid
of 8³ voxels, its ``max_blocks=8`` overflow case, the two frames of
``TestUpdateCompaction`` and the colour frame. Stated tolerances:
- ``n_blocks`` and ``block_keys`` equal (the lowest keys kept on
  overflow); weights equal; tsdf and colours within 1e-6;
- ``sparse_to_dense`` equal to JAX's arrays, and on the allocated voxels
  equal to the port's dense fusion (as the JAX test requires of JAX);
- surface points: count, mask and order equal, points within 1e-6 m;
- ``sparse_marching_cubes_soup``: mask and vertices bit-equal to JAX's;
  its welded mesh within JAX's own bounds of the dense mesh (face counts
  within 3%, > 95% of rounded vertices shared), and both meshes' counts
  equal to JAX's.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.core.transform import Transform as JaxTransform  # noqa: E402
from threecrate_tpu.ops import tsdf as jtsdf  # noqa: E402
from threecrate_tpu.ops import tsdf_sparse as jsp  # noqa: E402

from threecrate_tpu_torch.ops import tsdf as tt  # noqa: E402
from threecrate_tpu_torch.ops import tsdf_sparse as tsp  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

GRID = (8, 8, 8)     # 8^3 blocks of 8^3 voxels = 64^3 virtual
BLOCK = 8
VOX = 4.0 / 64
ORIGIN = (-2.0, -2.0, 0.5)


def _frame(seed=0, h=120, w=160):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 2.0 + 0.3 * np.sin(xx / 20.0) * np.cos(yy / 15.0)
    return ((base + 0.005 * rng.normal(0, 1, (h, w))).astype(np.float32),
            np.array([130.0, 130.0, w / 2, h / 2], np.float32))


def _poses(rotated=False):
    out = []
    for i in range(3):
        if rotated:
            p = np.asarray(JaxTransform.from_euler_xyz(
                jnp.asarray([0.01 * i, -0.02 * i, 0.015 * i], jnp.float32),
                jnp.asarray([0.02 * i, -0.01 * i, 0.03 * i], jnp.float32)).matrix)
        else:
            p = np.eye(4, dtype=np.float32)
            p[0, 3] = 0.02 * i
        out.append(p)
    return out


def _fuse(max_blocks=512, rotated=False, frames=3, **kw):
    depth, intr = _frame()
    jv = jsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=BLOCK,
                                  max_blocks=max_blocks)
    tv = tsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=BLOCK,
                                  max_blocks=max_blocks, device="cpu")
    for p in _poses(rotated)[:frames]:
        jv = jsp.sparse_integrate(jv, jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(p),
                                  grid_blocks=GRID, block=BLOCK, **kw)
        tv = tsp.sparse_integrate(tv, depth, intr, p, grid_blocks=GRID, block=BLOCK, **kw)
    return jv, tv


def _volumes_equal(jv, tv):
    assert int(tv.n_blocks) == int(jv.n_blocks)
    np.testing.assert_array_equal(tv.block_keys.numpy(), np.asarray(jv.block_keys))
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf), rtol=0, atol=1e-6)
    if jv.color is not None:
        np.testing.assert_allclose(tv.color.numpy(), np.asarray(jv.color), rtol=0, atol=1e-6)


@pytest.fixture(scope="module", params=[False, True], ids=["translated", "rotated"])
def fused(request):
    return _fuse(rotated=request.param)


def test_keys_and_tables_match_jax(fused):
    jv, tv = fused
    assert 0 < int(tv.n_blocks) < 512
    assert tv.block_keys.dtype == torch.int32 and tv.max_blocks == 512
    _volumes_equal(jv, tv)


def test_sparse_to_dense_matches_jax(fused):
    jv, tv = fused
    jd, td = jsp.sparse_to_dense(jv, GRID, BLOCK), tsp.sparse_to_dense(tv, GRID, BLOCK)
    assert td.resolution == (64, 64, 64)
    assert (td.weight > 0).sum().item() > 1000
    np.testing.assert_array_equal(td.weight.numpy(), np.asarray(jd.weight))
    np.testing.assert_allclose(td.tsdf.numpy(), np.asarray(jd.tsdf), rtol=0, atol=1e-6)


def test_allocated_interiors_match_port_dense():
    """tests/test_tsdf_sparse.py's parity, on the port: where the sparse
    volume has weight it equals the dense fusion, and it covers the
    dense band."""
    _, tv = _fuse()
    depth, intr = _frame()
    dense = tt.create_volume((64, 64, 64), VOX, origin=ORIGIN, device="cpu")
    for p in _poses():
        dense = tt.integrate(dense, depth, intr, p)
    td = tsp.sparse_to_dense(tv, GRID, BLOCK)
    m = td.weight > 0
    assert m.sum().item() > 1000
    np.testing.assert_allclose(td.tsdf[m].numpy(), dense.tsdf[m].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(td.weight[m].numpy(), dense.weight[m].numpy())
    band = (dense.tsdf.abs() < 0.5) & (dense.weight > 0)
    assert (td.weight[band] > 0).float().mean().item() > 0.98


def test_surface_points_match_jax(fused):
    jv, tv = fused
    js = jsp.sparse_extract_surface(jv, GRID, BLOCK)
    ts = tsp.sparse_extract_surface(tv, GRID, BLOCK)
    n = int(js.count)
    assert int(ts.count) == n > 500
    np.testing.assert_array_equal(ts.cloud.mask.numpy(), np.asarray(js.cloud.mask))
    np.testing.assert_allclose(ts.cloud.points.numpy()[:n], np.asarray(js.cloud.points)[:n],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_blocks", [8, 40])
def test_overflow_matches_jax(max_blocks):
    """The allocation overflows: n_blocks capped at the capacity and the
    lowest keys kept, as in JAX."""
    jv, tv = _fuse(max_blocks=max_blocks)
    assert int(tv.n_blocks) == max_blocks
    _volumes_equal(jv, tv)
    full = _fuse(max_blocks=512, frames=1)[1]
    assert torch.equal(tv.block_keys, full.block_keys[:max_blocks])


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.05])
def test_update_fraction_matches_jax(fraction):
    """TestUpdateCompaction's two frames: the band fits the cap at 0.5
    (the same volume as 1.0) and not at 0.05 (deferred rows), each equal
    to JAX's."""
    h, w = 48, 64
    intr = np.array([60.0, 60.0, w / 2 - 0.5, h / 2 - 0.5], np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = [(2.0 + 0.2 * np.sin(xx / 9.0)).astype(np.float32),
              (2.1 + 0.2 * np.cos(yy / 7.0)).astype(np.float32)]
    eye = np.eye(4, dtype=np.float32)
    jv = jsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=8, max_blocks=512)
    tv = tsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=8, max_blocks=512,
                                  device="cpu")
    for d in frames:
        jv = jsp.sparse_integrate(jv, jnp.asarray(d), jnp.asarray(intr), jnp.asarray(eye),
                                  grid_blocks=GRID, block=8, update_fraction=fraction)
        tv = tsp.sparse_integrate(tv, d, intr, eye, grid_blocks=GRID, block=8,
                                  update_fraction=fraction)
    _volumes_equal(jv, tv)
    ref = tsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=8,
                                   max_blocks=512, device="cpu")
    for d in frames:
        ref = tsp.sparse_integrate(ref, d, intr, eye, grid_blocks=GRID, block=8,
                                   update_fraction=1.0)
    assert torch.equal(ref.tsdf, tv.tsdf) == (fraction >= 0.5)


@pytest.mark.parametrize("key_range", [(0, 200), (150, 330)])
def test_key_range_matches_jax(key_range):
    """Allocation restricted to block keys in [lo, hi)."""
    jv, tv = _fuse(key_range=key_range)
    keys = tv.block_keys[:int(tv.n_blocks)]
    assert keys.numel() > 0
    assert ((keys >= key_range[0]) & (keys < key_range[1])).all()
    _volumes_equal(jv, tv)


def test_ray_samples_match_jax():
    """Five samples along each ray (jnp.linspace's fp32 offsets)."""
    jv, tv = _fuse(frames=1, ray_samples=5)
    _volumes_equal(jv, tv)
    np.testing.assert_array_equal(tsp._ray_offsets(5, "cpu").numpy(),
                                  np.asarray(jnp.linspace(-1.0, 1.0, 5)))


def test_color_matches_jax():
    depth, intr = _frame()
    rgb = np.random.default_rng(3).uniform(0, 1, depth.shape + (3,)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    jv = jsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=BLOCK,
                                  max_blocks=512, with_color=True)
    tv = tsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=BLOCK,
                                  max_blocks=512, with_color=True, device="cpu")
    for _ in range(2):
        jv = jsp.sparse_integrate(jv, jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(eye),
                                  grid_blocks=GRID, block=BLOCK, rgb=jnp.asarray(rgb))
        tv = tsp.sparse_integrate(tv, depth, intr, eye, grid_blocks=GRID, block=BLOCK, rgb=rgb)
    assert tv.color.shape == (512, 9 ** 3, 3)
    _volumes_equal(jv, tv)


def test_sequence_matches_loop_and_jax():
    depth, intr = _frame()
    depths = np.stack([depth] * 3)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 0.04, 3)
    kw = dict(voxel_size=VOX, origin=ORIGIN, grid_blocks=GRID, block=BLOCK, max_blocks=512)
    jv = jsp.sparse_integrate_sequence(jsp.create_sparse_volume(**kw), jnp.asarray(depths),
                                       jnp.asarray(intr), jnp.asarray(poses),
                                       grid_blocks=GRID, block=BLOCK)
    tv = tsp.sparse_integrate_sequence(tsp.create_sparse_volume(**kw, device="cpu"), depths,
                                       intr, poses, grid_blocks=GRID, block=BLOCK)
    loop = tsp.create_sparse_volume(**kw, device="cpu")
    for d, p in zip(depths, poses):
        loop = tsp.sparse_integrate(loop, d, intr, p, grid_blocks=GRID, block=BLOCK)
    _volumes_equal(jv, tv)
    assert torch.equal(loop.block_keys, tv.block_keys) and torch.equal(loop.tsdf, tv.tsdf)


def test_marching_cubes_is_left_for_the_next_slice():
    """The name is older than the port of marching cubes, which no longer
    raises: ``sparse_marching_cubes_soup`` on the one-frame volume equals
    the JAX package's soup bit for bit (mask and every vertex row)."""
    jv, tv = _fuse(frames=1)
    js = jsp.sparse_marching_cubes_soup(jv, GRID, BLOCK)
    ts = tsp.sparse_marching_cubes_soup(tv, GRID, BLOCK)
    assert ts.mask.shape == (512 * BLOCK ** 3 * 5,) and int(ts.mask.sum()) > 0
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.vertices.numpy(), np.asarray(js.vertices))


def test_sparse_mesh_matches_dense_mc():
    """JAX's ``TestSparseMarchingCubes.test_mesh_matches_dense_mc`` on the
    port, with its bounds: the welded sparse soup against marching cubes
    of the dense 64³ volume (unobserved voxels read as far): face counts
    within 3%, more than 95% of the vertices rounded to 1e-4 shared; and
    both port meshes with the JAX package's face and vertex counts."""
    mc = importlib.import_module("threecrate_tpu_torch.reconstruction.marching_cubes")
    jmc = importlib.import_module("threecrate_tpu.reconstruction.marching_cubes")
    depth, intr = _frame()
    eye = np.eye(4, dtype=np.float32)
    jv, tv = _fuse(frames=1)
    counts = []
    for dense_mod, sparse_vol, soup_fn, m in (
            (jtsdf, jv, jsp.sparse_marching_cubes_soup, jmc),
            (tt, tv, tsp.sparse_marching_cubes_soup, mc)):
        if m is jmc:
            dense = jtsdf.integrate(jtsdf.create_volume((64, 64, 64), VOX, origin=ORIGIN),
                                    jnp.asarray(depth), intr, jnp.asarray(eye))
            vals = jnp.asarray(np.where(np.asarray(dense.weight) >= 1.0,
                                        np.asarray(dense.tsdf), 1.0))
        else:
            dense = tt.integrate(tt.create_volume((64, 64, 64), VOX, origin=ORIGIN,
                                                  device="cpu"), depth, intr, eye)
            vals = torch.where(dense.weight >= 1.0, dense.tsdf, 1.0)
        g = m.VolumetricGrid(vals, dense.origin + 0.5 * dense.voxel_size, dense.voxel_size)
        mesh_d = m.marching_cubes(g, 0.0)
        mesh_s = m.soup_to_mesh(soup_fn(sparse_vol, GRID, BLOCK))
        fd, fs = int(mesh_d.face_count()), int(mesh_s.face_count())
        counts.append((fd, fs, int(mesh_d.vertex_count()), int(mesh_s.vertex_count())))
        if m is mc:
            assert fs > 0 and abs(fd - fs) <= 0.03 * max(fd, 1), (fd, fs)
            vd = mesh_d.vertices[:counts[-1][2]].numpy()
            vs = mesh_s.vertices[:counts[-1][3]].numpy()
            kd = set(map(tuple, vd.round(4).tolist()))
            ks = set(map(tuple, vs.round(4).tolist()))
            assert len(kd & ks) > 0.95 * max(len(kd), len(ks)), (len(kd), len(ks))
    assert counts[1] == counts[0], counts
