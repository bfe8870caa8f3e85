"""Dense TSDF fusion and surface extraction: the PyTorch port
(``threecrate_tpu_torch.ops.tsdf``) against the JAX package on the same
frames and volumes, on the CPU.

The inputs are the JAX tests' own: ``tests/test_tsdf_sparse.py``'s wavy
120×160 frame (noise from a numpy seed) fused from three poses,
``tests/test_mesh_ops.py``'s flat walls, colour frame, sequence and
analytic sphere field. Stated tolerances:
- fusion: weights equal and tsdf within 1e-6 on every voxel (the port
  forms each voxel's pixel coordinate as one fused multiply-add, as XLA
  does, so both pick the same pixels; on the rotated pose
  ``PIXEL_SHARE`` of the voxels, see ``test_integrate_matches_jax``);
  colours within 1e-6;
- extraction: the count, the mask and the order of the points equal,
  the points within 1e-6 m; banded against dense in the port bit for
  bit, as the JAX test requires of JAX;
- ``integrate_cloud``: weights equal, tsdf within 1e-4 (the kNN
  distance's fp32 cancellation: 2.0e-5 measured).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu import PointCloud as JaxCloud  # noqa: E402
from threecrate_tpu.core.transform import Transform as JaxTransform  # noqa: E402
from threecrate_tpu.ops import tsdf as jt  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import tsdf as tt  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

VOX = 4.0 / 64
ORIGIN = (-2.0, -2.0, 0.5)
# on a rotated pose the voxel's camera coordinates come from a 3x3
# product whose summation XLA and PyTorch order differently, so a voxel
# within an ulp of a pixel edge may pick the neighbouring pixel
PIXEL_SHARE = 0.9995


def _frame(seed=0, h=120, w=160):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 2.0 + 0.3 * np.sin(xx / 20.0) * np.cos(yy / 15.0)
    return ((base + 0.005 * rng.normal(0, 1, (h, w))).astype(np.float32),
            np.array([130.0, 130.0, w / 2, h / 2], np.float32))


def _poses(kind):
    out = []
    for i in range(3):
        if kind == "translated":
            p = np.eye(4, dtype=np.float32)
            p[0, 3] = 0.02 * i
        else:
            p = np.asarray(JaxTransform.from_euler_xyz(
                jnp.asarray([0.01 * i, -0.02 * i, 0.015 * i], jnp.float32),
                jnp.asarray([0.02 * i, -0.01 * i, 0.03 * i], jnp.float32)).matrix)
        out.append(p)
    return out


def _port(vol):
    return interop.tsdf_volume_from_numpy(
        *(None if x is None else np.asarray(x) for x in vol), device="cpu")


@pytest.fixture(scope="module", params=["translated", "rotated"])
def fused(request):
    """(JAX volume, port volume) after three frames from ``request.param``
    poses, each package fusing on its own."""
    depth, intr = _frame()
    jv = jt.create_volume((64, 64, 64), VOX, origin=ORIGIN)
    tv = tt.create_volume((64, 64, 64), VOX, origin=ORIGIN, device="cpu")
    for p in _poses(request.param):
        jv = jt.integrate(jv, jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(p))
        tv = tt.integrate(tv, depth, intr, p)
    return request.param, jv, tv


def _surface_equal(js, ts):
    assert int(js.count) == int(ts.count)
    np.testing.assert_array_equal(ts.cloud.mask.numpy(), np.asarray(js.cloud.mask))
    n = int(js.count)
    np.testing.assert_allclose(ts.cloud.points.numpy()[:n], np.asarray(js.cloud.points)[:n],
                               rtol=0, atol=1e-6)


def test_integrate_matches_jax(fused):
    """Measured on the rotated poses: weights equal on every voxel here
    too; the gate allows PIXEL_SHARE."""
    kind, jv, tv = fused
    jw, tw = np.asarray(jv.weight), tv.weight.numpy()
    same = jw == tw
    assert jw.sum() > 10_000
    if kind == "translated":
        assert same.all()
    else:
        assert same.mean() >= PIXEL_SHARE
    np.testing.assert_allclose(tv.tsdf.numpy()[same], np.asarray(jv.tsdf)[same], rtol=0,
                               atol=1e-6)
    assert tv.resolution == (64, 64, 64) and tv.color is None
    assert tv.truncation.item() == pytest.approx(4 * VOX)


def test_extract_surface_matches_jax(fused):
    """Each package's own volume, and JAX's volume through ``interop``."""
    kind, jv, tv = fused
    js, ts = jt.extract_surface(jv), tt.extract_surface(tv)
    assert int(ts.count) > 1000
    assert ts.cloud.points.shape == (3 * 64 ** 3, 3)
    if kind == "translated":
        _surface_equal(js, ts)
    _surface_equal(js, tt.extract_surface(_port(jv)))


def test_banded_auto_matches_jax_and_dense(fused):
    _, jv, tv = fused
    jb, tb = jt.extract_surface_banded_auto(jv), tt.extract_surface_banded_auto(_port(jv))
    assert tb.cloud.points.shape == jb.cloud.points.shape
    _surface_equal(jb, tb)
    assert int(tt._surface_active_count(_port(jv))) == int(jt._surface_active_count(jv))
    # the port's banded points are its dense points, bit for bit
    td, tb = tt.extract_surface(tv), tt.extract_surface_banded_auto(tv)
    assert int(td.count) == int(tb.count)
    qd = td.cloud.points[td.cloud.mask].numpy()
    qb = tb.cloud.points[tb.cloud.mask].numpy()
    assert np.array_equal(qd[np.lexsort(qd.T)], qb[np.lexsort(qb.T)])


def _sphere_field():
    vol = jt.create_volume((48, 48, 48), voxel_size=0.05, origin=(-1.2, -1.2, -1.2))
    ax = (np.arange(48) + 0.5) * 0.05 - 1.2
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.sqrt(x * x + y * y + z * z) - 0.8
    t = np.clip(sdf / float(vol.truncation), -1, 1).astype(np.float32)
    w = (np.abs(sdf) < 0.5).astype(np.float32) * 2.0
    return vol._replace(tsdf=jnp.asarray(t), weight=jnp.asarray(w))


@pytest.mark.parametrize("max_blocks", [64, 256, 4096])
def test_banded_sphere_matches_jax(max_blocks):
    """tests/test_mesh_ops.py's sphere field: the banded extraction at a
    cap below, near and above the active count equals JAX's, point for
    point and in order; above it, it equals the port's dense sweep."""
    jv = _sphere_field()
    tv = _port(jv)
    jb = jt.extract_surface_banded(jv, max_blocks=max_blocks)
    tb = tt.extract_surface_banded(tv, max_blocks=max_blocks)
    _surface_equal(jb, tb)
    if max_blocks == 4096:
        td = tt.extract_surface(tv)
        assert int(td.count) == int(tb.count) > 1000


def test_banded_dense_fallback_matches_jax():
    rng = np.random.default_rng(0)
    vol = jt.create_volume((16, 16, 16), voxel_size=0.1)
    vol = vol._replace(tsdf=jnp.asarray(rng.normal(size=(16, 16, 16)).astype(np.float32)),
                       weight=jnp.ones((16, 16, 16), jnp.float32))
    jb, tb = jt.extract_surface_banded_auto(vol), tt.extract_surface_banded_auto(_port(vol))
    assert tb.cloud.points.shape == jb.cloud.points.shape == (3 * 16 ** 3, 3)
    _surface_equal(jb, tb)


def test_color_and_max_weight_match_jax():
    """Colour fusion over three frames with ``max_weight=2``: weights
    capped at 2 as in JAX, colours within 1e-6."""
    depth, intr = _frame(1, 60, 80)
    intr = np.array([65.0, 65.0, 39.5, 29.5], np.float32)
    rgb = np.random.default_rng(3).uniform(0, 1, depth.shape + (3,)).astype(np.float32)
    jv = jt.create_volume((32, 32, 32), 0.125, origin=ORIGIN, with_color=True)
    tv = tt.create_volume((32, 32, 32), 0.125, origin=ORIGIN, with_color=True, device="cpu")
    for p in _poses("translated"):
        jv = jt.integrate(jv, jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(p),
                          rgb=jnp.asarray(rgb), max_weight=2.0)
        tv = tt.integrate(tv, depth, intr, p, rgb=rgb, max_weight=2.0)
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))
    assert tv.weight.max().item() == 2.0
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.color.numpy(), np.asarray(jv.color), rtol=0, atol=1e-6)


def test_flat_wall_and_color_match_jax():
    """tests/test_mesh_ops.py's colour wall: constant colour fused
    where observed, equal to JAX's volume."""
    vol = jt.create_volume((8, 8, 8), voxel_size=0.1, origin=(-0.4, -0.4, 0.0),
                           with_color=True)
    depth = np.full((8, 8), 0.3, np.float32)
    rgb = np.full((8, 8, 3), 0.5, np.float32)
    intr = np.array([8.0, 8.0, 4.0, 4.0], np.float32)
    eye = np.eye(4, dtype=np.float32)
    jo = jt.integrate(vol, depth, intr, eye, rgb=rgb)
    to = tt.integrate(_port(vol), depth, intr, eye, rgb=rgb)
    w = to.weight.numpy()
    np.testing.assert_array_equal(w, np.asarray(jo.weight))
    np.testing.assert_allclose(to.color.numpy()[w > 0], 0.5, atol=1e-6)
    np.testing.assert_allclose(to.tsdf.numpy(), np.asarray(jo.tsdf), rtol=0, atol=1e-6)


def test_integrate_sequence_matches_jax_and_loop():
    vol = jt.create_volume((16, 16, 16), voxel_size=0.1, origin=(-0.8, -0.8, 0.0))
    depths = np.full((3, 16, 16), 0.7, np.float32)
    depths[1] += 0.05
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 1, 3] = [0.0, 0.03, -0.02]
    intr = np.array([16.0, 16.0, 8.0, 8.0], np.float32)
    jo = jt.integrate_sequence(vol, depths, intr, poses)
    to = tt.integrate_sequence(_port(vol), depths, intr, poses)
    loop = _port(vol)
    for d, p in zip(depths, poses):
        loop = tt.integrate(loop, d, intr, p)
    assert to.weight.max().item() == 3.0
    np.testing.assert_array_equal(to.weight.numpy(), np.asarray(jo.weight))
    np.testing.assert_allclose(to.tsdf.numpy(), np.asarray(jo.tsdf), rtol=0, atol=1e-6)
    assert torch.equal(to.tsdf, loop.tsdf) and torch.equal(to.weight, loop.weight)


def test_integrate_cloud_matches_jax():
    """A 600-point wavy patch carved into a 16³ volume from the origin:
    tsdf within 1e-4 (the nearest-point distance's fp32 cancellation),
    weights equal."""
    rng = np.random.default_rng(7)
    xy = rng.uniform(-0.6, 0.6, (600, 2))
    pts = np.c_[xy, 1.0 + 0.1 * np.sin(4 * xy[:, 0])].astype(np.float32)
    vol = jt.create_volume((16, 16, 16), voxel_size=0.1, origin=(-0.8, -0.8, 0.2))
    jo = jt.integrate_cloud(vol, JaxCloud.from_numpy(pts))
    jc = JaxCloud.from_numpy(pts)
    to = tt.integrate_cloud(_port(vol), interop.cloud_from_numpy(
        np.asarray(jc.points), np.asarray(jc.mask), device="cpu"))
    np.testing.assert_array_equal(to.weight.numpy(), np.asarray(jo.weight))
    assert to.weight.sum().item() > 100
    np.testing.assert_allclose(to.tsdf.numpy(), np.asarray(jo.tsdf), rtol=0, atol=1e-4)
