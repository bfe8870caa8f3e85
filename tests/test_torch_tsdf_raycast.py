"""TSDF raycasting: the PyTorch port (``threecrate_tpu_torch.ops.tsdf_raycast``)
against the JAX package, on the CPU.

Both packages march the SAME volume: JAX fuses it and the port receives
its fields through ``interop``, so raycast parity stands apart from
fusion's rounding. The volumes are ``tests/test_tsdf_raycast.py``'s
(a plane at 2 m, the analytic sphere, their colour variants, the sparse
plane) and ``tests/test_tsdf_sparse.py``'s wavy frame fused into the
sparse grid and cast from a rotated pose. Stated tolerances: masks and
confident masks equal; depth within 1e-5 m; vertices within 1e-5 m and
normals within 1e-5 on hits (the trilinear sums and the ray points
``o + t·d`` round differently where XLA contracts them into fused
multiply-adds: 2.4e-7 m and 7.7e-7 measured); colours within 1e-6;
shading within 1e-5. The march's exit test spacing changes no bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.core.transform import Transform as JaxTransform  # noqa: E402
from threecrate_tpu.ops import tsdf as jt  # noqa: E402
from threecrate_tpu.ops import tsdf_raycast as jrc  # noqa: E402
from threecrate_tpu.ops import tsdf_sparse as jsp  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import tsdf_raycast as trc  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

RES = (64, 64, 64)
VOX = 4.0 / 64
ORIGIN = (-2.0, -2.0, 0.5)
H, W = 48, 64
INTR = np.array([60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5], np.float32)
EYE = np.eye(4, dtype=np.float32)
GRID = (8, 8, 8)
POSE = np.asarray(JaxTransform.from_euler_xyz(jnp.asarray([0.03, -0.02, 0.01], jnp.float32),
                                              jnp.asarray([0.05, -0.04, 0.1], jnp.float32)).matrix)


def _np(x):
    return None if x is None else np.asarray(x)


def _dense(vol):
    return interop.tsdf_volume_from_numpy(*map(_np, vol), device="cpu")


def _sparse(vol):
    return interop.sparse_tsdf_volume_from_numpy(*map(_np, vol), device="cpu")


def _plane(with_color=False):
    vol = jt.create_volume(RES, VOX, origin=ORIGIN, with_color=with_color)
    rgb = jnp.broadcast_to(jnp.asarray([0.8, 0.4, 0.1], jnp.float32), (H, W, 3))
    return jt.integrate(vol, jnp.full((H, W), jnp.float32(2.0)), jnp.asarray(INTR),
                        jnp.asarray(EYE), rgb=rgb if with_color else None)


def _sphere():
    vol = jt.create_volume(RES, VOX, origin=ORIGIN)
    ax = np.arange(64) + 0.5
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    p = np.stack([gx, gy, gz], -1) * VOX + np.asarray(ORIGIN)
    d = np.linalg.norm(p - np.array([0.0, 0.0, 2.0]), axis=-1) - 0.8
    tsdf = np.clip(d / float(vol.truncation), -1.0, 1.0).astype(np.float32)
    return vol._replace(tsdf=jnp.asarray(tsdf), weight=jnp.ones(RES, jnp.float32))


def _sparse_plane(with_color=False):
    vol = jsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=8,
                                   max_blocks=512, with_color=with_color)
    rgb = jnp.broadcast_to(jnp.asarray([0.2, 0.9, 0.5], jnp.float32), (H, W, 3))
    return jsp.sparse_integrate(vol, jnp.full((H, W), jnp.float32(2.0)), jnp.asarray(INTR),
                                jnp.asarray(EYE), grid_blocks=GRID, block=8,
                                rgb=rgb if with_color else None)


@pytest.fixture(scope="module")
def wavy():
    yy, xx = np.mgrid[0:120, 0:160]
    rng = np.random.default_rng(0)
    depth = (2.0 + 0.3 * np.sin(xx / 20.0) * np.cos(yy / 15.0)
             + 0.005 * rng.normal(0, 1, (120, 160))).astype(np.float32)
    vol = jsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=8,
                                   max_blocks=512)
    for i in range(3):
        p = np.eye(4, dtype=np.float32)
        p[0, 3] = 0.02 * i
        vol = jsp.sparse_integrate(vol, jnp.asarray(depth),
                                   jnp.asarray([130.0, 130.0, 80.0, 60.0], jnp.float32),
                                   jnp.asarray(p), grid_blocks=GRID, block=8)
    return vol


def _equal(jr, tr, hits=1):
    m = np.asarray(jr.mask)
    np.testing.assert_array_equal(tr.mask.numpy(), m)
    np.testing.assert_array_equal(tr.confident.numpy(), np.asarray(jr.confident))
    assert m.mean() >= hits
    np.testing.assert_allclose(tr.depth.numpy(), np.asarray(jr.depth), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.vertices.numpy()[m], np.asarray(jr.vertices)[m], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tr.normals.numpy(), np.asarray(jr.normals), rtol=0, atol=1e-5)
    if jr.color is None:
        assert tr.color is None
    else:
        np.testing.assert_allclose(tr.color.numpy(), np.asarray(jr.color), rtol=0, atol=1e-6)


@pytest.mark.parametrize("coarse_factor", [1, 4])
@pytest.mark.parametrize("scene", ["plane", "sphere"])
def test_dense_raycast_matches_jax(scene, coarse_factor):
    jv = _plane() if scene == "plane" else _sphere()
    kw = dict(near=0.6, far=3.5, coarse_factor=coarse_factor)
    jr = jrc.raycast(jv, jnp.asarray(INTR), jnp.asarray(EYE), H, W, **kw)
    tr = trc.raycast(_dense(jv), INTR, EYE, H, W, **kw)
    _equal(jr, tr, hits=0.3)


@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("coarse_factor", [1, 4])
def test_sparse_raycast_matches_jax(wavy, materialize, coarse_factor):
    """The wavy fused volume cast from a rotated, shifted pose, on both
    sampler families."""
    kw = dict(grid_blocks=GRID, block=8, near=0.6, far=4.0, coarse_factor=coarse_factor,
              materialize=materialize)
    jr = jrc.sparse_raycast(wavy, jnp.asarray(INTR), jnp.asarray(POSE), H, W, **kw)
    tr = trc.sparse_raycast(_sparse(wavy), INTR, POSE, H, W, **kw)
    _equal(jr, tr, hits=0.9)


def test_materialized_paths_agree():
    """tests/test_tsdf_raycast.py's parity between the block-major copy
    and the row-map chain, on the port: masks equal, depth within 1e-6,
    normals within 1e-5."""
    tv = _sparse(_sparse_plane())
    a, b = (trc.sparse_raycast(tv, INTR, EYE, H, W, grid_blocks=GRID, block=8, near=0.6,
                               far=3.5, materialize=m) for m in (True, False))
    assert torch.equal(a.mask, b.mask) and a.mask.float().mean().item() > 0.9
    torch.testing.assert_close(a.depth, b.depth, atol=1e-6, rtol=0)
    torch.testing.assert_close(a.normals, b.normals, atol=1e-5, rtol=0)


@pytest.mark.parametrize("every", [3, 8, 96])
def test_exit_test_spacing_changes_nothing(wavy, every, monkeypatch):
    """The march tests its exit once every ``EXIT_TEST_EVERY`` steps; a
    finished ray is left unchanged by further steps, so the maps are
    bit-equal to those of a test at every step (JAX's loop), and the
    steps run are that loop's rounded up to the spacing (at most
    max_steps = 96)."""
    tv = _sparse(wavy)
    kw = dict(grid_blocks=GRID, block=8, near=0.6, far=4.0, coarse_factor=1)

    def run(spacing):
        monkeypatch.setattr(trc, "EXIT_TEST_EVERY", spacing)
        trc.reset_counts()
        return trc.sparse_raycast(tv, INTR, POSE, H, W, **kw), dict(trc.counts)

    ref, c1 = run(1)
    got, c = run(every)
    for a, b in zip(ref, got):
        assert a is None and b is None or torch.equal(a, b)
    assert c1["steps"] == c1["exit_tests"] < 96
    assert c["steps"] == min(-(-c1["steps"] // every) * every, 96)
    assert c.get("exit_tests", 0) == (c["steps"] // every if c["steps"] < 96 else 95 // every)


def test_max_steps_budget_matches_jax(wavy):
    """A budget too short for the far rays: the loop stops at max_steps
    as JAX's does."""
    kw = dict(grid_blocks=GRID, block=8, near=0.6, far=4.0, coarse_factor=1, max_steps=10)
    jr = jrc.sparse_raycast(wavy, jnp.asarray(INTR), jnp.asarray(EYE), H, W, **kw)
    trc.reset_counts()
    tr = trc.sparse_raycast(_sparse(wavy), INTR, EYE, H, W, **kw)
    assert trc.counts["steps"] == 10
    _equal(jr, tr, hits=0.0)


@pytest.mark.parametrize("far", [1.2, 3.5])
def test_misses_and_unobserved_match_jax(far):
    """Far short of the surface: every ray misses; an empty volume gives
    no hit."""
    for jv in (_plane(), jt.create_volume(RES, VOX, origin=ORIGIN)):
        jr = jrc.raycast(jv, jnp.asarray(INTR), jnp.asarray(EYE), H, W, near=0.6, far=far)
        tr = trc.raycast(_dense(jv), INTR, EYE, H, W, near=0.6, far=far)
        _equal(jr, tr, hits=0.0)
        if far < 2 or not np.asarray(jv.weight).any():
            assert not tr.mask.any() and tr.depth.abs().max().item() == 0.0


def test_color_and_shading_match_jax():
    """Dense and sparse colour channels, ``shade`` and ``shade_rgb`` (also
    with no colour channel: white)."""
    cases = [(jrc.raycast(_plane(True), jnp.asarray(INTR), jnp.asarray(EYE), H, W, near=0.6,
                          far=3.5),
              trc.raycast(_dense(_plane(True)), INTR, EYE, H, W, near=0.6, far=3.5)),
             (jrc.sparse_raycast(_sparse_plane(True), jnp.asarray(INTR), jnp.asarray(EYE), H, W,
                                 grid_blocks=GRID, block=8, near=0.6, far=3.5),
              trc.sparse_raycast(_sparse(_sparse_plane(True)), INTR, EYE, H, W,
                                 grid_blocks=GRID, block=8, near=0.6, far=3.5)),
             (jrc.raycast(_sphere(), jnp.asarray(INTR), jnp.asarray(EYE), H, W, near=0.6,
                          far=3.5),
              trc.raycast(_dense(_sphere()), INTR, EYE, H, W, near=0.6, far=3.5))]
    for jr, tr in cases:
        _equal(jr, tr, hits=0.3)
        for jimg, timg in ((jrc.shade(jr, background=0.1), trc.shade(tr, background=0.1)),
                           (jrc.shade_rgb(jr, background=(0.1, 0.2, 0.3)),
                            trc.shade_rgb(tr, background=(0.1, 0.2, 0.3)))):
            assert tuple(timg.shape) == jimg.shape
            np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=1e-5)
    assert cases[0][1].color is not None and cases[2][1].color is None
    c = cases[1][1].color[cases[1][1].mask].numpy()
    np.testing.assert_allclose(np.median(c, axis=0), [0.2, 0.9, 0.5], atol=0.02)
