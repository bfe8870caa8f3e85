"""The port's x-slab TSDF (``make_sharded_tsdf``: integrate, extraction,
marching cubes, the halo-extended raycast) and
``ShardedFrameToModelOdometry`` against the JAX package's on its 8-device
virtual CPU mesh (tests/conftest.py), at tests/test_parallel.py's sizes:
48×64 depth frames into a 16³ grid of 8³-voxel blocks. The port runs on
``make_mesh(8, devices=[cpu] * 8)``; the JAX side runs once a module.

Stated tolerances:
* integrate: the block keys, per-shard counts and weights equal to JAX's
  and to the port's single-device ``sparse_integrate`` (the projective
  update is per block, so the slab split changes no bit), tsdf within
  1e-6;
* surface points and marching-cubes vertices: the same rows as JAX's
  (within 1e-6 m) and the same multisets as the single-device calls;
* raycast: mask and confident maps equal to JAX's, depth, vertices and
  normals within 1e-5 (the single-device raycasts' parity,
  tests/test_torch_tsdf_raycast.py); against the single-device sparse
  raycast JAX's own gates (mask disagreement < 1%, depth within a voxel,
  median normal dot > 0.999);
* odometry: poses within 1e-4 of JAX's (tests/test_torch_frame_to_model.py)
  and within JAX's bounds of the true motion.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threecrate_tpu.parallel as jp
from threecrate_tpu.ops.frame_to_model import FrameToModelConfig as JConfig
from threecrate_tpu.parallel import sharded as jsh

import threecrate_tpu_torch.parallel as tp
from threecrate_tpu_torch.ops import tsdf_raycast as trc
from threecrate_tpu_torch.ops import tsdf_sparse as tsp
from threecrate_tpu_torch.ops.frame_to_model import FrameToModelConfig as TConfig
from threecrate_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)   # the suite runs several workers per host

CPU = torch.device("cpu")
H, W = 48, 64
INTR = np.array([52.0, 52.0, 31.5, 23.5], np.float32)
GRID = (16, 16, 16)
VSIZE = 4.0 / 128
ORIGIN = (-2.0, -2.0, 0.5)
FAC = dict(origin=ORIGIN, block=8, max_blocks_per_shard=512, update_fraction=1.0)
RAY = dict(far=6.0, max_steps=48, coarse_factor=4)


def tmesh():
    return tp.make_mesh(8, devices=[CPU] * 8)


def depth(shift=0.0):
    yy, xx = np.mgrid[0:H, 0:W]
    return (2.0 + 0.3 * np.sin((xx + shift) / 10.0) * np.cos(yy / 8.0)).astype(np.float32)


def poses(n):
    out = []
    for i in range(n):
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = 0.03 * i
        out.append(m)
    return out


def frames(n=3):
    return [(depth(shift=2.0 * i), p) for i, p in enumerate(poses(n))]


def state_dict(keys, tsdf, weight):
    keys, tsdf, weight = (np.asarray(x) for x in (keys, tsdf, weight))
    return {int(k): (tsdf[i], weight[i]) for i, k in enumerate(keys) if k != 2 ** 31 - 1}


@pytest.fixture(scope="module")
def jax_side():
    fac = jsh.make_sharded_tsdf(jp.make_mesh(8), GRID, VSIZE, **FAC)
    st = fac.init()
    for d, p in frames():
        st = fac.integrate(st, jnp.asarray(d), jnp.asarray(INTR), jnp.asarray(p))
    eye = jnp.asarray(np.eye(4, dtype=np.float32))
    return dict(state=st, extract=fac.extract_surface(st), mc=fac.marching_cubes(st),
                ray=fac.raycast(st, jnp.asarray(INTR), eye, H, W, **RAY))


@pytest.fixture(scope="module")
def port_side():
    fac = tsh.make_sharded_tsdf(tmesh(), GRID, VSIZE, **FAC)
    st = fac.init()
    ref = tsp.create_sparse_volume(VSIZE, origin=ORIGIN, grid_blocks=GRID, block=8,
                                   max_blocks=4096, device="cpu")
    for d, p in frames():
        st = fac.integrate(st, d, INTR, p)
        ref = tsp.sparse_integrate(ref, d, INTR, p, grid_blocks=GRID, block=8,
                                   update_fraction=1.0)
    return fac, st, ref


def test_integrate_matches_jax_and_single_device(jax_side, port_side):
    fac, st, ref = port_side
    js = jax_side["state"]
    assert isinstance(st.block_keys, tp.Sharded) and st.n_blocks.shape == (8,)
    np.testing.assert_array_equal(st.block_keys.numpy(), np.asarray(js.block_keys))
    np.testing.assert_array_equal(st.n_blocks.numpy(), np.asarray(js.n_blocks))
    np.testing.assert_array_equal(st.weight.numpy(), np.asarray(js.weight))
    np.testing.assert_allclose(st.tsdf.numpy(), np.asarray(js.tsdf), rtol=0, atol=1e-6)
    got = state_dict(st.block_keys.numpy(), st.tsdf.numpy(), st.weight.numpy())
    want = state_dict(ref.block_keys.numpy()[:int(ref.n_blocks)], ref.tsdf.numpy(),
                      ref.weight.numpy())
    assert set(got) == set(want) and len(want) > 100
    for k, (t, w) in want.items():
        np.testing.assert_allclose(got[k][0], t, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[k][1], w)
    assert int(st.n_blocks.numpy().sum()) == int(ref.n_blocks)
    # every shard holds only its own slab's keys
    keys = st.block_keys.numpy().reshape(8, -1)
    for d in range(8):
        live = keys[d][keys[d] != 2 ** 31 - 1]
        assert ((live // 256) // 2 == d).all()


def _rows(x):
    return x[np.lexsort(x.T)]


def test_extract_matches_jax_and_single_device(jax_side, port_side):
    fac, st, ref = port_side
    pts, mask = fac.extract_surface(st)
    jpts, jmask = (np.asarray(x) for x in jax_side["extract"])
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_allclose(pts.numpy()[jmask], jpts[jmask], rtol=0, atol=1e-6)
    surf = tsp.sparse_extract_surface(ref, GRID, block=8)
    want = surf.cloud.points.numpy()[surf.cloud.mask.numpy()]
    got = pts.numpy()[mask.numpy()]
    assert got.shape == want.shape and len(want) > 500
    np.testing.assert_allclose(_rows(got), _rows(want), rtol=0, atol=1e-6)


def test_marching_cubes_matches_jax_and_single_device(jax_side, port_side):
    fac, st, ref = port_side
    verts, vmask = fac.marching_cubes(st)
    jv, jm = (np.asarray(x) for x in jax_side["mc"])
    np.testing.assert_array_equal(vmask.numpy(), jm)
    np.testing.assert_allclose(verts.numpy()[jm], jv[jm], rtol=0, atol=1e-6)
    soup = tsp.sparse_marching_cubes_soup(ref, GRID, block=8)
    want = soup.vertices.numpy()[soup.mask.repeat_interleave(3).numpy()]
    got = verts.numpy()[vmask.numpy()]
    assert got.shape == want.shape and len(want) > 1000
    np.testing.assert_allclose(_rows(got), _rows(want), rtol=0, atol=1e-6)


def test_raycast_matches_jax_and_single_device(jax_side, port_side):
    """The per-slab marches and the pmin / psum combine against JAX's maps,
    and against the single-device sparse raycast with JAX's gates: any
    crossing the global march finds lies in some shard's blocks."""
    fac, st, ref = port_side
    d, v, n, m, c = fac.raycast(st, INTR, np.eye(4, dtype=np.float32), H, W, **RAY)
    jd, jv, jn, jm, jc = (np.asarray(x) for x in jax_side["ray"])
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy()[jm], jv[jm], rtol=0, atol=1e-5)
    np.testing.assert_allclose(n.numpy(), jn, rtol=0, atol=1e-5)
    want = trc.sparse_raycast(ref, INTR, np.eye(4, dtype=np.float32), H, W, grid_blocks=GRID,
                              block=8, materialize=False, **RAY)
    got_m, want_m = m.numpy(), want.mask.numpy()
    assert (got_m != want_m).mean() < 0.01
    both = got_m & want_m
    assert both.sum() > 0.5 * got_m.size
    np.testing.assert_allclose(d.numpy()[both], want.depth.numpy()[both], atol=VSIZE)
    dots = np.abs((n.numpy()[both] * want.normals.numpy()[both]).sum(-1)).clip(0, 1)
    assert np.median(dots) > 0.999
    # the cache hands back one callable per (height, width, near, far, steps, factor)
    again = fac.raycast(st, INTR, np.eye(4, dtype=np.float32), H, W, **RAY)
    assert torch.equal(again[0], d)


def test_raycast_across_slab_boundaries():
    """A wall tilted in x crosses every slab boundary: the halo layers
    (and the sentinel keys of the mesh-end receivers) keep the sharded
    maps equal to the single-device raycast there, with no stripes of
    misses at the boundaries."""
    mesh = tmesh()
    grid = (8, 8, 8)
    vox = 4.0 / 64
    fac = tsh.make_sharded_tsdf(mesh, grid, vox, origin=(-2.0, -2.0, 0.0), block=8,
                                max_blocks_per_shard=256, update_fraction=1.0)
    st = fac.init()
    ref = tsp.create_sparse_volume(vox, origin=(-2.0, -2.0, 0.0), grid_blocks=grid, block=8,
                                   max_blocks=2048, device="cpu")
    intr = np.array([40.0, 40.0, 31.5, 23.5], np.float32)
    xx = (np.arange(W) - intr[2]) / intr[0]
    # z = 1.8 + 0.5 x on the ray through u: z = 1.8 / (1 - 0.5 xx)
    wall = np.broadcast_to((1.8 / (1.0 - 0.5 * xx))[None, :], (H, W)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    st = fac.integrate(st, wall, intr, eye)
    ref = tsp.sparse_integrate(ref, wall, intr, eye, grid_blocks=grid, block=8,
                               update_fraction=1.0)
    keys = st.block_keys.numpy().reshape(8, -1)
    owners = {d for d in range(8) if (keys[d] != 2 ** 31 - 1).any()}
    assert len(owners) >= 4                      # the wall spans several slabs
    d, v, n, m, c = fac.raycast(st, intr, eye, H, W, near=0.5, far=4.0, max_steps=64)
    want = trc.sparse_raycast(ref, intr, eye, H, W, grid_blocks=grid, block=8, near=0.5,
                              far=4.0, max_steps=64, materialize=False)
    got_m, want_m = m.numpy(), want.mask.numpy()
    assert (got_m != want_m).mean() < 0.01 and want_m.mean() > 0.9
    both = got_m & want_m
    np.testing.assert_allclose(d.numpy()[both], want.depth.numpy()[both], rtol=0, atol=vox)
    dots = np.abs((n.numpy()[both] * want.normals.numpy()[both]).sum(-1))
    assert np.median(dots) > 0.999
    # each shard's own blocks alone, with no halo, leave boundary pixels
    # unhit: the halo is what the equality above rests on
    alone = np.zeros((H, W), bool)
    for k, nb, t, w in zip(*(x.shards for x in (st.block_keys, st.n_blocks, st.tsdf,
                                                  st.weight))):
        vol = ref._replace(block_keys=k, n_blocks=nb[0], tsdf=t, weight=w)
        alone |= trc.sparse_raycast(vol, intr, eye, H, W, grid_blocks=grid, block=8, near=0.5,
                                    far=4.0, max_steps=64, materialize=False).mask.numpy()
    lost = want_m & ~alone
    assert lost.sum() > 50 and got_m[lost].all()


def wall_depths(n=3, dx=0.02):
    yy, xx = np.mgrid[0:H, 0:W]
    return [(2.0 + 0.25 * np.sin((xx + dx * i * float(INTR[0]) / 2.0) / 9.0)
             * np.cos(yy / 7.0)).astype(np.float32) for i in range(n)]


def test_sharded_odometry_matches_jax_and_recovers_motion():
    """tests/test_parallel.py's wavy wall seen from a camera moving in x
    (the pattern shifts by fx·dx/z pixels a frame): three frames through
    both packages' ShardedFrameToModelOdometry."""
    kw = dict(voxel_size=VSIZE, origin=ORIGIN, grid_blocks=GRID, block=8,
              max_blocks_per_shard=512)
    cfg = dict(model_render_scale=1, max_steps=48, far=6.0)
    jo = jp.ShardedFrameToModelOdometry(jp.make_mesh(8), jnp.asarray(INTR), H, W,
                                        config=JConfig(**cfg), **kw)
    to = tp.ShardedFrameToModelOdometry(tmesh(), INTR, H, W, config=TConfig(**cfg), **kw)
    for i, dep in enumerate(wall_depths()):
        pj = np.asarray(jo.register_frame(jnp.asarray(dep)))
        pt = to.register_frame(dep)
        assert isinstance(pt, torch.Tensor) and pt.shape == (4, 4)
        np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-4, err_msg=f"frame {i}")
    assert bool(to.last_track.converged) and to.n_frames == 3
    p2 = to.pose.numpy()
    np.testing.assert_allclose(p2[:3, :3], np.eye(3), atol=0.02)
    assert abs(abs(p2[0, 3]) - 2 * 0.02) < 0.015, p2[:3, 3]
    assert np.abs(p2[1:3, 3]).max() < 0.01
    np.testing.assert_array_equal(to.state.n_blocks.numpy(), np.asarray(jo.state.n_blocks))
    # render(): the current map from the current pose, replicated maps
    d, v, n, m, c = to.render()
    jd, _, _, jm, _ = (np.asarray(x) for x in jo.render())
    assert (m.numpy() != jm).mean() < 0.01 and m.numpy().mean() > 0.5
    both = m.numpy() & jm
    np.testing.assert_allclose(d.numpy()[both], jd[both], rtol=0, atol=1e-4)


def test_grid_not_divisible_raises():
    for make, mesh in ((jsh.make_sharded_tsdf, jp.make_mesh(8)),
                       (tsh.make_sharded_tsdf, tmesh())):
        with pytest.raises(ValueError, match="must be divisible by the 'points' mesh axis "
                                             "size 8"):
            make(mesh, (12, 16, 16), VSIZE)
