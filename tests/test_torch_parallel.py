"""The port's device meshes, collectives and points-axis sharded
operations against the JAX package's on its 8-device virtual CPU mesh
(tests/conftest.py). The port runs the same entries on
``make_mesh(8, devices=[cpu] * 8)``; inputs are numpy from a seed, at
tests/test_parallel.py's sizes.

Stated tolerances:
* collectives: equal to ``jax.lax``'s inside ``shard_map`` (psum within
  1e-6 relative: XLA may add the eight shards in another order);
* ring kNN: ids equal, squared distances within 2e-6, two fp32 ulps of
  ‖q‖² + ‖p‖² (~8 here): the port's single-device ``knn`` differs from
  JAX's by as much, and the square root magnifies it near zero (4.9e-5
  at d = 0.005); the top-1 match ring's points and payload equal;
* poses of the ICP family within 1e-5 of JAX's (the 3x3 SVD and 6x6
  solve run on the host in the port, in XLA in JAX), the MSE within
  2e-6 (the d² tolerance) or 1e-3 relative, iterations equal except
  point-to-plane's, whose MSE settles at the d² noise;
* ring normals |cos| >= 0.9999, masked rows zero;
* window normals (kernel 4 on each shard) at
  tests/test_torch_window_normals.py's kernel tolerances: validity equal
  on >= 99.9%, |cos| >= 0.9999 on >= 99.9%;
* the distributed sort bit-equal to JAX's where the keys have no ties,
  a permutation with the stable sort's key sequence where they do;
* voxel centroids within 1e-5 as sets, counts equal;
* outlier masks equal, global statistics within 1e-6 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map as jshard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import threecrate_tpu.parallel as jp
from threecrate_tpu import PointCloud, Transform
from threecrate_tpu.ops import normals as jnormals
from threecrate_tpu.parallel import sharded as jsh

import threecrate_tpu_torch.parallel as tp
from threecrate_tpu_torch import kernels
from threecrate_tpu_torch.ops import morton as tmorton
from threecrate_tpu_torch.parallel import collectives as tcol
from threecrate_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)   # the suite runs several workers per host

CPU = torch.device("cpu")
POSE_TOL = 1e-5


def tmesh(n=8):
    return tp.make_mesh(n, devices=[CPU] * n)


def t2d():
    return tp.Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4), ("batch", "points"))


def j2d():
    return JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("batch", "points"))


def jput(x, mesh=None):
    return jp.put_sharded(jnp.asarray(x), mesh or jp.make_mesh(8))


def np_of(x):
    if isinstance(x, tp.Sharded):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def surface_cloud(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def wavy(n, seed, amp=(0.3, 0.2), freq=(1.0, 1.3), span=3.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    z = amp[0] * np.sin(xy[:, 0] * freq[0]) + amp[1] * np.cos(xy[:, 1] * freq[1])
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def icp_pair(n=4096, seed=15):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(xy[:, 0] * 1.7) + 0.25 * np.cos(xy[:, 1] * 1.2)
    pts = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    m = np.asarray((Transform.from_axis_angle([1.0, 0.2, 0], 0.02)
                    @ Transform.from_translation([0.04, -0.02, 0.02])).matrix)
    return pts, (pts @ m[:3, :3].T + m[:3, 3]).astype(np.float32), m


# ---------------------------------------------------------------------------
# mesh and placement
# ---------------------------------------------------------------------------

def test_make_mesh_needs_cuda_unless_devices_given():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(ValueError, match="no CUDA device"):
        tp.make_mesh()
    with pytest.raises(ValueError, match="no CUDA device"):
        tp.make_mesh(8)


def test_make_mesh_fewer_devices_than_asked_raises():
    with pytest.raises(ValueError, match="requested a 9-device mesh"):
        tp.make_mesh(9, devices=[CPU] * 8)
    mesh = tmesh(8)
    assert mesh.shape == {"points": 8} and mesh.size == 8
    assert tp.make_mesh(4, devices=[CPU] * 8).shape == {"points": 4}


def test_put_sharded_round_trip_and_indivisible_raises():
    mesh = tmesh()
    x = np.arange(48, dtype=np.float32).reshape(16, 3)
    s = tp.put_sharded(x, mesh)
    assert s.shape == (16, 3) and len(s.shards) == 8
    assert all(sh.shape == (2, 3) for sh in s.shards)
    np.testing.assert_array_equal(s.numpy(), x)
    assert tp.put_sharded(s, mesh) is s
    r = tp.put_replicated(x, mesh)
    assert all(torch.equal(sh, torch.from_numpy(x)) for sh in r.shards)
    with pytest.raises(ValueError, match="divisible by 8"):
        tp.put_sharded(np.zeros((17, 3), np.float32), mesh)
    with pytest.raises(ValueError, match="divisible by 8"):
        tp.make_sharded_knn(mesh, 2)(np.zeros((12, 3), np.float32),
                                     np.zeros((16, 3), np.float32), np.ones(16, bool))


def test_two_d_placement_matches_named_sharding():
    x = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    s = tp.put(x, t2d(), tp.P("batch", "points"))
    ja = jax.device_put(jnp.asarray(x), NamedSharding(j2d(), JP("batch", "points")))
    jshards = {d: np.asarray(sh.data) for d, sh in
               ((sh.device, sh) for sh in ja.addressable_shards)}
    jdevs = list(j2d().devices.flat)
    for i, sh in enumerate(s.shards):
        np.testing.assert_array_equal(sh.numpy(), jshards[jdevs[i]])
    np.testing.assert_array_equal(s.numpy(), x)


# ---------------------------------------------------------------------------
# collectives against jax.lax inside shard_map
# ---------------------------------------------------------------------------

_PERM = [(0, 1), (1, 2), (2, 3), (5, 4), (7, 0)]   # shards 5, 6 and 7 receive nothing
_COLLECTIVES = {
    "ppermute": (lambda x, a: jax.lax.ppermute(x, a, _PERM),
                 lambda xs, m, a: tcol.ppermute(xs, m, a, _PERM)),
    "psum": (lambda x, a: jax.lax.psum(x, a), tcol.psum),
    "pmin": (lambda x, a: jax.lax.pmin(x, a), tcol.pmin),
    "pmax": (lambda x, a: jax.lax.pmax(x, a), tcol.pmax),
    "all_gather": (lambda x, a: jax.lax.all_gather(x, a),
                   lambda xs, m, a: tcol.all_gather(xs, m, a)),
    "all_gather tiled": (lambda x, a: jax.lax.all_gather(x, a, tiled=True),
                         lambda xs, m, a: tcol.all_gather(xs, m, a, tiled=True)),
    "axis_index": (lambda x, a: x * 0 + jax.lax.axis_index(a).astype(x.dtype),
                   lambda xs, m, a: [x * 0 + i for x, i in zip(xs, tcol.axis_index(m, a))]),
}


def _run_both(name, x, jmesh_, tmesh_, axis, spec):
    jfn, tfn = _COLLECTIVES[name]
    # each shard's result, stacked on a new leading axis in device order
    jout = jshard_map(lambda v: jfn(v, axis)[None], mesh=jmesh_, in_specs=spec,
                      out_specs=JP(tuple(jmesh_.axis_names)), check_vma=False)(jnp.asarray(x))
    got = tcol.shard_map(lambda xs: tfn(xs, tmesh_, axis), tmesh_, (tp.P(*spec),),
                         tp.P(*spec))(x)
    return np.asarray(jout), [sh.numpy() for sh in got.shards]


@pytest.mark.parametrize("name", list(_COLLECTIVES))
def test_collective_matches_lax_on_1d_mesh(name):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    jout, shards = _run_both(name, x, jp.make_mesh(8), tmesh(), "points", JP("points"))
    for i, sh in enumerate(shards):
        ref = jout[i]
        if name == "psum":
            np.testing.assert_allclose(sh, ref, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(sh, ref)
    if name == "ppermute":   # zero fill where no shard sends
        for i in (5, 6, 7):
            assert not shards[i].any()


@pytest.mark.parametrize("name,axis", [(n, a) for a in ("points", "batch")
                                       for n in ("ppermute", "psum", "pmin",
                                                 "all_gather tiled", "axis_index")])
def test_collective_matches_lax_on_2d_mesh(name, axis):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 3)).astype(np.float32)
    spec = JP("batch", "points")
    jfn, tfn = _COLLECTIVES[name]
    if name == "ppermute":   # positions along the axis: the batch axis has two
        perm = [(0, 1), (1, 2), (3, 0)] if axis == "points" else [(0, 1)]
        jfn = lambda v, a: jax.lax.ppermute(v, a, perm)       # noqa: E731
        tfn = lambda xs, m, a: tcol.ppermute(xs, m, a, perm)  # noqa: E731
    jout = jshard_map(lambda v: jfn(v, axis)[None, None], mesh=j2d(), in_specs=spec,
                      out_specs=JP("batch", "points"), check_vma=False)(jnp.asarray(x))
    jout = np.asarray(jout)
    mesh = t2d()
    got = tcol.shard_map(lambda xs: tfn(xs, mesh, axis), mesh, (tp.P("batch", "points"),),
                         tp.P("batch", "points"))(x)
    for i, sh in enumerate(got.shards):
        b, p = divmod(i, 4)
        np.testing.assert_allclose(sh.numpy(), jout[b, p], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# ring kNN and the top-1 match ring
# ---------------------------------------------------------------------------

def test_ring_knn_matches_jax():
    pts, q = surface_cloud(1024), surface_cloud(512, seed=3)
    mask = np.ones(1024, bool)
    mask[::7] = False
    jmesh_ = jp.make_mesh(8)
    jd, ji = jsh.make_sharded_knn(jmesh_, k=4)(jput(q), jput(pts), jput(mask))
    td, ti = tp.make_sharded_knn(tmesh(), k=4)(q, pts, mask)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(np_of(ti), np.asarray(ji))
    np.testing.assert_allclose(np_of(td) ** 2, np.asarray(jd) ** 2, atol=2e-6, rtol=0)


def test_ring_knn_local_more_neighbours_than_a_shard():
    """k larger than a shard's rows: the merge draws on several steps."""
    pts = surface_cloud(64, seed=9)
    jmesh_ = jp.make_mesh(8)
    jd, ji = jsh.make_sharded_knn(jmesh_, k=12)(jput(pts), jput(pts), jput(np.ones(64, bool)))
    td, ti = tp.make_sharded_knn(tmesh(), k=12)(pts, pts, np.ones(64, bool))
    np.testing.assert_array_equal(np_of(ti), np.asarray(ji))
    np.testing.assert_allclose(np_of(td) ** 2, np.asarray(jd) ** 2, atol=2e-6, rtol=0)


def test_ring_match1_payload_matches_jax():
    rng = np.random.default_rng(17)
    q = rng.normal(0, 1, (1024, 3)).astype(np.float32)
    db = rng.normal(0, 1, (2048, 3)).astype(np.float32)
    pay = rng.normal(0, 1, (2048, 5)).astype(np.float32)
    dbm = rng.uniform(size=2048) > 0.1
    jmesh_ = jp.make_mesh(8)

    @functools.partial(jshard_map, mesh=jmesh_, in_specs=(JP("points"),) * 4,
                       out_specs=(JP("points"),) * 3, check_vma=False)
    def run(qs, dbs, ms, ps):
        return jsh.ring_match1_local(qs, dbs, ms, ps, "points")

    jneg, jpts, jpay = run(jput(q), jput(db), jput(dbm), jput(pay))
    mesh = tmesh()
    body = functools.partial(tsh.ring_match1_local, axis_name="points", mesh=mesh)
    tneg, tpts, tpay = tcol.shard_map(body, mesh, (tp.P("points"),) * 4,
                                      (tp.P("points"),) * 3)(q, db, dbm, pay)
    np.testing.assert_array_equal(np_of(tpts), np.asarray(jpts))
    np.testing.assert_array_equal(np_of(tpay), np.asarray(jpay))
    np.testing.assert_allclose(np_of(tneg), np.asarray(jneg), atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# ring normals
# ---------------------------------------------------------------------------

def test_ring_normals_match_jax():
    pts = surface_cloud(2048)
    vp = (0.0, 0.0, 10.0)
    jn = np.asarray(jsh.make_sharded_normals(jp.make_mesh(8), k=10, viewpoint=vp)(
        jput(pts), jput(np.ones(2048, bool))))
    tn = np_of(tp.make_sharded_normals(tmesh(), k=10, viewpoint=vp)(pts, np.ones(2048, bool)))
    np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0, atol=1e-4)
    assert ((tn * jn).sum(1) >= 0.9999).all()     # orientation included


def test_ring_normals_masked_rows_zero():
    pts = surface_cloud(1024)
    mask = np.ones(1024, bool)
    mask[100:200] = False
    jn = np.asarray(jsh.make_sharded_normals(jp.make_mesh(8), k=8)(jput(pts), jput(mask)))
    tn = np_of(tp.make_sharded_normals(tmesh(), k=8)(pts, mask))
    assert not tn[100:200].any()
    assert ((tn[mask] * jn[mask]).sum(1) >= 0.9999).all()


# ---------------------------------------------------------------------------
# the ICP family
# ---------------------------------------------------------------------------

def _pose_close(t_port, j_out, same_iterations=True):
    t, mse, it, conv = t_port
    jt, jmse, jit, jconv = (np.asarray(v) for v in j_out)
    np.testing.assert_allclose(np_of(t), jt, atol=POSE_TOL, rtol=0)
    if same_iterations:
        assert int(it) == int(jit) and bool(conv) == bool(jconv)
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-3, atol=2e-6)


def test_sharded_icp_matches_jax():
    pts = surface_cloud(2048)
    m = np.asarray(Transform.from_translation([0.05, -0.02, 0.01]).matrix)
    tgt = (pts @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
    ones = np.ones(2048, bool)
    jout = jsh.make_sharded_icp(jp.make_mesh(8), max_iterations=30)(
        jput(pts), jput(ones), jput(tgt), jput(ones))
    tout = tp.make_sharded_icp(tmesh(), max_iterations=30)(pts, ones, tgt, ones)
    assert tout[0].shape == (4, 4) and tout[0].device == CPU
    _pose_close(tout, jout)
    np.testing.assert_allclose(np_of(tout[0]), m, atol=3e-3)


def test_sharded_icp_masked_padding_ignored():
    pts = surface_cloud(1024)
    mask = np.ones(1024, bool)
    mask[900:] = False
    bad = pts.copy()
    bad[900:] = 1e3
    jout = jsh.make_sharded_icp(jp.make_mesh(8), max_iterations=10)(
        jput(bad), jput(mask), jput(bad), jput(mask))
    tout = tp.make_sharded_icp(tmesh(), max_iterations=10)(bad, mask, bad, mask)
    _pose_close(tout, jout)
    np.testing.assert_allclose(np_of(tout[0]), np.eye(4), atol=1e-3)


def test_sharded_batch_icp_on_2d_mesh_matches_jax():
    pts = surface_cloud(1024)
    offsets = np.array([[0.05, -0.02, 0.01], [0.01, 0.03, -0.02]], np.float32)
    src = np.stack([pts, pts])
    tgt = np.stack([pts + offsets[0], pts + offsets[1]])
    masks = np.ones((2, 1024), bool)

    def put(x):
        return jax.device_put(jnp.asarray(x), NamedSharding(j2d(), JP("batch", "points")))

    jt, jmse, jit, jconv = (np.asarray(v) for v in jsh.make_sharded_batch_icp(
        j2d(), max_iterations=25)(put(src), put(masks), put(tgt), put(masks)))
    out = tp.make_sharded_batch_icp(t2d(), max_iterations=25)(src, masks, tgt, masks)
    assert all(isinstance(o, tp.Sharded) and o.spec == tp.P("batch") for o in out)
    t, mse, it, conv = (np_of(o) for o in out)
    np.testing.assert_allclose(t, jt, atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(it, jit)
    np.testing.assert_array_equal(conv, jconv)
    for b in range(2):
        np.testing.assert_allclose(t[b][:3, 3], offsets[b], atol=5e-3)


@pytest.fixture(scope="module")
def p2plane_case():
    pts, tgt, m = icp_pair()
    tn = np.asarray(jnormals.estimate_normals(PointCloud.from_numpy(tgt), k=10).normals)
    ones = np.ones(len(pts), bool)
    jout = jsh.make_sharded_icp_p2plane(jp.make_mesh(8), max_iterations=25)(
        jput(pts), jput(ones), jput(tgt), jput(ones), jput(tn))
    return pts, tgt, tn, m, jout


def test_sharded_p2plane_matches_jax(p2plane_case):
    pts, tgt, tn, m, jout = p2plane_case
    ones = np.ones(len(pts), bool)
    tout = tp.make_sharded_icp_p2plane(tmesh(), max_iterations=25)(pts, ones, tgt, ones, tn)
    # its MSE settles at the d² noise (~1e-7), so |ΔMSE| < 1e-6 is met at an
    # iteration that noise picks: the poses agree, the counts need not
    _pose_close(tout, jout, same_iterations=False)
    assert 1 <= int(tout[2]) <= 25
    np.testing.assert_allclose(np_of(tout[0]), m, atol=4e-3)


def test_sharded_gicp_matches_jax():
    pts, tgt, m = icp_pair(seed=16)
    ones = np.ones(len(pts), bool)
    jout = jsh.make_sharded_gicp(jp.make_mesh(8), max_iterations=30)(
        jput(pts), jput(ones), jput(tgt), jput(ones))
    tout = tp.make_sharded_gicp(tmesh(), max_iterations=30)(pts, ones, tgt, ones)
    _pose_close(tout, jout)
    np.testing.assert_allclose(np_of(tout[0]), m, atol=4e-3)


def test_icp_sharded_step_matches_jax():
    pts = surface_cloud(1024, seed=5)
    tgt = pts + np.float32([0.03, 0.01, -0.02])
    ones = np.ones(1024, bool)
    init = np.array(Transform.from_translation([0.01, 0.0, 0.0]).matrix)
    jmesh_ = jp.make_mesh(8)

    @functools.partial(jshard_map, mesh=jmesh_, in_specs=(JP("points"),) * 4 + (JP(),),
                       out_specs=(JP(),) * 3, check_vma=False)
    def run(s, sm, t, tm, t_mat):
        return jsh.icp_sharded_step(s, sm, t, tm, t_mat, jnp.float32(0.5), "points")

    jd, jmse, jn = run(jput(pts), jput(ones), jput(tgt), jput(ones), jnp.asarray(init))
    mesh = tmesh()
    d, mse, n = tsh.icp_sharded_step(
        [torch.from_numpy(x) for x in np.split(pts, 8)], [torch.ones(128, dtype=torch.bool)] * 8,
        [torch.from_numpy(x) for x in np.split(tgt, 8)], [torch.ones(128, dtype=torch.bool)] * 8,
        [torch.from_numpy(init)] * 8, 0.5, mesh=mesh)
    assert all(x is d[0] for x in d)      # replicated: one host value
    np.testing.assert_allclose(d[0].numpy(), np.asarray(jd), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(float(mse[0]), float(jmse), rtol=1e-4)
    assert int(n[0]) == int(jn)


# ---------------------------------------------------------------------------
# outlier statistics
# ---------------------------------------------------------------------------

def test_global_stats_local_matches_jax():
    rng = np.random.default_rng(21)
    v = rng.gamma(2.0, 0.1, 1024).astype(np.float32)
    m = rng.uniform(size=1024) > 0.2
    jmesh_ = jp.make_mesh(8)

    @functools.partial(jshard_map, mesh=jmesh_, in_specs=(JP("points"),) * 2,
                       out_specs=(JP(), JP()), check_vma=False)
    def run(vs, ms):
        return jsh.global_stats_local(vs, ms, "points")

    jmu, jsig = (float(x) for x in run(jput(v), jput(m)))
    mesh = tmesh()
    mu, sig = tcol.shard_map(
        lambda vs, ms: tsh.global_stats_local(vs, ms, "points", mesh=mesh), mesh,
        (tp.P("points"),) * 2, (tp.P(), tp.P()))(v, m)
    np.testing.assert_allclose(float(mu), jmu, rtol=1e-6)
    np.testing.assert_allclose(float(sig), jsig, rtol=1e-6)


@pytest.mark.parametrize("std", [0.5, 1.0, 2.0])
def test_sharded_outlier_stats_matches_jax(std):
    pts = surface_cloud(1024, seed=2)
    rng = np.random.default_rng(22)
    pts[rng.choice(1024, 40, replace=False)] += rng.normal(0, 0.5, (40, 3)).astype(np.float32)
    mask = np.ones(1024, bool)
    mask[::50] = False
    jfn = jsh.make_sharded_outlier_stats(jp.make_mesh(8), k=8)
    jm = np.asarray(jfn(jput(pts), jput(mask),
                        jp.put_replicated(jnp.float32(std), jp.make_mesh(8))))
    tm = np_of(tp.make_sharded_outlier_stats(tmesh(), k=8)(pts, mask, std))
    np.testing.assert_array_equal(tm, jm)
    assert 0 < (mask & ~tm).sum() < mask.sum() // 4


# ---------------------------------------------------------------------------
# the distributed Morton sort and the sharded window normals
# ---------------------------------------------------------------------------

def test_morton_presort_matches_jax():
    pts = wavy(3000, 3)
    mask = np.ones(3000, bool)
    mask[::11] = False
    jout = jsh.morton_presort(pts, mask, 8, tile=128)
    tout = tsh.morton_presort(pts, mask, 8, tile=128)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def uniform_sort():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)
    mask = np.ones(4096, bool)
    mask[rng.choice(4096, 200, replace=False)] = False
    j = [np.asarray(x) for x in jsh.make_distributed_morton_sort(jp.make_mesh(8))(
        jput(pts), jput(mask))]
    return pts, mask, j


def test_distributed_sort_matches_jax_without_ties(uniform_sort):
    pts, mask, (jpts, jmask, jgid) = uniform_sort
    tpts, tmask, tgid = (np_of(x) for x in tp.make_distributed_morton_sort(tmesh())(pts, mask))
    keys = tmorton.morton_keys(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    nv = int(mask.sum())
    assert len(np.unique(keys[mask])) == nv          # the valid keys have no ties
    np.testing.assert_array_equal(tgid[:nv], jgid[:nv])
    np.testing.assert_array_equal(tpts[:nv], jpts[:nv])
    assert tmask[:nv].all() and not tmask[nv:].any()
    np.testing.assert_array_equal(np.sort(tgid), np.arange(4096))
    np.testing.assert_array_equal(tpts, pts[tgid])
    np.testing.assert_array_equal(keys[tgid], np.sort(keys, kind="stable"))


def test_distributed_sort_single_device_mesh():
    pts = surface_cloud(512, seed=12)
    spts, smask, gid = (np_of(x) for x in tp.make_distributed_morton_sort(tmesh(1))(
        pts, np.ones(512, bool)))
    np.testing.assert_array_equal(spts, pts[gid])
    keys = tmorton.morton_keys(torch.from_numpy(pts), torch.ones(512, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(gid, np.argsort(keys, kind="stable"))


@pytest.fixture(scope="module")
def tied_cloud():
    """4,096 points drawn from 64 distinct points: every key is shared by
    many rows, across shard boundaries."""
    rng = np.random.default_rng(7)
    base = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    pts = base[rng.integers(0, 64, 4096)]
    return pts, np.ones(4096, bool)


def test_distributed_sort_is_a_permutation_on_tied_keys(tied_cloud):
    """The reference's merge loses rows where equal keys straddle a
    pair's boundary; the port's gid is a permutation and its key sequence
    is the stable host sort's."""
    pts, mask = tied_cloud
    jgid = np.asarray(jsh.make_distributed_morton_sort(jp.make_mesh(8))(
        jput(pts), jput(mask))[2])
    assert len(np.unique(jgid)) < 4096               # the reference defect
    tpts, tmask, tgid = (np_of(x) for x in tp.make_distributed_morton_sort(tmesh())(pts, mask))
    np.testing.assert_array_equal(np.sort(tgid), np.arange(4096))
    np.testing.assert_array_equal(tpts, pts[tgid])
    keys = tmorton.morton_keys(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(keys[tgid], keys[order])
    np.testing.assert_array_equal(tgid, order)       # ties in input order


def _presorted_back(pts, mask, tile, vp, k=10):
    spts, smask, perm = tsh.morton_presort(pts, mask, 8, tile=tile)
    nrm, val = (np_of(x) for x in tp.make_sharded_normals_window(
        tmesh(), k=k, viewpoint=vp, tile=tile, presorted=True)(spts, smask))
    back_n = np.zeros_like(pts)
    back_v = np.zeros(len(pts), bool)
    ok = perm >= 0
    back_n[perm[ok]] = nrm[ok]
    back_v[perm[ok]] = val[ok]
    return back_n, back_v


def test_window_normals_on_tied_keys_route_back(tied_cloud):
    pts, mask = tied_cloud
    pts = pts + np.float32(1e-3) * np.random.default_rng(8).normal(size=pts.shape).astype(
        np.float32)
    pts[1::2] = pts[0::2]                            # exact duplicates again
    vp = (0.0, 0.0, 10.0)
    ref_n, ref_v = _presorted_back(pts, mask, 128, vp)
    nrm, val = (np_of(x) for x in tp.make_sharded_normals_window(
        tmesh(), k=10, viewpoint=vp, tile=128)(pts, mask))
    np.testing.assert_array_equal(val, ref_v)
    np.testing.assert_array_equal(nrm, ref_n)


def _window_agree(tn, tv, jn, jv):
    assert np.mean(tv == jv) >= 0.999
    both = tv & jv
    assert both.sum() > 0.97 * len(tv)
    cos = (tn[both] * jn[both]).sum(1)                 # orientation included
    assert np.mean(cos >= 0.9999) >= 0.999, np.quantile(cos, [0.001, 0.5])


@pytest.fixture(scope="module")
def window_cloud():
    pts = wavy(6000, 3)
    spts, smask, perm = jsh.morton_presort(pts, np.ones(len(pts), bool), 8, tile=128)
    vp = (0.0, 0.0, 10.0)
    jn, jv = (np.asarray(x) for x in jsh.make_sharded_normals_window(
        jp.make_mesh(8), k=10, viewpoint=vp, tile=128, presorted=True)(jput(spts), jput(smask)))
    return spts, smask, vp, jn, jv


def test_window_normals_presorted_match_jax(window_cloud):
    spts, smask, vp, jn, jv = window_cloud
    kernels.reset_launch_counts()
    tn, tv = (np_of(x) for x in tp.make_sharded_normals_window(
        tmesh(), k=10, viewpoint=vp, tile=128, presorted=True)(spts, smask))
    assert kernels.launch_counts()["window_normals"] == 0     # the CPU runs the plain version
    _window_agree(tn, tv, jn, jv)


def test_window_normals_shuffled_match_jax_and_presorted():
    pts = wavy(4096, 13)
    mask = np.ones(len(pts), bool)
    vp = (0.0, 0.0, 10.0)
    jn, jv = (np.asarray(x) for x in jsh.make_sharded_normals_window(
        jp.make_mesh(8), k=10, viewpoint=vp, tile=128)(jput(pts), jput(mask)))
    tn, tv = (np_of(x) for x in tp.make_sharded_normals_window(
        tmesh(), k=10, viewpoint=vp, tile=128)(pts, mask))
    _window_agree(tn, tv, jn, jv)
    ref_n, ref_v = _presorted_back(pts, mask, 128, vp)
    np.testing.assert_array_equal(tv, ref_v)
    np.testing.assert_array_equal(tn, ref_n)


def test_window_normals_plane_all_valid():
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-2, 2, 4000), rng.uniform(-2, 2, 4000),
                    np.zeros(4000)], -1).astype(np.float32)
    spts, smask, _ = tsh.morton_presort(pts, np.ones(4000, bool), 8, tile=128)
    nrm, valid = (np_of(x) for x in tp.make_sharded_normals_window(
        tmesh(), k=8, viewpoint=(0, 0, 5), tile=128)(spts, smask))
    assert valid[smask].mean() > 0.99
    assert (nrm[valid][:, 2] > 0.99).all()


# ---------------------------------------------------------------------------
# the voxel filter
# ---------------------------------------------------------------------------

def _rows(c, m):
    c = c[m]
    return c[np.lexsort(c.T)]


@pytest.mark.parametrize("voxel", [0.3, 0.1])
def test_sharded_voxel_filter_matches_jax(voxel):
    pts = surface_cloud(2048)
    mask = np.ones(2048, bool)
    mask[::13] = False
    jc, jm = (np.asarray(x) for x in jsh.make_sharded_voxel_filter(
        jp.make_mesh(8), voxel_size=voxel)(jput(pts), jput(mask)))
    tc_, tm = (np_of(x) for x in tp.make_sharded_voxel_filter(tmesh(), voxel)(pts, mask))
    assert tm.sum() == jm.sum()
    np.testing.assert_array_equal(tm, jm)              # packed to the front
    np.testing.assert_allclose(_rows(tc_, tm), _rows(jc, jm), atol=1e-5, rtol=0)
    assert not tc_[~tm].any()


def test_sharded_voxel_filter_cross_shard_merge():
    pts = np.tile(np.array([[0.1, 0.1, 0.1]], np.float32), (1024, 1))
    cent, vmask = (np_of(x) for x in tp.make_sharded_voxel_filter(tmesh(), 1.0)(
        pts, np.ones(1024, bool)))
    assert int(vmask.sum()) == 1 and vmask[0]
    np.testing.assert_allclose(cent[0], [0.1, 0.1, 0.1], atol=1e-6)
