"""The port's sharded feature → pose chain (ring kNN with a payload, the
ring row gather, sharded FPFH, descriptor matching and the sharded
FPFH + RANSAC registration) against the JAX package's on its 8-device
virtual CPU mesh, the port on ``make_mesh(8, devices=[cpu] * 8)``.

Stated tolerances:
* the payload ring: ids and payload rows equal, squared distances within
  2e-6 (two fp32 ulps of ‖q‖² + ‖p‖², as tests/test_torch_parallel.py);
  the row gather equal;
* FPFH: validity equal, descriptors within 0.1 (1e-3 of the ×100 scale
  of each sub-histogram) on >= 98% of the points and a median cosine of
  0.9999. The rest (15 of 1,024 here) weight a neighbour by 1/d where d
  comes from the expanded d² ‖q‖² + ‖p‖² − 2 q·p, whose rounding XLA
  fuses differently from one program to another: the port copies the
  fusion of JAX's rings (its d² bit-equal on 90-100% of pairs), so a
  close pair's 1/d, and with it the row, can differ;
* matching: ids and matched points equal, distances within 1e-3 (as
  tests/test_parallel.py holds JAX's against its single-device match);
* global registration: rotation and translation within 5e-3 of the truth
  (tests/test_parallel.py's bound); the RANSAC draws differ (one
  ``torch.Generator`` a shard against JAX's folded keys), so the pose is
  held to the truth, and to JAX's within the same bound.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map as jshard_map
from jax.sharding import PartitionSpec as JP

import threecrate_tpu.parallel as jp
from threecrate_tpu import PointCloud
from threecrate_tpu.ops import normals as jnormals
from threecrate_tpu.parallel import sharded as jsh

import threecrate_tpu_torch.parallel as tp
from threecrate_tpu_torch.parallel import collectives as tcol
from threecrate_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)   # the suite runs several workers per host

CPU = torch.device("cpu")


def tmesh():
    return tp.make_mesh(8, devices=[CPU] * 8)


def jput(x):
    return jp.put_sharded(jnp.asarray(x), jp.make_mesh(8))


def np_of(x):
    return x.numpy() if isinstance(x, (tp.Sharded, torch.Tensor)) else np.asarray(x)


def surface_cloud(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


@pytest.fixture(scope="module")
def cloud_with_normals():
    pts = surface_cloud(1024)
    nrm = np.asarray(jnormals.estimate_normals(PointCloud.from_numpy(pts), k=10).normals)
    return pts, nrm


@pytest.mark.parametrize("k", [1, 3, 20])
def test_ring_knn_payload_matches_jax(k):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(512, 33)).astype(np.float32)
    db = rng.normal(size=(768, 33)).astype(np.float32)
    pay = rng.normal(size=(768, 3)).astype(np.float32)
    dbm = rng.uniform(size=768) > 0.1

    @functools.partial(jshard_map, mesh=jp.make_mesh(8), in_specs=(JP("points"),) * 4,
                       out_specs=(JP("points"),) * 4, check_vma=False)
    def run(qs, ds, ms, ps):
        return jsh.ring_knn_payload_local(qs, ds, ms, ps, k, "points")

    jneg, jrows, jpay, jidx = (np.asarray(x) for x in run(jput(q), jput(db), jput(dbm),
                                                          jput(pay)))
    mesh = tmesh()
    body = functools.partial(tsh.ring_knn_payload_local, k=k, axis_name="points", mesh=mesh)
    tneg, trows, tpay, tidx = (np_of(x) for x in tcol.shard_map(
        body, mesh, (tp.P("points"),) * 4, (tp.P("points"),) * 4)(q, db, dbm, pay))
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(trows, jrows)
    np.testing.assert_array_equal(tpay, jpay)
    np.testing.assert_allclose(tneg, jneg, atol=2e-6 * 66, rtol=0)   # ‖q‖² + ‖p‖² ~ 66


def test_ring_gather_rows_matches_jax():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(1024, 33)).astype(np.float32)
    ids = rng.integers(0, 1024, (1024, 7)).astype(np.int32)

    @functools.partial(jshard_map, mesh=jp.make_mesh(8), in_specs=(JP("points"),) * 2,
                       out_specs=JP("points"), check_vma=False)
    def run(i, t):
        return jsh.ring_gather_rows_local(i, t, "points")

    ref = np.asarray(run(jput(ids), jput(table)))
    mesh = tmesh()
    got = tcol.shard_map(
        lambda i, t: tsh.ring_gather_rows_local([x.long() for x in i], t, "points", mesh=mesh),
        mesh, (tp.P("points"),) * 2, tp.P("points"))(ids, table)
    np.testing.assert_array_equal(np_of(got), ref)
    np.testing.assert_array_equal(ref, table[ids])


def test_sharded_fpfh_matches_jax(cloud_with_normals):
    pts, nrm = cloud_with_normals
    ones = np.ones(len(pts), bool)
    jd, jv = (np.asarray(x) for x in jsh.make_sharded_fpfh(jp.make_mesh(8), 0.5, k=64)(
        jput(pts), jput(ones), jput(nrm)))
    td, tv = (np_of(x) for x in tp.make_sharded_fpfh(tmesh(), 0.5, k=64)(pts, ones, nrm))
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 900
    err = np.abs(td - jd).max(1)
    assert np.mean(err <= 0.1) >= 0.98, np.sort(err)[-30:]
    na = td[tv] / np.linalg.norm(td[tv], axis=1, keepdims=True)
    nb = jd[tv] / np.linalg.norm(jd[tv], axis=1, keepdims=True)
    assert np.median((na * nb).sum(1)) >= 0.9999
    blocks = td[tv].reshape(-1, 3, 11).sum(-1)
    np.testing.assert_allclose(blocks, 100.0, rtol=1e-5)


def test_sharded_match_descriptors_matches_jax():
    rng = np.random.default_rng(5)
    da = rng.normal(size=(512, 33)).astype(np.float32)
    db = rng.normal(size=(768, 33)).astype(np.float32)
    tgt = rng.normal(size=(768, 3)).astype(np.float32)
    va = rng.uniform(size=512) > 0.05
    vb = rng.uniform(size=768) > 0.05
    j = [np.asarray(x) for x in jsh.make_sharded_match_descriptors(jp.make_mesh(8))(
        jput(da), jput(va), jput(db), jput(vb), jput(tgt))]
    t = [np_of(x) for x in tp.make_sharded_match_descriptors(tmesh())(da, va, db, vb, tgt)]
    assert t[0].dtype == np.int32
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(np.isinf(t[1]), np.isinf(j[1]))
    fin = np.isfinite(j[1])
    np.testing.assert_allclose(t[1][fin], j[1][fin], atol=1e-3)
    np.testing.assert_array_equal(t[3][t[2]], tgt[t[0][t[2]]])


@pytest.fixture(scope="module")
def registration_case():
    n = 2048
    pts = surface_cloud(n, seed=7)
    ang = 0.35
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                    [0, 0, 1]], np.float32)
    tvec = np.array([0.8, -0.5, 0.2], np.float32)
    tgt = (pts @ rot.T + tvec).astype(np.float32)
    cfg = dict(fpfh_radius=0.5, k_fpfh=48, distance_threshold=0.1,
               hypotheses_per_device=512, query_stride=2, refine_iterations=20)
    ones = np.ones(n, bool)
    jt, jc, jr = (np.asarray(x) for x in jsh.make_sharded_global_registration(
        jp.make_mesh(8), **cfg)(jput(pts), jput(ones), jput(tgt), jput(ones)))
    return pts, tgt, rot, tvec, cfg, jt


def test_sharded_global_registration_recovers(registration_case):
    pts, tgt, rot, tvec, cfg, jt = registration_case
    ones = np.ones(len(pts), bool)
    t, count, ratio = tp.make_sharded_global_registration(tmesh(), **cfg)(pts, ones, tgt, ones)
    assert t.shape == (4, 4) and count.dtype == torch.int32
    t = t.numpy()
    assert np.abs(t[:3, :3] - rot).max() < 5e-3
    assert np.abs(t[:3, 3] - tvec).max() < 5e-3
    assert np.abs(t - jt).max() < 5e-3
    assert float(ratio) > 0.3


def test_shard_seed_is_stated_and_distinct():
    seeds = [tsh.shard_seed(0, me) for me in range(8)]
    assert len(set(seeds)) == 8
    assert seeds[3] == int(np.random.SeedSequence([0, 3]).generate_state(1, np.uint64)[0])
    assert tsh.shard_seed(1, 0) != seeds[0]
