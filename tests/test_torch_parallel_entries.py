"""The port's sharded analysis entries (``make_sharded_ndt``,
``make_sharded_ground``, ``make_sharded_clusters``, ``make_sharded_shot``,
``make_sharded_plane_ransac``, ``make_sharded_mls``,
``make_sharded_colorize``) against the JAX package's on its 8-device
virtual CPU mesh (tests/conftest.py), and against the port's own
single-device entries with tests/test_parallel.py's gates, at that
file's sizes. The port runs on ``make_mesh(8, devices=[cpu] * 8)``.

Stated tolerances (the port's collectives add in rank order, XLA:CPU's
virtual-device psum in its own, so psum'd sums may differ in the last
bits):
* NDT: the transform within 1e-4 of JAX's (the single-device NDT's
  parity, tests/test_torch_ndt.py), the same iteration count, the score
  within 1e-4 relative; JAX's gates against the single-device entry;
* ground: on a street without tied (patch, z) keys the mask equal to
  JAX's on >= 99.9%, patch_valid equal, patch normals within 1e-5 on
  >= 99% of the valid patches and 1e-3 on all (tests/test_torch_ground.py:
  the (P+1, 10) moment tables are psum'd); on a tied street (duplicated
  points, zero-padded rows) every row keeps its own flag and the mask
  agrees with the single-device entry on >= 99%;
* clusters: labels, sizes and the count equal to JAX's;
* SHOT / USC: valid equal to JAX's and to the staged single-device
  path's, descriptor cosine to JAX's >= 0.99999 at the median;
* plane RANSAC: the draws are the port's own (a CPU generator a shard),
  so it is held by JAX's gates and, on the same cloud, the same inlier
  mask as JAX's and a refined plane within 3e-5 of JAX's (each package
  lies 1.4e-5 from the float64 refit of those inliers: the fp32
  covariance sums' rounding);
* MLS: projections within 1e-4 of JAX's on >= 99%;
* colorize: bit-equal to JAX's and to the single-device entry.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threecrate_tpu.parallel as jp
from threecrate_tpu import PointCloud as JCloud
from threecrate_tpu.ops import features as jfeat
from threecrate_tpu.ops import normals as jnormals
from threecrate_tpu.ops import segmentation as jseg
from threecrate_tpu.reconstruction import moving_least_squares as jmls

import threecrate_tpu_torch.parallel as tp
from threecrate_tpu_torch import PointCloud
from threecrate_tpu_torch.ops import colorization as tcol
from threecrate_tpu_torch.ops import features as tfeat
from threecrate_tpu_torch.ops import ground as tground
from threecrate_tpu_torch.ops import ndt as tndt
from threecrate_tpu_torch.ops import segmentation as tseg
from threecrate_tpu_torch.ops.colorization import CameraIntrinsics, InterpolationMode
from threecrate_tpu_torch.reconstruction import moving_least_squares as tmls

torch.set_num_threads(2)   # the suite runs several workers per host

CPU = torch.device("cpu")


def tmesh():
    return tp.make_mesh(8, devices=[CPU] * 8)


def jput(x):
    return jp.put_sharded(jnp.asarray(x), jp.make_mesh(8))


def surface_cloud(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# NDT
# ---------------------------------------------------------------------------

def ndt_pair(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-4, 4, (4096, 2)).astype(np.float32)
    z = 0.5 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])
    pts = (np.column_stack([xy, z]) * 2.0).astype(np.float32)
    return pts, pts + np.array([0.08, -0.05, 0.02], np.float32)


def run_ndt(src, tgt, **kw):
    n = len(src)
    jt, js, ji, jc = jp.make_sharded_ndt(jp.make_mesh(8), **kw)(
        jput(src), jput(np.ones(n, bool)), jput(tgt), jput(np.ones(n, bool)),
        jnp.eye(4, dtype=jnp.float32))
    tt_, ts, ti, tc = tp.make_sharded_ndt(tmesh(), **kw)(
        src, np.ones(n, bool), tgt, np.ones(n, bool), torch.eye(4))
    np.testing.assert_allclose(tt_.numpy(), np.asarray(jt), rtol=0, atol=1e-4)
    assert int(ti) == int(ji) and bool(tc) == bool(jc)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)
    return tt_.numpy()


def test_ndt_matches_jax_and_single_device():
    """JAX's gates: the shift within 0.04 m and the single-device
    ``ndt_registration`` within 2e-3."""
    src, tgt = ndt_pair(21)
    t = run_ndt(src, tgt, resolution=1.0, max_iterations=40, step_size=0.2)
    np.testing.assert_allclose(t[:3, 3], tgt[0] - src[0], atol=0.04)
    ref = tndt.ndt_registration(
        PointCloud.from_numpy(src, device="cpu"), PointCloud.from_numpy(tgt, device="cpu"),
        tndt.NdtConfig(resolution=1.0, max_iterations=40, step_size=0.2, subsample=1))
    np.testing.assert_allclose(t, ref.transformation.numpy(), atol=2e-3)


def test_ndt_subsample_parity():
    """The shard-local coarse stride must not move the answer (JAX's
    gate: 5e-3)."""
    src, tgt = ndt_pair(22)
    outs = [run_ndt(src, tgt, resolution=1.0, max_iterations=40, step_size=0.2,
                    subsample=sub) for sub in (1, 4)]
    np.testing.assert_allclose(outs[0], outs[1], atol=5e-3)


# ---------------------------------------------------------------------------
# ground
# ---------------------------------------------------------------------------

def street(n_total=16384, seed=0):
    rng = np.random.default_rng(seed)
    n_obj = 800
    n_ground = n_total - n_obj
    ang = rng.uniform(0, 2 * np.pi, n_ground)
    r = rng.uniform(2.8, 60, n_ground)
    h = -1.723
    gpts = np.stack([r * np.cos(ang), r * np.sin(ang), h + rng.normal(0, 0.03, n_ground)], -1)
    objs = []
    for cx, cy in rng.uniform(-30, 30, (10, 2)):
        if np.hypot(cx, cy) < 4:
            continue
        objs.append(np.stack([cx + rng.uniform(-1, 1, 100), cy + rng.uniform(-1, 1, 100),
                              h + rng.uniform(0.3, 2.0, 100)], -1))
    opts = np.concatenate(objs)[:n_obj]
    pts = np.concatenate([gpts, opts]).astype(np.float32)
    return pts, np.concatenate([np.ones(n_ground, bool), np.zeros(len(opts), bool)])


def patch_z_keys(pts):
    """Each row's (CZM patch, z bits): the block sort's two keys."""
    cfg = tground.PatchworkConfig()
    tables = [torch.from_numpy(t) for t in tground._patch_tables(cfg)]
    pid = tground._patch_ids(torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool),
                             *tables, len(cfg.rings_per_zone)).numpy()
    return np.stack([np.where(pid >= 0, pid, cfg.n_patches), pts[:, 2].view(np.int32)], 1)


def test_ground_matches_jax_and_single_device():
    pts, truth = street()
    assert len(np.unique(patch_z_keys(pts), axis=0)) == len(pts)   # no tied keys
    mask = np.ones(len(pts), bool)
    jg, jok, jn = (np.asarray(x) for x in jp.make_sharded_ground(jp.make_mesh(8))(
        jput(pts), jput(mask)))
    g, ok, nrm = tp.make_sharded_ground(tmesh())(pts, mask)
    assert isinstance(g, tp.Sharded)
    g, ok, nrm = g.numpy(), ok.numpy(), nrm.numpy()
    assert (g == jg).mean() >= 0.999
    np.testing.assert_array_equal(ok, jok)
    dn = np.abs(nrm[ok] - jn[ok]).max(1)
    assert (dn <= 1e-5).mean() >= 0.99 and dn.max() <= 1e-3
    # JAX's gates against the single-device entry and the truth
    ref = tground.patchwork_plus_plus(PointCloud.from_numpy(pts, device="cpu"))
    want = ref.ground_mask.numpy()
    assert (g == want).mean() > 0.99
    assert g[truth].mean() > 0.85 and truth[g].mean() > 0.9
    both = ok & ref.patch_valid.numpy()
    assert both.sum() > 50
    cos = np.abs((nrm[both] * ref.patch_normals.numpy()[both]).sum(-1))
    assert np.median(cos) > 0.999


def tied_street():
    """The street with 2,048 of its points repeated (equal patch and z,
    shuffled so twins land on different shards) and 1,024 zero-padded,
    masked rows (one tied key run in the overflow bucket)."""
    pts, truth = street()
    rng = np.random.default_rng(4)
    dup = rng.choice(len(pts), 2048, replace=False)
    pts = np.concatenate([pts, pts[dup], np.zeros((1024, 3), np.float32)])
    truth = np.concatenate([truth, truth[dup], np.zeros(1024, bool)])
    mask = np.concatenate([np.ones(len(pts) - 1024, bool), np.zeros(1024, bool)])
    twin = np.concatenate([np.arange(16384), dup, np.arange(16384 + 2048, len(pts))])
    order = rng.permutation(len(pts))
    inv = np.argsort(order)
    return pts[order], mask[order], truth[order], inv[twin[order]]


def test_ground_on_tied_keys_keeps_every_row():
    """Where (patch, z) keys tie across a block-sort partner boundary the
    port's stable block sort keeps every row, so each row gets its own
    flag: twins (equal points) get equal flags, padding none, a permuted
    input gives the permuted mask, and the mask agrees with the
    single-device entry on >= 99%."""
    pts, mask, truth, twin = tied_street()
    fn = tp.make_sharded_ground(tmesh())
    g = fn(pts, mask)[0].numpy()
    np.testing.assert_array_equal(g, g[twin])
    assert not g[~mask].any()
    ref = tground.patchwork_plus_plus(PointCloud.from_points(torch.from_numpy(pts),
                                                             torch.from_numpy(mask)))
    assert (g == ref.ground_mask.numpy()).mean() >= 0.99
    assert g[truth].mean() > 0.85
    perm = np.random.default_rng(5).permutation(len(pts))
    assert (fn(pts[perm], mask[perm])[0].numpy() == g[perm]).mean() >= 0.999


# ---------------------------------------------------------------------------
# clusters
# ---------------------------------------------------------------------------

def run_clusters(pts, mask, cfg_kw):
    jl, jn, js = jp.make_sharded_clusters(jp.make_mesh(8), jseg.EuclideanClusterConfig(
        **cfg_kw))(jput(pts), jput(mask))
    tl, tn, ts = tp.make_sharded_clusters(tmesh(), tseg.EuclideanClusterConfig(**cfg_kw))(
        pts, mask)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tn) == int(jn)
    return tl.numpy(), int(tn), ts.numpy()


def test_clusters_match_jax_and_single_device():
    rng = np.random.default_rng(3)
    centers = np.array([[0, 0, 0], [5, 0, 0], [0, 5, 0], [5, 5, 0], [2.5, 2.5, 4]],
                       np.float32)
    pts = np.concatenate([c + rng.normal(0, 0.15, (816, 3)) for c in centers]).astype(
        np.float32)
    rng.shuffle(pts)
    mask = np.ones(len(pts), bool)
    mask[::97] = False
    cfg = dict(tolerance=0.35, max_neighbors=24, min_cluster_size=10)
    labels, n, sizes = run_clusters(pts, mask, cfg)
    ref = tseg.extract_euclidean_clusters(
        PointCloud.from_points(torch.from_numpy(pts), torch.from_numpy(mask)),
        tseg.EuclideanClusterConfig(**cfg))
    assert n == int(ref.n_clusters) == 5
    np.testing.assert_array_equal(labels, ref.labels.numpy())
    np.testing.assert_array_equal(sizes, ref.sizes.numpy())


def test_clusters_size_filter_and_noise():
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.normal(0, 0.1, (512, 3)), [[9.0, 9, 9], [9.02, 9, 9]],
                          [[-9.0, -9, -9]], rng.normal(0, 0.1, (509, 3)) + 20]).astype(
        np.float32)
    labels, n, sizes = run_clusters(pts, np.ones(len(pts), bool),
                                    dict(tolerance=0.3, max_neighbors=32, min_cluster_size=5))
    assert n == 2 and (labels[512:515] == -1).all()
    assert sizes[0] == 512 and sizes[1] == 509 and sizes[2] == 0


# ---------------------------------------------------------------------------
# plane RANSAC
# ---------------------------------------------------------------------------

def test_plane_ransac_recovers_dominant_plane():
    rng = np.random.default_rng(7)
    uv = rng.uniform(-2, 2, (3000, 2)).astype(np.float32)
    z = 0.3 * uv[:, 0] - 0.2 * uv[:, 1] + 0.5
    plane = np.stack([uv[:, 0], uv[:, 1], z + rng.normal(0, 0.002, 3000)], -1)
    pts = np.concatenate([plane, rng.uniform(-3, 3, (1096, 3))]).astype(np.float32)
    order = rng.permutation(len(pts))
    pts, on_plane = pts[order], order < 3000
    mask = np.ones(len(pts), bool)
    res = tp.make_sharded_plane_ransac(tmesh(), distance_threshold=0.01, max_iterations=512)(
        pts, mask, seed=1)
    assert isinstance(res, tseg.PlaneSegmentationResult)
    nrm = res.model.normal.numpy()
    expect = np.array([-0.3, 0.2, 1.0]) / np.linalg.norm([-0.3, 0.2, 1.0])
    assert abs(float(nrm @ expect)) > 0.9999
    inl = res.inlier_mask.numpy()
    assert inl[on_plane].mean() > 0.98 and inl[~on_plane].mean() < 0.02
    assert int(res.inlier_count) == inl.sum()
    # JAX's refined plane on the same cloud: both refine on the same
    # inlier set, each within 2e-5 of its float64 refit (the fp32
    # covariance sums' rounding, 1.4e-5 in each package), so within 3e-5
    # of each other
    jres = jp.make_sharded_plane_ransac(jp.make_mesh(8), distance_threshold=0.01,
                                        max_iterations=512)(jput(pts), jput(mask), seed=1)
    np.testing.assert_array_equal(inl, np.asarray(jres.inlier_mask))
    jn, jd = np.asarray(jres.model.normal), float(jres.model.d)
    sign = np.sign(float(nrm @ jn))
    np.testing.assert_allclose(nrm * sign, jn, rtol=0, atol=3e-5)
    assert abs(float(res.model.d) * sign - jd) <= 3e-5
    c = pts[inl].astype(np.float64) - pts[inl].astype(np.float64).mean(0)
    exact = np.linalg.eigh(c.T @ c)[1][:, 0]
    for got in (nrm, jn):
        np.testing.assert_allclose(got * np.sign(got @ exact), exact, rtol=0, atol=2e-5)
    # the draws come from the seed: a second call repeats every bit
    again = tp.make_sharded_plane_ransac(tmesh(), distance_threshold=0.01,
                                         max_iterations=512)(pts, mask, seed=1)
    assert torch.equal(again.model.normal, res.model.normal)


def test_plane_ransac_masked_and_degenerate_shards():
    rng = np.random.default_rng(11)
    n = 2048
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.25 + rng.normal(0, 0.001, n).astype(np.float32)
    mask = np.ones(n, bool)
    mask[: n // 8] = False          # shard 0 has no valid point
    res = tp.make_sharded_plane_ransac(tmesh(), distance_threshold=0.01,
                                       max_iterations=256)(pts, mask)
    assert abs(res.model.normal.numpy()[2]) > 0.99999
    inl = res.inlier_mask.numpy()
    assert not inl[: n // 8].any() and inl[n // 8:].mean() > 0.99
    jres = jp.make_sharded_plane_ransac(jp.make_mesh(8), distance_threshold=0.01,
                                        max_iterations=256)(jput(pts), jput(mask))
    np.testing.assert_array_equal(inl, np.asarray(jres.inlier_mask))


# ---------------------------------------------------------------------------
# SHOT / USC
# ---------------------------------------------------------------------------

def shot_cloud(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.5 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    pts = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    jc = jnormals.estimate_normals(JCloud(points=jnp.asarray(pts), mask=jnp.ones(n, bool)),
                                   k=10, viewpoint=(0.0, 0.0, 10.0))
    return pts, np.array(jc.normals)


@pytest.mark.parametrize("variant, n, seed, radius, k", [("shot", 2048, 9, 0.35, 48),
                                                         ("usc", 1024, 4, 0.4, 32)])
def test_shot_matches_jax_and_staged_single_device(variant, n, seed, radius, k):
    pts, nrm = shot_cloud(n, seed)
    mask = np.ones(n, bool)
    jd, jv = (np.asarray(x) for x in jp.make_sharded_shot(
        jp.make_mesh(8), jfeat.ShotConfig(radius=radius, max_neighbors=k, method="exact"),
        variant=variant)(jput(pts), jput(mask), jput(nrm)))
    cfg = tfeat.ShotConfig(radius=radius, max_neighbors=k, method="exact")
    d, v = tp.make_sharded_shot(tmesh(), cfg, variant=variant)(pts, mask, nrm)
    d, v = d.numpy(), v.numpy()
    assert d.shape[1] == (352 if variant == "shot" else 128)
    np.testing.assert_array_equal(v, jv)
    cos = np.sum(d[v] * jd[v], -1)
    assert np.median(cos) > 0.99999 and (cos > 0.99).mean() > 0.98
    cloud = PointCloud.from_numpy(pts, device="cpu").with_normals(torch.from_numpy(nrm))
    ref = (tfeat.extract_shot_features(cloud, cfg) if variant == "shot"
           else tfeat.extract_usc_features(cloud, cfg))
    rv = ref.valid.numpy()
    np.testing.assert_array_equal(v, rv)
    cos = np.sum(d[v] * ref.descriptors.numpy()[v], -1)
    assert np.median(cos) > 0.99999 and (cos > 0.99).mean() > 0.98


def test_shot_refuses_bad_variant_and_leading_dims():
    for make, mesh in ((jp.make_sharded_shot, jp.make_mesh(8)),
                       (tp.make_sharded_shot, tmesh())):
        with pytest.raises(ValueError, match="variant must be 'shot' or 'usc', got fpfh"):
            make(mesh, variant="fpfh")
    pts = surface_cloud(64)
    with pytest.raises(ValueError, match="points/mask/normals leading dims differ"):
        tp.make_sharded_shot(tmesh())(pts, np.ones(128, bool), pts)


# ---------------------------------------------------------------------------
# MLS
# ---------------------------------------------------------------------------

def test_mls_matches_jax_and_single_device():
    rng = np.random.default_rng(3)
    pts = surface_cloud(2048, 3) + rng.normal(0, 0.01, (2048, 3)).astype(np.float32)
    mask = np.ones(len(pts), bool)
    jproj, jn, jv = (np.asarray(x) for x in jp.make_sharded_mls(
        jp.make_mesh(8), jmls.MlsConfig(search_radius=0.35, max_neighbors=24))(
        jput(pts), jput(mask)))
    cfg = tmls.MlsConfig(search_radius=0.35, max_neighbors=24)
    proj, nrm, valid = (x.numpy() for x in tp.make_sharded_mls(tmesh(), cfg)(pts, mask))
    np.testing.assert_array_equal(valid, jv)
    assert (np.abs(proj - jproj).max(1) < 1e-4).mean() >= 0.99
    ref = tmls.mls_smooth(PointCloud.from_numpy(pts, device="cpu"), cfg).points.numpy()
    assert (np.abs(proj - ref).max(1) < 1e-4).mean() > 0.98
    assert valid.sum() > 0.95 * len(pts)
    np.testing.assert_allclose(np.linalg.norm(nrm[valid], axis=1), 1.0, atol=1e-3)


def test_mls_scale_invariance():
    pts = surface_cloud(1024, 7)
    mesh = tmesh()
    for scale in (1e-3, 1.0, 1e3):
        cfg = tmls.MlsConfig(search_radius=0.35 * scale, max_neighbors=24)
        proj, _, _ = tp.make_sharded_mls(mesh, cfg)(pts * scale, np.ones(len(pts), bool))
        assert np.abs(proj.numpy() / scale - pts).max() < 0.2, scale


# ---------------------------------------------------------------------------
# colorize
# ---------------------------------------------------------------------------

def test_colorize_matches_jax_and_single_device():
    rng = np.random.default_rng(5)
    n, h, w = 1024, 48, 64
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    imgs, intrs, w2cs = [], [], []
    for i in range(3):
        imgs.append(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
        intrs.append([40.0, 40.0, w / 2 + 4 * i, h / 2])
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = 0.3 * i
        w2cs.append(m)
    imgs, intrs, w2cs = np.stack(imgs), np.asarray(intrs, np.float32), np.stack(w2cs)
    mask = np.ones(n, bool)
    jc, ja = (np.asarray(x) for x in jp.make_sharded_colorize(
        jp.make_mesh(8), h, w, bilinear=True)(jput(pts), jput(mask), jnp.asarray(imgs),
                                              jnp.asarray(intrs), jnp.asarray(w2cs)))
    c, a = (x.numpy() for x in tp.make_sharded_colorize(tmesh(), h, w, bilinear=True)(
        pts, mask, imgs, intrs, w2cs))
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(c, jc)
    assert a.sum() > 0.5 * n and not c[~a].any()
    views = [tcol.RgbImageView(torch.from_numpy(imgs[i]), CameraIntrinsics(*intrs[i]),
                               torch.from_numpy(w2cs[i])) for i in range(3)]
    ref = tcol.colorize_from_images(PointCloud.from_numpy(pts, device="cpu"), views,
                                    mode=InterpolationMode.BILINEAR)
    np.testing.assert_array_equal(c[a], ref.colors.numpy()[a])


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------

def test_parallel_names_cover_jax():
    assert set(jp.__all__) <= set(tp.__all__)
    assert all(hasattr(tp, name) for name in tp.__all__)
    assert "Not ported" not in tp.__doc__


NEW_NAMES = ["make_sharded_tsdf", "make_sharded_ndt", "make_sharded_ground",
             "make_sharded_clusters", "make_sharded_shot", "make_sharded_plane_ransac",
             "make_sharded_mls", "make_sharded_colorize", "make_sharded_mg_solver",
             "make_sharded_poisson_fields", "make_sharded_poisson",
             "ShardedFrameToModelOdometry"]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_factory_signature_matches_jax(name):
    """Parameter names, kinds and defaults equal to JAX's (the return
    annotations name each package's own types)."""
    def params(obj):
        sig = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
        return [(p.name, p.kind, p.default) for p in sig.parameters.values()]

    assert params(getattr(tp, name)) == params(getattr(jp, name))


def test_tsdf_carriers_match_jax():
    assert tp.ShardedTsdf._fields == jp.ShardedTsdf._fields
    assert tp.ShardedTsdfState._fields == jp.ShardedTsdfState._fields
    assert tp.ShardedTsdf._field_defaults == {"raycast": None} == jp.ShardedTsdf._field_defaults
