"""SHOT and USC descriptors: the PyTorch port against the JAX package.

On the CPU the port's SHOT kernel wrappers run their plain PyTorch
versions; the JAX fused path runs its Pallas kernels in interpret mode.
Both sides get the same points and normals (a smooth height field with
its analytic normals, from a numpy seed). The JAX results are computed
once per module and variant: the interpret-mode histogram sweep costs
tens of seconds to compile.

Stated tolerances:
* ``weighted_covariance``: within 1e-5 relative (fp32 sums in another
  order);
* ``_lrf_signs``: the same signs on every row (the same fp32 operations
  in the same order, ``R³`` as two fp32 products on both sides);
* ``_shot_lrf``: each axis within 1e-3 of the JAX axis on >= 99% of
  points (the 3x3 eigensolve differs in the last bits; a sign vote at
  the tie threshold may flip);
* ``_shot_fused`` and ``_shot`` (SHOT and USC): valid flags equal on
  >= 99%, descriptor cosine >= 0.999 on >= 97% of the points valid on
  both (a near-zero sign vote may flip under last-bit differences,
  which permutes the descriptor, as tests/test_features.py records for
  the JAX package itself).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.ops import features as jf  # noqa: E402
from threecrate_tpu.ops import linalg as jla  # noqa: E402
from threecrate_tpu.ops import neighbors as jn  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop, kernels  # noqa: E402
from threecrate_tpu_torch.kernels import shot as tk  # noqa: E402
from threecrate_tpu_torch.ops import features as tf  # noqa: E402
from threecrate_tpu_torch.ops import linalg as tla  # noqa: E402
from threecrate_tpu_torch.ops import normals as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

N, RADIUS, TILE, BAND = 2048, 0.2, 128, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _surface(n, seed):
    """A smooth height field with its analytic unit normals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    nrm = np.stack([-0.8 * np.cos(xy[:, 0] * 2.0), 0.51 * np.sin(xy[:, 1] * 1.7),
                    np.ones(n)], -1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32), nrm.astype(np.float32)


def _cloud(n=N, seed=0):
    pts, nrm = _surface(n, seed)
    mask = np.ones(n, bool)
    mask[::41] = False
    return pts, nrm, mask


def _assert_descriptors_close(td, tv, jd, jv, min_valid=0.8):
    assert np.mean(tv == jv) >= 0.99
    both = tv & jv
    assert both.mean() > min_valid
    cos = (td[both] * jd[both]).sum(1)
    assert np.mean(cos >= 0.999) >= 0.97, np.quantile(cos, [0.01, 0.03, 0.5])
    np.testing.assert_allclose(np.linalg.norm(td[tv], axis=1), 1.0, atol=1e-5)
    assert (td[~tv] == 0).all()


# ------------------------------------------------------- LRF pieces


def test_weighted_covariance_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 2, (64, 20, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (64, 20)).astype(np.float32)
    w[:, ::3] = 0
    w[5] = 0                                 # no weight: mean 0 / eps guard
    jm, jc = jla.weighted_covariance(jnp.asarray(pts), jnp.asarray(w))
    tm, tcov = tla.weighted_covariance(_t(pts), _t(w))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_normals", [True, False])
def test_lrf_signs_match_jax(with_normals):
    rng = np.random.default_rng(1)
    n = 4096
    sd, td, z, x, nq = (rng.normal(0, 1, (n, 3)).astype(np.float32) for _ in range(5))
    sd[::4] *= 1e-3                          # ambiguous votes take the tie-breaks
    wsum = rng.uniform(0.5, 20, n).astype(np.float32)
    nq = nq if with_normals else None
    jz, jx = jf._lrf_signs(jnp.asarray(sd), jnp.asarray(td), jnp.asarray(wsum),
                           jnp.float32(0.3), jnp.asarray(z), jnp.asarray(x),
                           None if nq is None else jnp.asarray(nq))
    tz, tx = tf._lrf_signs(_t(sd), _t(td), _t(wsum), float(np.float32(0.3)), _t(z), _t(x),
                           None if nq is None else _t(nq))
    for got, ref in ((tz, jz), (tx, jx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def neighbourhoods():
    """The exact radius search of the JAX package on the test cloud, fed
    to both sides' LRF."""
    pts, nrm, mask = _cloud()
    res = jn.radius_neighbors(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts),
                              jnp.asarray(mask), RADIUS, 32, exclude_self=True)
    return pts, nrm, mask, np.asarray(res.indices), np.asarray(res.mask), \
        np.asarray(res.distances)


@pytest.mark.parametrize("with_normals", [True, False])
def test_shot_lrf_matches_jax(neighbourhoods, with_normals):
    pts, nrm, mask, idx, ok, dist = neighbourhoods
    own_n = nrm if with_normals else None
    jx = jf._shot_lrf(jnp.asarray(pts[idx]), jnp.asarray(ok), jnp.asarray(dist),
                      jnp.float32(RADIUS), jnp.asarray(pts),
                      None if own_n is None else jnp.asarray(own_n))
    tx = tf._shot_lrf(_t(pts[idx]), _t(ok), _t(dist), float(np.float32(RADIUS)), _t(pts),
                      None if own_n is None else _t(own_n))
    well = mask & (ok.sum(1) >= 5)
    close = np.ones(N, bool)
    for got, ref in zip(tx, jx):
        close &= np.abs(got.numpy() - np.asarray(ref)).max(1) <= 1e-3
    assert close[well].mean() >= 0.99, close[well].mean()


# --------------------------------------------------- descriptor paths


@pytest.fixture(scope="module", params=["shot", "usc"])
def fused_case(request):
    variant = request.param
    pts, nrm, mask = _cloud()
    if variant == "usc":
        nrm = np.zeros_like(nrm)
    jd, jv = jf._shot_fused(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm),
                            RADIUS, variant, band=BAND, tile=TILE)
    kernels.reset_launch_counts()
    td, tv = tf._shot_fused(_t(pts), _t(mask), _t(nrm), RADIUS, variant, band=BAND,
                            tile=TILE)
    assert sum(kernels.launch_counts().values()) == 0        # plain versions on the CPU
    return variant, td.numpy(), tv.numpy(), np.asarray(jd), np.asarray(jv), mask


def test_fused_shot_matches_jax(fused_case):
    variant, td, tv, jd, jv, mask = fused_case
    dim = tf.SHOT_DIM if variant == "shot" else tf.USC_DIM
    assert td.shape == jd.shape == (N, dim)
    assert not tv[~mask].any() and tv.mean() > 0.9
    _assert_descriptors_close(td, tv, jd, jv)


@pytest.mark.parametrize("variant,window", [("shot", False), ("usc", False),
                                            ("shot", True)])
def test_staged_shot_matches_jax(variant, window):
    """The staged ``_shot`` (capped radius search, true atan2, one-hot or
    scatter histograms), exact or on the window search."""
    pts, nrm, mask = _cloud(1024, 3)
    if variant == "usc":
        nrm = np.zeros_like(nrm)
    r = 0.3
    jd, jv = jf._shot(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm),
                      jnp.float32(r), 16, 11, variant, window)
    td, tv = tf._shot(_t(pts), _t(mask), _t(nrm), r, 16, 11, variant, window)
    _assert_descriptors_close(td.numpy(), tv.numpy(), np.asarray(jd), np.asarray(jv))


def test_fused_vs_staged_on_a_lidar_crop():
    """2,048 points of a ground-plus-structure LiDAR scan (``bench``'s
    generator; a 5 cm-thick ground slab, denser than the ±band windows
    cover at this radius). The port's fused and staged paths each match
    the JAX package's, so the two packages' fused paths stand as far from
    their staged paths; where both ±band windows hold a point's whole
    neighbourhood (the same in-radius count as the exact search), the
    fused descriptor equals the staged one up to the polynomial atan2
    (median cosine >= 0.99)."""
    from bench import _kitti_like
    pts = _kitti_like(1_000_000, 3)
    pts = pts[(pts[:, 0] > 10) & (pts[:, 0] < 13) & (np.abs(pts[:, 1]) < 1.5)][:N]
    mask = np.ones(N, bool)
    nrm = tn.estimate_normals_detailed(tt.PointCloud.from_numpy(pts, device="cpu"))
    nrm = nrm.normals.numpy()
    fused = [jf._shot_fused(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm), RADIUS,
                            "shot", band=BAND, tile=TILE),
             tf._shot_fused(_t(pts), _t(mask), _t(nrm), RADIUS, "shot", band=BAND, tile=TILE)]
    staged = [jf._shot(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm),
                       jnp.float32(RADIUS), 128, 11, "shot", False),
              tf._shot(_t(pts), _t(mask), _t(nrm), RADIUS, 128, 11, "shot")]
    (jfd, jfv), (tfd, tfv), (jsd, jsv), (tsd, tsv) = (
        tuple(np.asarray(a) for a in r) for r in fused + staged)
    # lifted points with fewer than 5 neighbours are not valid (~28% here)
    _assert_descriptors_close(tfd, tfv, jfd, jfv, min_valid=0.6)
    _assert_descriptors_close(tsd, tsv, jsd, jsv, min_valid=0.6)
    # in-radius candidates of the two ±band windows, from the plain moment passes
    r2 = RADIUS * RADIUS
    pa, pb, row_a, perm_a = tf.fused_stage1_inputs(_t(pts), _t(mask), _t(nrm), TILE)
    cnt = tk.shot_moments_a_plain(pa[0:4], r2, BAND, TILE)[10]
    cnt[row_a] += tk.shot_moments_b_plain(
        torch.cat([pb[0:4], row_a.to(torch.float32)[None]]), r2, BAND, TILE)[10]
    band_cnt = np.empty(N, np.float32)
    band_cnt[perm_a.numpy()] = cnt.numpy()
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    exact_cnt = (d2 <= np.float32(RADIUS) ** 2).sum(1) - 1
    both = tfv & tsv
    fits = both & (band_cnt == exact_cnt)
    cos = (tfd * tsd).sum(1)
    assert fits.sum() >= 50 and np.median(cos[fits]) >= 0.99, np.median(cos[fits])
    assert np.median(cos[both & ~fits]) < np.median(cos[fits])


# ------------------------------------------------------- public entries


def _spy_routes(monkeypatch, module):
    seen = []

    def fused(points, mask, normals_arr, radius, variant="shot", band=32, tile=256):
        seen.append(("fused", variant, band))
        n = points.shape[0]
        return _zeros(module, n, variant), _zeros(module, n, None)

    def staged(points, mask, normals_arr, radius, max_neighbors, n_cos_bins, variant,
               window=False):
        seen.append(("staged", variant, max_neighbors, n_cos_bins, bool(window)))
        n = points.shape[0]
        return _zeros(module, n, variant), _zeros(module, n, None)

    monkeypatch.setattr(module, "_shot_fused", fused)
    monkeypatch.setattr(module, "_shot", staged)
    return seen


def _zeros(module, n, variant):
    shape = (n,) if variant is None else (n, 352 if variant == "shot" else 128)
    if module is tf:
        return torch.zeros(shape, dtype=torch.bool if variant is None else torch.float32)
    return jnp.zeros(shape, bool if variant is None else jnp.float32)


CONFIGS = [dict(), dict(method="window"), dict(method="window", n_cos_bins=9),
           dict(method="exact"), dict(method="window", band=48, max_neighbors=64)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: ",".join(f"{k}={v}" for k, v in
                                                                  c.items()) or "default")
def test_entries_route_as_jax(monkeypatch, cfg):
    """extract_shot_features / extract_usc_features take the same path
    with the same arguments as the JAX package's for each config."""
    pts, nrm, mask = _cloud(512, 4)
    jc = tc.PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                       attrs={"normals": jnp.asarray(nrm)})
    pc = interop.cloud_from_numpy(pts, mask, {"normals": nrm}, device="cpu")
    jcfg = jf.ShotConfig(**cfg)
    routes = []
    for module, cloud, config in ((jf, jc, jcfg), (tf, pc, interop.shot_config_from(jcfg))):
        seen = _spy_routes(monkeypatch, module)
        module.extract_shot_features(cloud, config)
        module.extract_usc_features(cloud, config)
        routes.append(seen)
    assert routes[0] == routes[1] and len(routes[1]) == 2


def test_auto_takes_the_fused_path_above_the_threshold(monkeypatch):
    seen = _spy_routes(monkeypatch, tf)
    pts, nrm, mask = _cloud(512, 5)
    pc = interop.cloud_from_numpy(pts, mask, {"normals": nrm}, device="cpu")
    tt.extract_shot_features(pc)
    monkeypatch.setattr(tf, "FUSED_SHOT_THRESHOLD", 256)
    tt.extract_shot_features(pc)
    tt.extract_usc_features(pc)
    assert [s[0] for s in seen] == ["staged", "fused", "fused"]


def test_shot_estimates_missing_normals_and_configs_match():
    pts, _, _ = _cloud(600, 6)
    pc = tt.PointCloud.from_numpy(pts, device="cpu")
    res = tt.extract_shot_features(pc, tt.ShotConfig(radius=0.4))
    assert res.descriptors.shape == (pc.capacity, tt.SHOT_DIM)
    assert res.valid.float().sum() > 500
    d, v = interop.shot_result_to_numpy(res)
    np.testing.assert_allclose(np.linalg.norm(d[v], axis=1), 1.0, atol=1e-5)
    assert interop.shot_config_from(jf.ShotConfig()) == tt.ShotConfig()
    other = jf.ShotConfig(radius=0.5, max_neighbors=64, n_cos_bins=9, method="window",
                          band=48)
    assert interop.shot_config_from(other) == tt.ShotConfig(0.5, 64, 9, "window", 48)
