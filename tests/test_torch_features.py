"""FPFH and exact neighbour search: the PyTorch port against the JAX
package.

On the CPU each FPFH kernel wrapper runs its plain PyTorch version; the
Pallas kernels run in interpret mode, as the JAX package's own tests
run them. Kernel tests give both sides the same packed arrays from one
stable sort (``lax.sort`` is not stable and Morton keys tie, so each
side sorting for itself would give different windows); module tests
give both sides the same points and normals.

Stated tolerances:
* ``knn``: each side's squared distances first within its own fp32
  error bound of ‖q‖² + ‖p‖² − 2q·p, 9u·(‖q‖² + ‖p‖²) with u = 2^-24
  (derived at the test), of the float64 d² of the point it returned;
  then the two sides within 30u·(‖q‖² + ‖p‖²) of each other (which
  roundings XLA's CPU dot makes depends on the host's instruction set),
  validity equal, indices equal where the exact order is decided beyond
  each side's bound (near-ties may come back in either order);
* the port's CPU knn product (an fp32 FMA chain): XLA's bits on >= 99.9%
  of entries and within 64u·dim elsewhere (a float64 double rounding at
  a tie moves the last bit);
* ``atan2_approx``: equal to the JAX function within 1 ulp of π;
* stage-1 kernels: count rows equal on >= 99.9% of points, histogram
  rows within 2 votes on >= 99.5% (the reference's XLA:CPU run
  contracts products into FMAs, which can move a vote across a bin
  edge);
* stage-2 kernels: counts equal on >= 99.9%, the weighted sums within
  1e-4 of each point's Σ|row| on >= 99.9%;
* fused FPFH: valid flags equal on >= 99% and the 95th percentile of
  the descriptor L1 distance below 1.0 (descriptors sum to 300), the
  JAX package's own bound for its fused-vs-staged test;
* exact FPFH: valid flags equal, descriptor L1 below 1.0 on >= 99% of
  points (a true atan2 on both sides; its last bit can still move a
  vote across a bin edge).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.kernels import fpfh_pallas as jfp  # noqa: E402
from threecrate_tpu.ops import features as jf  # noqa: E402
from threecrate_tpu.ops import morton as jmo  # noqa: E402
from threecrate_tpu.ops import neighbors as jn  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.kernels import fpfh as tk  # noqa: E402
from threecrate_tpu_torch.ops import features as tf  # noqa: E402
from threecrate_tpu_torch.ops import neighbors as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _t(x):
    return torch.from_numpy(np.array(x))


def _surface(n, seed, scale=1.0):
    """A smooth height field with its analytic unit normals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    nrm = np.stack([-0.8 * np.cos(xy[:, 0] * 2.0), 0.51 * np.sin(xy[:, 1] * 1.7),
                    np.ones(n)], -1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pts = np.stack([xy[:, 0], xy[:, 1], z], -1) * scale
    return pts.astype(np.float32), nrm.astype(np.float32)


def _both_clouds(pts, nrm, mask=None):
    mask = np.ones(len(pts), bool) if mask is None else mask
    jc = tc.PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                       attrs={"normals": jnp.asarray(nrm)})
    pc = interop.cloud_from_numpy(pts, mask, {"normals": nrm}, device="cpu")
    return jc, pc


# ---------------------------------------------------------------- knn


# Error bound of one side's squared distance. Both sides expand
# d² = ‖q‖² + ‖p‖² − 2q·p in fp32 (unit roundoff u = 2^-24): ‖q‖² and
# ‖p‖² carry at most 3u of their size, 2q·p at most 3u·(‖q‖² + ‖p‖²),
# the add and the subtract one rounding each of a value at most
# S = ‖q‖² + ‖p‖² and 2S, so |computed − exact| ≤ 9u·S to first order
# (FMA contraction only removes roundings). Which roundings a side makes
# depends on the CPU's code path (MKL and XLA:CPU pick kernels by
# instruction set), so a fixed margin does not hold on every host.
_U = 2.0 ** -24


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_db_tiling_matches_jax(exclude_self):
    """The tiled knn (db_tile=64 over 600 points: 10 tiles, a ragged
    last one) against the JAX knn with the same tiling: squared distances
    within both sides' error bound, indices equal wherever the exact
    order is decided beyond that bound."""
    rng = np.random.default_rng(1)
    db = rng.normal(0, 1, (600, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, 600) > 0.1
    k = 8
    jr = jn.knn(jnp.asarray(db), jnp.asarray(mask), jnp.asarray(db),
                jnp.asarray(mask), k, exclude_self=exclude_self, db_tile=64,
                query_chunk=128)
    tr = tn.knn(_t(db), _t(mask), _t(db), _t(mask), k, exclude_self=exclude_self,
                db_tile=64, query_chunk=128)
    jd, td, ji = np.asarray(jr.distances), tr.distances.numpy(), np.asarray(jr.indices)
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    fin = np.isfinite(jd)
    sq = (db.astype(np.float64) ** 2).sum(1)
    s_slot = sq[:, None] + sq[ji]
    # first each side against float64: the returned distance squared
    # within 9u·S of the exact d² of the point that side returned at that
    # slot, plus 3u·d² for the sqrt the result holds and the square here
    for side, dist, idx in (("port", td, tr.indices.numpy()), ("JAX", jd, ji)):
        exact = ((db[:, None, :].astype(np.float64) - db[idx]) ** 2).sum(-1)
        got = dist.astype(np.float64) ** 2
        lim = 9 * _U * (sq[:, None] + sq[idx]) + 3 * _U * exact
        bad = np.argwhere(fin & ~(np.abs(got - exact) <= lim))
        assert not len(bad), (
            f"{side} side off its fp32 bound at {len(bad)} slots; first: query "
            f"{bad[0][0]} slot {bad[0][1]}: d² {got[tuple(bad[0])]!r}, exact "
            f"{exact[tuple(bad[0])]!r}, bound {lim[tuple(bad[0])]!r}")
    # then the two sides: each within its bound, so within both
    assert (np.abs(td[fin] ** 2 - jd[fin] ** 2) <= 30 * _U * s_slot[fin]).all()
    assert (~np.isfinite(td[~fin])).all()
    # the exact order (float64) of each valid query's valid candidates;
    # slot j is decided when its exact d² is further than both sides'
    # bounds from slots j−1 and j+1 (slot k: the first neighbour left out)
    d2 = ((db[:, None, :].astype(np.float64) - db[None]) ** 2).sum(-1)
    d2[:, ~mask] = np.inf
    if exclude_self:
        np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k + 1]
    ex = np.take_along_axis(d2, order, 1)
    bound = 9 * _U * (sq[:, None] + sq[order])
    sep = np.diff(ex, axis=1) > bound[:, 1:] + bound[:, :-1]       # (600, k)
    decided = np.ones((600, k), bool)
    decided[:, 1:] &= sep[:, :-1]
    decided &= sep
    decided &= fin
    assert decided.mean() > 0.8
    np.testing.assert_array_equal(ji[decided], order[:, :k][decided])
    np.testing.assert_array_equal(tr.indices.numpy()[decided], ji[decided])
    if exclude_self:
        rows = np.arange(600)[:, None]
        assert not (tr.indices.numpy()[np.isfinite(td)] ==
                    np.broadcast_to(rows, td.shape)[np.isfinite(td)]).any()


@pytest.mark.parametrize("dim", [3, 8, 33])
def test_cpu_knn_product_has_xlas_bits(dim):
    """The CPU knn product (an elementwise fp32 FMA chain over the
    columns, no BLAS) against XLA's CPU dot at HIGHEST precision."""
    import jax
    rng = np.random.default_rng(dim)
    a = rng.normal(0, 1, (300, dim)).astype(np.float32)
    b = rng.normal(0, 1, (700, dim)).astype(np.float32)
    ref = np.asarray(jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                                         (((1,), (1,)), ((), ())),
                                         precision=jax.lax.Precision.HIGHEST,
                                         preferred_element_type=jnp.float32))
    got = tn._cross(_t(a), _t(b)).numpy()
    assert np.mean(got == ref) >= 0.999
    np.testing.assert_allclose(got, ref, rtol=0, atol=64 * _U * dim)


def test_knn_tiling_is_exact():
    """One tile or many: the same neighbours (an oracle check on 33-d
    rows, the shape descriptor matching sends through knn)."""
    rng = np.random.default_rng(2)
    db = _t(rng.normal(0, 1, (700, 33)).astype(np.float32))
    q = _t(rng.normal(0, 1, (90, 33)).astype(np.float32))
    m = torch.ones(700, dtype=torch.bool)
    one = tn.knn(db, m, q, None, 3)
    many = tn.knn(db, m, q, None, 3, db_tile=50, query_chunk=32)
    torch.testing.assert_close(many.distances, one.distances, rtol=0, atol=0)
    assert torch.equal(many.indices, one.indices)
    d2 = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    assert torch.equal(one.indices, torch.sort(d2, dim=1, stable=True).indices[:, :3])


def test_radius_neighbors_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    jr = jn.radius_neighbors(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts),
                             jnp.asarray(mask), 0.15, 16, exclude_self=True,
                             db_tile=128)
    tr = tn.radius_neighbors(_t(pts), _t(mask), _t(pts), _t(mask), 0.15, 16,
                             exclude_self=True, db_tile=128)
    tm, jm = tr.mask.numpy(), np.asarray(jr.mask)
    # a neighbour within 1e-5 of the radius may fall either side of it
    jd = np.asarray(jr.distances)
    edge = np.abs(np.where(jm, jd, np.asarray(jn.knn(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(mask), 16,
        exclude_self=True).distances)) - np.float32(0.15)) < 1e-5
    assert (tm == jm)[~edge].all() and tm.sum() > 1000
    np.testing.assert_allclose(tr.distances.numpy()[tm & jm] ** 2, jd[tm & jm] ** 2,
                               rtol=0, atol=1e-5)
    assert (tr.distances.numpy()[tm] <= np.float32(0.15)).all()


# ------------------------------------------------------------ kernels


def test_atan2_approx_matches_jax():
    v = np.array([0.0, -0.0, 1e-30, -1e-30, 1e-6, -1e-6, 0.3, -0.3, 1.0, -1.0,
                  2.5, -2.5, 1e6, -1e6], np.float32)
    y, x = (a.ravel() for a in np.meshgrid(v, v))
    ref = np.asarray(jfp._atan2_approx(jnp.asarray(y), jnp.asarray(x)))
    got = tk.atan2_approx(_t(y), _t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=float(np.spacing(np.float32(np.pi))))
    err = np.abs(got - np.arctan2(y, x))
    # within the approximation's ~5e-3 rad, modulo 2π (on the negative x
    # axis a -0.0 y gives +π here and -π from atan2), away from the
    # origin, where atan2 reads the signs of zeros and the approximation
    # does not
    off_origin = (x != 0) | (y != 0)
    assert np.minimum(err, 2 * np.pi - err)[off_origin].max() < 6e-3
    # the axes: exactly the quadrant constants
    np.testing.assert_array_equal(got[(y == 0) & (x > 0)], 0.0)


def _packed_case(scale, n=2048, tile=128, seed=0):
    pts, nrm = _surface(n, seed, scale)
    mask = np.ones(n, bool)
    mask[-60:] = False
    keys = np.asarray(jmo.morton_keys(jnp.asarray(pts), jnp.asarray(mask), 0))
    o = np.argsort(keys, kind="stable")
    packed = np.concatenate([pts[o].T, mask[o][None].astype(np.float32),
                             nrm[o].T]).astype(np.float32)
    keys_b = np.asarray(jmo.morton_keys(jnp.asarray(pts[o]), jnp.asarray(mask[o]), 1))
    ob = np.argsort(keys_b, kind="stable")
    r = 0.25 * scale
    return packed, ob, float(r) * float(r), tile


@pytest.fixture(scope="module", params=[1e-2, 1.0, 1e2], ids=["1e-2", "1", "1e2"])
def kernel_case(request):
    """All four kernels on both sides at one scale; stage 2 gets the
    same SPFH (the reference's) on both sides."""
    packed, ob, r2, tile = _packed_case(request.param)
    posb = ob.astype(np.int32)[None]
    pb = packed[:, ob].copy()
    out = {}
    out["spfh_a"] = (np.asarray(jfp.spfh_a_tiles(jnp.asarray(packed), r2, tile,
                                                 interpret=True)),
                     tk.spfh_a_tiles(_t(packed), r2, tile).numpy())
    out["spfh_b"] = (np.asarray(jfp.spfh_b_tiles(jnp.asarray(pb), jnp.asarray(posb), r2,
                                                 tile, interpret=True)),
                     tk.spfh_b_tiles(_t(pb), _t(posb), r2, tile).numpy())
    ja, jb = out["spfh_a"][0], out["spfh_b"][0]
    inv_b = np.argsort(ob)
    raw = ja.T + jb.T[inv_b]
    spfh = (raw[:, :33] / np.maximum(raw[:, 33:], 1.0)).astype(np.float32)
    p2a = np.concatenate([packed[0:4], spfh.T]).astype(np.float32)
    p2b = p2a[:, ob].copy()
    out["fpfh_weight_a"] = (
        np.asarray(jfp.fpfh_weight_a_tiles(jnp.asarray(p2a), r2, tile, interpret=True)),
        tk.fpfh_weight_a_tiles(_t(p2a), r2, tile).numpy())
    out["fpfh_weight_b"] = (
        np.asarray(jfp.fpfh_weight_b_tiles(jnp.asarray(p2b), jnp.asarray(posb), r2, tile,
                                           interpret=True)),
        tk.fpfh_weight_b_tiles(_t(p2b), _t(posb), r2, tile).numpy())
    out["valid"] = packed[3] > 0.5
    return out


@pytest.mark.parametrize("name", ["spfh_a", "spfh_b"])
def test_spfh_kernels_match_pallas(kernel_case, name):
    ref, got = kernel_case[name]
    assert got.shape == ref.shape == (34, 2048)
    assert np.mean(got[33] == ref[33]) >= 0.999
    assert np.mean(np.abs(got[:33] - ref[:33]).max(0) <= 2) >= 0.995
    assert kernel_case["spfh_a"][1][33].mean() > 5      # real neighbourhoods
    # every vote row sums to the count: 3 features per selected pair
    np.testing.assert_array_equal(got[:33].reshape(3, 11, -1).sum(1),
                                  np.broadcast_to(got[33], (3, got.shape[1])))


@pytest.mark.parametrize("name", ["fpfh_weight_a", "fpfh_weight_b"])
def test_fpfh_weight_kernels_match_pallas(kernel_case, name):
    ref, got = kernel_case[name]
    assert np.mean(got[33] == ref[33]) >= 0.999
    err = np.abs(got[:33] - ref[:33]).max(0) / np.maximum(np.abs(ref[:33]).sum(0), 1e-30)
    assert np.mean(err <= 1e-4) >= 0.999, np.quantile(err, [0.5, 0.999])


def test_pass_b_excludes_pass_a_window():
    """Pass B with every candidate in the query's own pass-A tile counts
    nothing; with all pass-A positions far apart it equals pass A."""
    packed, ob, r2, tile = _packed_case(1.0, n=512)
    same = np.zeros((1, 512), np.int32)
    assert (tk.spfh_b_plain(_t(packed), _t(same), r2, tile).numpy() == 0).all()
    far = (np.arange(512, dtype=np.int32) * 4 * tile)[None]
    p2 = np.concatenate([packed[0:4], np.ones((33, 512), np.float32)])
    for b, a, p in ((tk.spfh_b_plain, tk.spfh_a_plain, packed),
                    (tk.fpfh_weight_b_plain, tk.fpfh_weight_a_plain, p2)):
        np.testing.assert_array_equal(b(_t(p), _t(far), r2, tile).numpy(),
                                      a(_t(p), r2, tile).numpy())


def test_kernel_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        tk.spfh_a_tiles(torch.zeros(7, 300), 0.1, 128)
    with pytest.raises(ValueError):
        tk.spfh_a_tiles(torch.zeros(7, 384), 0.1, 96)           # not a power of two
    with pytest.raises(ValueError):
        tk.fpfh_weight_a_tiles(torch.zeros(7, 256), 0.1, 128)  # stage 2 takes 37 rows
    with pytest.raises(TypeError):
        tk.spfh_b_tiles(torch.zeros(7, 256), torch.zeros(1, 256), 0.1, 128)


# ------------------------------------------------------------ modules


@pytest.mark.parametrize("scale", [1.0, 1e2])
def test_fused_fpfh_matches_jax(scale):
    """extract_fpfh_features_with_normals, method="window" (the fused
    path at tile 256), on the same points and normals."""
    pts, nrm = _surface(4096, 5, scale)
    mask = np.ones(4096, bool)
    mask[-96:] = False
    jc, pc = _both_clouds(pts, nrm, mask)
    r = 0.2 * scale
    jres = jf.extract_fpfh_features_with_normals(
        jc, jf.FpfhConfig(radius=r, method="window", band=None))
    tres = tt.extract_fpfh_features_with_normals(
        pc, interop.fpfh_config_from(jf.FpfhConfig(radius=r, method="window", band=None)))
    jd, jv = np.asarray(jres.descriptors), np.asarray(jres.valid)
    td, tv = interop.fpfh_result_to_numpy(tres)
    assert td.shape == (4096, 33)
    assert np.mean(tv == jv) >= 0.99
    both = tv & jv
    assert both.mean() > 0.9
    l1 = np.abs(td[both] - jd[both]).sum(1)
    assert np.percentile(l1, 95) < 1.0, np.percentile(l1, 95)
    np.testing.assert_allclose(td[tv].reshape(-1, 3, 11).sum(2), 100.0, atol=1e-3)
    assert (td[~tv] == 0).all() and not tv[~mask].any()


@pytest.mark.parametrize("soft", [False, True])
def test_exact_fpfh_matches_jax(soft):
    """The exact branch of ``_fpfh`` (capped radius search, true atan2)."""
    pts, nrm = _surface(1500, 6)
    mask = np.ones(1500, bool)
    mask[::50] = False
    jd, jv = jf._fpfh(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm),
                      jnp.float32(0.3), 32, 11, False, soft)
    td, tv = tf._fpfh(_t(pts), _t(mask), _t(nrm), 0.3, 32, 11, False, soft)
    jd, jv = np.asarray(jd), np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    l1 = np.abs(td.numpy()[jv] - jd[jv]).sum(1)
    assert np.mean(l1 < 1.0) >= 0.99, np.quantile(l1, [0.5, 0.99])


def test_exact_fpfh_public_entry_and_soft_route():
    """Below the fused threshold "auto" takes the exact path; soft
    binning takes it at any size."""
    pts, nrm = _surface(800, 7)
    jc, pc = _both_clouds(pts, nrm)
    for cfg in (jf.FpfhConfig(radius=0.4), jf.FpfhConfig(radius=0.4, soft_binning=True)):
        jr = jf.extract_fpfh_features_with_normals(jc, cfg)
        tr = tt.extract_fpfh_features_with_normals(pc, interop.fpfh_config_from(cfg))
        np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
        l1 = np.abs(tr.descriptors.numpy() - np.asarray(jr.descriptors)).sum(1)
        assert np.mean(l1 < 1.0) >= 0.99


def test_fpfh_requires_normals_and_estimates_them():
    pts, _ = _surface(600, 8)
    pc = tt.PointCloud.from_numpy(pts, device="cpu")
    with pytest.raises(tt.InvalidDataError):
        tt.extract_fpfh_features_with_normals(pc, tt.FpfhConfig(radius=0.4))
    res = tt.extract_fpfh_features(pc, tt.FpfhConfig(radius=0.4))
    assert res.descriptors.shape == (pc.capacity, 33) and res.valid.float().mean() > 0.9


def test_band_resolution_matches_jax():
    """The host-side in-radius estimate and the band="auto" rung."""
    pts, _ = _surface(6000, 9)
    mask = np.ones(len(pts), bool)
    for r in (0.05, 0.2, 0.5):     # rungs 16 and 32, then no rung
        je = jf.expected_in_radius_count(jnp.asarray(pts), jnp.asarray(mask), r)
        te = tf.expected_in_radius_count(_t(pts), _t(mask), r)
        assert te == pytest.approx(je, rel=1e-6)
        assert tf._resolve_fpfh_band("auto", _t(pts), _t(mask), r) == \
            jf._resolve_fpfh_band("auto", jnp.asarray(pts), jnp.asarray(mask), r)
    assert tf._resolve_fpfh_band(None, _t(pts), _t(mask), 0.3) is None


def test_unported_routes_name_their_kernels():
    """The SHOT and USC entries, which raised naming their kernels until
    those were ported, return unit-norm (N, 352) and (N, 128) descriptors
    (staged path below the fused threshold)."""
    pts, nrm = _surface(512, 10)
    pc = interop.cloud_from_numpy(pts, np.ones(512, bool), {"normals": nrm}, device="cpu")
    for fn, dim in ((tf.extract_shot_features, 352), (tf.extract_usc_features, 128)):
        res = fn(pc, tt.ShotConfig(radius=0.5))
        d, v = interop.shot_result_to_numpy(res)
        assert d.shape == (512, dim) and v.mean() > 0.9
        np.testing.assert_allclose(np.linalg.norm(d[v], axis=1), 1.0, atol=1e-5)


def test_configs_and_transform_constructors_match_jax():
    assert interop.fpfh_config_from(jf.FpfhConfig()) == tt.FpfhConfig()
    got = (tt.Transform.from_axis_angle([0, 0, 2.0], 0.6)
           @ tt.Transform.from_translation([1.5, -0.8, 0.4])).matrix.numpy()
    ref = np.asarray((tc.Transform.from_axis_angle([0, 0, 2.0], 0.6)
                      @ tc.Transform.from_translation([1.5, -0.8, 0.4])).matrix)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    r = tt.Transform.from_axis_angle([1.0, 2.0, -0.5], -1.1).rotation
    torch.testing.assert_close(r @ r.T, torch.eye(3), atol=1e-6, rtol=0)


def test_fused_path_never_builds_on_cpu(monkeypatch):
    """On CPU tensors the fused path runs the plain versions: no launch
    is counted and no build is attempted."""
    from threecrate_tpu_torch import kernels
    from threecrate_tpu_torch.kernels import _build

    def no_build():
        raise AssertionError("a CPU call tried to build the kernels")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "lib", no_build)
    kernels.reset_launch_counts()
    pts, nrm = _surface(1024, 11)
    pc = interop.cloud_from_numpy(pts, np.ones(1024, bool), {"normals": nrm}, device="cpu")
    tt.extract_fpfh_features_with_normals(
        pc, tt.FpfhConfig(radius=0.2, method="window", band=None))
    assert sum(kernels.launch_counts().values()) == 0
