"""FPFH at its band rungs and the staged window FPFH: the PyTorch port
against the JAX package.

On the CPU the banded SPFH wrappers run their plain PyTorch versions;
the Pallas kernels run in interpret mode, as the JAX package's own tests
run them. The kernel tests give both sides the same packed arrays from
one stable sort; module tests give both sides the same points and
normals.

Stated tolerances:
* ``spfh_band_a/b``: all 34 rows equal on every query (both sides
  evaluate the same fp32 operations; on these fixtures XLA:CPU's FMA
  contraction moves no vote);
* banded fused FPFH (``_fpfh_fused(band=48)`` and the default
  ``extract_fpfh_features`` where ``band="auto"`` engages): as the
  full-window fused test (tests/test_torch_features.py) — valid flags
  equal on >= 99% and the 95th percentile of the descriptor L1 distance
  below 1.0 (descriptors sum to 300);
* staged window FPFH (``soft_binning=True``): the JAX package's "auto"
  neighbour search on the CPU is its XLA branch (wrap-around windows,
  exact top-k), the port's the window kernel; valid flags equal on
  >= 99% and descriptor L1 below 1.0 on >= 99% of points valid on both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.kernels import fpfh_pallas as jfp  # noqa: E402
from threecrate_tpu.ops import features as jf  # noqa: E402
from threecrate_tpu.ops import morton as jmo  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop, kernels  # noqa: E402
from threecrate_tpu_torch.kernels import fpfh as tk  # noqa: E402
from threecrate_tpu_torch.ops import features as tf  # noqa: E402

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


def _packed(scale, n=2048, seed=0):
    """Pass-A packed rows (7, N) and the pass-B order, one stable sort."""
    pts, nrm = _surface(n, seed, scale)
    mask = np.ones(n, bool)
    mask[-60:] = False
    o = np.argsort(np.asarray(jmo.morton_keys(jnp.asarray(pts), jnp.asarray(mask), 0)),
                   kind="stable")
    packed = np.concatenate([pts[o].T, mask[o][None].astype(np.float32),
                             nrm[o].T]).astype(np.float32)
    ob = np.argsort(np.asarray(jmo.morton_keys(jnp.asarray(pts[o]), jnp.asarray(mask[o]),
                                               1)), kind="stable")
    return packed, ob


@pytest.fixture(scope="module", params=[1e-2, 1.0, 1e2], ids=["1e-2", "1", "1e2"])
def packed_case(request):
    return request.param, _packed(request.param)


@pytest.mark.parametrize("band,tile", [(16, 128), (48, 256)])
def test_spfh_band_kernels_match_pallas(packed_case, band, tile):
    scale, (packed, ob) = packed_case
    r2 = float(0.25 * scale) ** 2
    ref_a = np.asarray(jfp.spfh_band_a_tiles(jnp.asarray(packed), r2, band, tile,
                                             interpret=True))
    got_a = tk.spfh_band_a_tiles(_t(packed), r2, band, tile).numpy()
    p8 = np.concatenate([packed[:, ob], ob.astype(np.float32)[None]]).astype(np.float32)
    ref_b = np.asarray(jfp.spfh_band_b_tiles(jnp.asarray(p8), r2, band, tile,
                                             interpret=True))
    got_b = tk.spfh_band_b_tiles(_t(p8), r2, band, tile).numpy()
    assert got_a.shape == got_b.shape == (34, 2048)
    np.testing.assert_array_equal(got_a, ref_a)
    np.testing.assert_array_equal(got_b, ref_b)
    assert got_a[33].mean() > 5 and got_b[33].mean() > 1      # real neighbourhoods
    for got in (got_a, got_b):
        np.testing.assert_array_equal(got[:33].reshape(3, 11, -1).sum(1),
                                      np.broadcast_to(got[33], (3, got.shape[1])))


def test_band_covers_the_full_window_when_wide():
    """band = tile reaches every candidate the full window reaches within
    ±tile positions; pass B with far-apart pass-A positions excludes
    nothing, and with equal ones everything."""
    packed, _ = _packed(1.0, n=1024)
    r2, tile = 0.3 ** 2, 128
    full = tk.spfh_band_a_plain(_t(packed), r2, tile, tile).numpy()
    narrow = tk.spfh_band_a_plain(_t(packed), r2, 8, tile).numpy()
    assert (narrow[33] <= full[33]).all() and narrow[33].sum() < full[33].sum()
    far = np.concatenate([packed, (np.arange(1024) * 1000.0)[None]]).astype(np.float32)
    np.testing.assert_array_equal(tk.spfh_band_b_plain(_t(far), r2, 8, tile).numpy(),
                                  narrow)
    same = np.concatenate([packed, np.zeros((1, 1024))]).astype(np.float32)
    assert (tk.spfh_band_b_plain(_t(same), r2, 8, tile).numpy() == 0).all()


def test_band_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError, match="band"):
        tk.spfh_band_a_tiles(torch.zeros(7, 256), 0.1, 200, 128)
    with pytest.raises(ValueError):
        tk.spfh_band_b_tiles(torch.zeros(7, 256), 0.1, 16, 128)    # pass B takes 8 rows


# ------------------------------------------------------------ modules


def _clouds(pts, nrm):
    import threecrate_tpu as tc
    mask = np.ones(len(pts), bool)
    jc = tc.PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                       attrs={"normals": jnp.asarray(nrm)})
    return jc, interop.cloud_from_numpy(pts, mask, {"normals": nrm}, device="cpu")


def _assert_fused_close(td, tv, jd, jv):
    assert np.mean(tv == jv) >= 0.99
    both = tv & jv
    assert both.mean() > 0.9
    l1 = np.abs(td[both] - jd[both]).sum(1)
    assert np.percentile(l1, 95) < 1.0, np.percentile(l1, 95)
    np.testing.assert_allclose(td[tv].reshape(-1, 3, 11).sum(2), 100.0, atol=1e-3)


def test_fused_fpfh_band48_matches_jax():
    """``_fpfh_fused(band=48)`` on the JAX package's banded-parity
    fixture (tests/test_features.py: 4,096 points, r = 0.12)."""
    pts, nrm = _surface(4096, 3)
    mask = np.ones(4096, bool)
    jd, jv = jf._fpfh_fused(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm), 0.12,
                            band=48)
    kernels.reset_launch_counts()
    td, tv = tf._fpfh_fused(_t(pts), _t(mask), _t(nrm), 0.12, band=48)
    _assert_fused_close(td.numpy(), tv.numpy(), np.asarray(jd), np.asarray(jv))


def test_default_fpfh_takes_the_band_rung():
    """``extract_fpfh_features_with_normals`` with the default band on the
    fixture of tests/test_features.py's cross-view test (4,096 points,
    r = 0.2, method="window"), where "auto" resolves to a rung."""
    pts, nrm = _surface(4096, 11)
    jc, pc = _clouds(pts, nrm)
    cfg = jf.FpfhConfig(radius=0.2, method="window")
    band = tf._resolve_fpfh_band("auto", pc.points, pc.mask, 0.2)
    assert band is not None and band == jf._resolve_fpfh_band("auto", jc.points, jc.mask, 0.2)
    jr = jf.extract_fpfh_features_with_normals(jc, cfg)
    tr = tt.extract_fpfh_features_with_normals(pc, interop.fpfh_config_from(cfg))
    td, tv = interop.fpfh_result_to_numpy(tr)
    _assert_fused_close(td, tv, np.asarray(jr.descriptors), np.asarray(jr.valid))


@pytest.mark.parametrize("soft", [True, False])
def test_staged_window_fpfh_matches_jax(soft):
    """The staged ``_fpfh`` on the window search (``soft_binning=True``
    takes it above 262,144 points; forced here with ``window=True``)."""
    pts, nrm = _surface(3000, 12)
    mask = np.ones(3000, bool)
    mask[::97] = False
    jd, jv = jf._fpfh(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm),
                      jnp.float32(0.2), 32, 11, True, soft)
    td, tv = tf._fpfh(_t(pts), _t(mask), _t(nrm), 0.2, 32, 11, True, soft)
    jd, jv, td, tv = np.asarray(jd), np.asarray(jv), td.numpy(), tv.numpy()
    assert np.mean(tv == jv) >= 0.99
    both = tv & jv
    assert both.mean() > 0.9
    l1 = np.abs(td[both] - jd[both]).sum(1)
    assert np.mean(l1 < 1.0) >= 0.99, np.quantile(l1, [0.5, 0.99])


def test_soft_binning_routes_to_the_staged_window_path(monkeypatch):
    """Above the fused threshold, soft binning runs the staged path on
    ``radius_neighbors_window`` (k = max_neighbors, self excluded)."""
    from threecrate_tpu_torch.ops import neighbors as tn
    calls = []
    real = tn.radius_neighbors_window

    def spy(*args, **kw):
        calls.append((args[3], kw))
        return real(*args, **kw)

    monkeypatch.setattr(tn, "radius_neighbors_window", spy)
    monkeypatch.setattr(tf, "FUSED_FPFH_THRESHOLD", 1024)
    pts, nrm = _surface(2048, 13)
    _, pc = _clouds(pts, nrm)
    res = tt.extract_fpfh_features_with_normals(pc, tt.FpfhConfig(radius=0.3,
                                                                  soft_binning=True))
    assert calls == [(64, {"exclude_self": True})]
    assert res.valid.float().mean() > 0.9
