"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version; the
Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them. Both sides get the same pre-sorted arrays (``lax.sort`` is not
stable and Morton keys tie, so each side sorting for itself would give
different windows).

Stated tolerances:
* union passes: counts (and pass B's use_b flag) equal on >= 99.9% of
  valid points; the radius within 1e-6 relative on >= 99.9% (XLA:CPU
  contracts the reference's distance sums into FMAs, which moves the
  last bit of some distances); the central sums within 1e-3 of the
  neighbourhood's scale on >= 99.9% of points and within 1e-2 on all;
* icp_match: matched payloads within 1e-6 absolute, match flags equal.

The CUDA kernels themselves are checked against these plain versions
on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.kernels.icp_pallas import icp_match_tiles as pallas_icp  # noqa: E402
from threecrate_tpu.kernels.knn_pallas import (  # noqa: E402
    window_union_a_tiles as pallas_union_a,
    window_union_b_tiles as pallas_union_b)
from threecrate_tpu.ops import morton as jmo  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import kernels  # noqa: E402
from threecrate_tpu_torch.kernels import _build  # noqa: E402
from threecrate_tpu_torch.kernels.icp import icp_match_tiles  # noqa: E402
from threecrate_tpu_torch.kernels.knn import (  # noqa: E402
    window_union_a_tiles, window_union_b_tiles)

torch.set_num_threads(2)   # the suite runs several workers per host

K, TILE, BAND = 10, 256, 16
N_UNION = 16_640


def _t(x):
    return torch.from_numpy(np.array(x))


def _sorted_union_inputs(n, seed, n_invalid=100):
    """Pass-A sorted coordinates/validity and the pass-B order of a
    kitti-like scan, padded to a multiple of the tile (invalid tail)."""
    from bench import _kitti_like
    n_pad = -(-n // TILE) * TILE
    pts = np.zeros((n_pad, 3), np.float32)
    pts[:n] = _kitti_like(n, seed)
    mask = np.zeros(n_pad, bool)
    mask[:n - n_invalid] = True
    keys = np.asarray(jmo.morton_keys(jnp.asarray(pts), jnp.asarray(mask), 0))
    order = np.argsort(keys, kind="stable")
    pa, va = pts[order], mask[order]
    keys_b = np.asarray(jmo.morton_keys(jnp.asarray(pa), jnp.asarray(va), 1))
    order_b = np.argsort(keys_b, kind="stable")
    return pa, va, order_b


@pytest.fixture(scope="module")
def union_case():
    """Both passes of both implementations on one 16,640-point scan; each
    side feeds its own pass-A radius into its pass B."""
    pa, va, ob = _sorted_union_inputs(N_UNION, 0)
    pts_t, valid = pa.T.copy(), va.astype(np.float32)[None]
    ja = np.asarray(pallas_union_a(jnp.asarray(pts_t), jnp.asarray(valid), K,
                                   TILE, interpret=True, band=BAND))
    ta = window_union_a_tiles(_t(pts_t), _t(valid), K, TILE, BAND).numpy()
    pb, vb, posb = pa[ob].T.copy(), valid[:, ob].copy(), ob.astype(np.int32)[None]
    jb = np.asarray(pallas_union_b(
        jnp.asarray(pb), jnp.asarray(vb), jnp.asarray(posb),
        jnp.asarray(ja[10][ob][None]), K, TILE, interpret=True, band=BAND))
    tb = window_union_b_tiles(_t(pb), _t(vb), _t(posb), _t(ta[10][ob][None].copy()),
                              K, TILE, BAND).numpy()
    return dict(ja=ja, ta=ta, va=va, jb=jb, tb=tb, vb=vb[0] > 0.5)


def _sum_errors(got, ref):
    """Per point: S1/S2 errors relative to the neighbourhood's scale."""
    tr = np.maximum(ref[4] + ref[5] + ref[6], 1e-30)
    s1 = np.abs(got[1:4] - ref[1:4]) / np.sqrt(tr * np.maximum(ref[0], 1))
    s2 = np.abs(got[4:10] - ref[4:10]) / tr
    return np.concatenate([s1, s2]).max(0)


def _assert_sums(got, ref):
    err = _sum_errors(got, ref)
    assert np.mean(err <= 1e-3) >= 0.999, np.quantile(err, [0.5, 0.999])
    assert err.max() <= 1e-2, err.max()


def test_union_a_matches_pallas(union_case):
    ja, ta, v = union_case["ja"], union_case["ta"], union_case["va"]
    assert ta.shape == ja.shape == (11, N_UNION)
    assert np.mean(ta[0][v] == ja[0][v]) >= 0.999
    rel = np.abs(ta[10][v] - ja[10][v]) / ja[10][v]
    assert np.mean(rel <= 1e-6) >= 0.999
    _assert_sums(ta[:, v], ja[:, v])


def test_union_b_matches_pallas(union_case):
    jb, tb, v = union_case["jb"], union_case["tb"], union_case["vb"]
    assert np.mean(tb[10][v] == jb[10][v]) >= 0.999       # use_b
    assert np.mean(tb[0][v] == jb[0][v]) >= 0.999
    both = v & (tb[0] > 0) & (jb[0] > 0)
    _assert_sums(tb[:, both], jb[:, both])
    assert (tb[0][v & (tb[10] < 0.5)] >= 0).all()


@pytest.mark.parametrize("n_valid", [2, 200])
def test_union_a_small_windows(n_valid):
    """Edge tiles and queries with fewer than k valid candidates: the
    radius clamps to the largest finite fp32 and invalid candidates are
    never selected."""
    rng = np.random.default_rng(n_valid)
    pts = rng.normal(0, 1, (512, 3)).astype(np.float32)
    valid = np.zeros((1, 512), np.float32)
    valid[0, :n_valid] = 1
    ja = np.asarray(pallas_union_a(jnp.asarray(pts.T.copy()), jnp.asarray(valid),
                                   K, 128, interpret=True, band=BAND))
    ta = window_union_a_tiles(_t(pts.T.copy()), _t(valid), K, 128, BAND).numpy()
    np.testing.assert_array_equal(ta[0], ja[0])
    assert (ta[0] <= n_valid).all()
    np.testing.assert_allclose(ta[10], ja[10], rtol=1e-6)
    if n_valid < K:
        assert (ta[10] == np.float32(3.4e38)).all()
    _assert_sums(ta[:, :n_valid], ja[:, :n_valid])


class TestIcpMatch:
    """Mirrors tests/test_kernels.py::TestIcpMatchTiles, each case run
    through both the Pallas kernel and the port."""

    @staticmethod
    def _pack(src, tgt, valid_t, extra=None):
        tp = np.asarray(tgt, np.float32).copy()
        tp[~np.asarray(valid_t, bool)] = 2e19
        rows = [tp.T, np.asarray(valid_t, np.float32)[None]]
        if extra is not None:
            rows.append(np.asarray(extra, np.float32).T)
        src_p = np.concatenate([np.asarray(src, np.float32).T,
                                np.ones((1, len(src)), np.float32)])
        return src_p, np.concatenate(rows).astype(np.float32)

    @staticmethod
    def _both(src_p, tgt_p, ws, w_tiles=4):
        ref = np.asarray(pallas_icp(jnp.asarray(src_p), jnp.asarray(tgt_p),
                                    jnp.asarray(ws, jnp.int32), tile=128,
                                    w_tiles=w_tiles, interpret=True))
        got = icp_match_tiles(_t(src_p), _t(tgt_p), _t(np.asarray(ws, np.int32)),
                              tile=128, w_tiles=w_tiles).numpy()
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_allclose(got, ref, atol=1e-6)
        return got

    def test_nearest_within_window(self, rng):
        src = rng.normal(0, 1, (128, 3))
        tgt = rng.normal(0, 1, (512, 3)).astype(np.float32)
        got = self._both(*self._pack(src, tgt, np.ones(512)), [0])
        d2 = ((src[:, None] - tgt[None]) ** 2).sum(-1)
        np.testing.assert_allclose(got[0:3].T, tgt[d2.argmin(1)], atol=1e-6)

    def test_extras_ride_the_match(self, rng):
        src = rng.normal(0, 1, (128, 3))
        tgt = rng.normal(0, 1, (512, 3))
        extra = rng.normal(0, 1, (512, 3))
        got = self._both(*self._pack(src, tgt, np.ones(512), extra), [0])
        assert got.shape == (7, 128)

    def test_invalid_targets_never_matched(self, rng):
        src = rng.normal(0, 1, (128, 3))
        tgt = rng.normal(0, 1, (512, 3))
        valid = np.zeros(512)
        valid[:100] = 1
        self._both(*self._pack(src, tgt, valid), [0])

    def test_all_invalid_window(self, rng):
        src = rng.normal(0, 1, (128, 3))
        tgt = rng.normal(0, 1, (512, 3))
        got = self._both(*self._pack(src, tgt, np.zeros(512), rng.normal(0, 1, (512, 3))),
                         [0])
        assert (got[3] == 0).all() and (got[[0, 1, 2, 4, 5, 6]] == 0).all()

    def test_exact_ties_average(self):
        src = np.zeros((128, 3))
        tgt = np.tile([5.0, 0, 0], (512, 1))
        tgt[0] = [1, 0, 0]
        tgt[1] = [-1, 0, 0]
        tgt[2] = [0, 1, 0]
        extra = np.zeros((512, 3))
        extra[:3] = [[1, 2, 3], [3, 2, 1], [2, 5, 2]]
        got = self._both(*self._pack(src, tgt, np.ones(512), extra), [0])
        np.testing.assert_allclose(got[0:3].T, [[0, 1 / 3, 0]] * 128, atol=1e-6)
        np.testing.assert_allclose(got[4:7].T, [[2, 3, 2]] * 128, atol=1e-6)

    def test_window_offsets_per_tile(self, rng):
        """Two source tiles, each pointed at its own target tiles."""
        src = np.stack([np.arange(256), np.zeros(256), np.zeros(256)], -1)
        tgt = np.full((1024, 3), 1e6)
        tgt[3 * 128:4 * 128] = src[:128] + 0.01
        tgt[6 * 128:7 * 128] = src[128:] - 0.01
        got = self._both(*self._pack(src, tgt, np.ones(1024)), [2, 5], w_tiles=3)
        np.testing.assert_allclose(got[0:3, :128].T, src[:128] + 0.01, atol=1e-5)
        np.testing.assert_allclose(got[0:3, 128:].T, src[128:] - 0.01, atol=1e-5)

    def test_invalid_source_points_flagged(self, rng):
        src_p, tgt_p = self._pack(rng.normal(0, 1, (128, 3)),
                                  rng.normal(0, 1, (384, 3)), np.ones(384))
        src_p[3, ::3] = 0
        got = self._both(src_p, tgt_p, [0], w_tiles=3)
        assert (got[3, ::3] == 0).all() and (got[3, 1::3] == 1).all()


def test_cpu_wrappers_never_build_or_count(monkeypatch):
    """On CPU tensors every wrapper runs its plain version: no launch is
    counted and no build is attempted."""
    def no_build():
        raise AssertionError("a CPU call tried to build the kernels")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "lib", no_build)
    kernels.reset_launch_counts()
    pa, va, ob = _sorted_union_inputs(1024, 2, n_invalid=0)
    pts_t, valid = _t(pa.T.copy()), _t(va.astype(np.float32)[None])
    out_a = window_union_a_tiles(pts_t, valid, K, TILE, BAND)
    window_union_b_tiles(pts_t[:, ob], valid[:, ob], _t(ob.astype(np.int32)[None]),
                         out_a[10][ob][None], K, TILE, BAND)
    src = torch.cat([pts_t, valid])
    icp_match_tiles(src, src, torch.zeros(8, dtype=torch.int32), 128, 3)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2048, 3)).astype(np.float32)
    m = np.ones(2048, bool)
    tt.PerceptionStep(max_iterations=3, device="cpu")(x, m, x + 0.01, m)
    counts = kernels.launch_counts()
    assert {"union_window_a", "union_window_b", "icp_match"} <= set(counts)
    assert not any(counts.values())


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError):
        window_union_a_tiles(torch.zeros(3, 300), torch.ones(1, 300), K, TILE, BAND)
    with pytest.raises(ValueError):
        window_union_a_tiles(torch.zeros(3, 256), torch.ones(1, 256), 100, TILE, BAND)
    with pytest.raises(ValueError):
        icp_match_tiles(torch.zeros(4, 128), torch.zeros(4, 256),
                        torch.zeros(1, dtype=torch.int32), 128, 3)
