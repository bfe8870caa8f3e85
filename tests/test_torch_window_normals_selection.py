"""The selection recipes of the fused window-normals kernel, on the CPU.

``window_normals_tiles`` (``csrc/union_window.cu``) selects in one of
two ways, and ``window_normals_plain`` is what it is checked against:

* band body (band > 0): the union passes' radius, six fp32 halvings of
  [0, r2] (r2 the k-th smallest d² among the ±max(band, k) sorted
  neighbours) against the window's k-th smallest d², then every window
  column at or below it. The plain version's count row must equal that
  count and its k-th row ``-hi``, bit for bit.
* exact body (band = 0): one sweep in column order over the window
  with a right-aligned register list of 12/16/32/64 entries (KMAX − k
  entries of −inf ahead of the k smallest), restarted as k copies of the
  float above the k-th d² among the ±min(2k, tile) sorted neighbours; a
  candidate enters only if it strictly beats the list's last entry (the
  k-th) and is inserted after the entries equal to it. Emulated here in
  numpy, it must select the columns of the plain version's stable sort
  (ties to the lowest column), as must the same sweep started from
  +inf, and give the plain version's k-th and count rows bit for bit.

Both sweeps of the kernel pass over a chunk of window columns whose
bounding box, at the query's fp32 box distance shrunk by a margin,
already lies beyond the threshold. That is exact only if the shrunk box
distance never exceeds the fp32 d² of a column in the box; the last
test holds that on the same clouds, with the kernel's own chunk and
margin read from its sources.

The clouds (``union_clouds.union_cloud``) have duplicate points, ~10%
invalid columns and a last tile whose window holds k − 1 valid points,
at three scales and on an integer lattice, where distances tie.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu_torch.kernels.knn import window_normals_plain  # noqa: E402
from union_clouds import band_kth, radius_from_kth, union_cloud, window_d2  # noqa: E402

BAND = 16
_CSRC = Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);",
                      (_CSRC / "window.cuh").read_text()).group(1))
MARGIN = np.float32(1) - np.float32(1) / np.float32(
    re.search(r"kCullMargin = 1\.f - 1\.f / (\d+)\.f;",
              (_CSRC / "window.cuh").read_text()).group(1))
SCALES = [1e-2, 1.0, 1e2, "lattice"]
KS = [1, 3, 10, 16, 17, 64]
TILES = [64, 256]


def _case(tile, k, scale):
    """Both bodies' inputs: (3, N) sorted points, (N,) validity and their
    (N, 3·tile) window d² in numpy."""
    pts, valid = union_cloud(6 * tile, tile, k, 1.0 if scale == "lattice" else scale,
                             tile + k, lattice=scale == "lattice")
    return pts, valid, window_d2(pts.numpy(), valid.numpy(), tile)


def _kmax(k):
    return next(m for m in (12, 16, 32, 64) if k <= m)


def _one_sweep(d2, k, tile, seed_band):
    """The exact body's list after its sweep: values (N, KMAX) ascending
    and right-aligned, and the column of each entry. ``seed_band`` None
    starts the k slots at +inf, else at the float above the k-th d² of
    the ±seed_band sorted neighbours."""
    n, w3 = d2.shape
    kmax = _kmax(k)
    inf = np.float32(np.inf)
    seed = (np.full(n, inf) if seed_band is None
            else np.nextafter(band_kth(d2, k, tile, seed_band), inf))
    best = np.repeat(seed[:, None], kmax, 1).astype(np.float32)
    best[:, :kmax - k] = -inf
    col = np.zeros((n, kmax), np.int64)
    for c in range(w3):
        v = d2[:, c]
        enter = v < best[:, -1]          # strictly beats the k-th
        if not enter.any():
            continue
        b, cl, vv = best[enter], col[enter], v[enter][:, None]
        keep = b <= vv                   # entries at or below v stay
        put = np.concatenate([np.ones_like(keep[:, :1]), keep[:, :-1]], 1)
        prev_b = np.concatenate([b[:, :1], b[:, :-1]], 1)
        prev_c = np.concatenate([cl[:, :1], cl[:, :-1]], 1)
        best[enter] = np.where(keep, b, np.where(put, vv, prev_b))
        col[enter] = np.where(keep, cl, np.where(put, c, prev_c))
    return best, col


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("tile", TILES)
def test_band_body_selects_within_halved_radius(tile, k, scale):
    pts, valid, d2 = _case(tile, k, scale)
    rows = window_normals_plain(pts, valid[None], k, tile, BAND).numpy()
    hi = radius_from_kth(d2, k, tile, max(BAND, k))
    np.testing.assert_array_equal(rows[5], -hi)
    np.testing.assert_array_equal(rows[4], (d2 <= hi[:, None]).sum(1).astype(np.float32))
    assert (rows[4] >= k).mean() > 0.5 and (rows[4] < k).any()


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("tile", TILES)
def test_exact_body_one_sweep_matches_stable_sort(tile, k, scale):
    pts, valid, d2 = _case(tile, k, scale)
    rows = window_normals_plain(pts, valid[None], k, tile, 0).numpy()
    order = np.argsort(d2, 1, kind="stable")[:, :k]
    top = np.take_along_axis(d2, order, 1)
    for seed_band in (min(2 * k, tile), None):
        best, col = _one_sweep(d2, k, tile, seed_band)
        last = best[:, -k:]
        np.testing.assert_array_equal(last, top)
        finite = np.isfinite(top)
        np.testing.assert_array_equal(np.where(finite, col[:, -k:], -1),
                                      np.where(finite, order, -1))
        np.testing.assert_array_equal(rows[5], -best[:, -1])
        np.testing.assert_array_equal(rows[4], finite.sum(1).astype(np.float32))
    assert not np.isfinite(top[:, -1]).all()


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("tile", TILES)
def test_chunk_bound_stays_below_every_distance(tile, scale):
    k = 10
    pts, valid, d2 = _case(tile, k, scale)
    p, v = pts.numpy(), valid.numpy()
    n = p.shape[1]
    f32, inf = np.float32, np.float32(np.inf)
    checked = 0
    for t in range(n // tile):
        cols = (t - 1) * tile + np.arange(3 * tile)
        inside = (cols >= 0) & (cols < n)
        c = np.where(inside, cols, 0)
        ok = inside & (v[c] > 0.5)
        w = np.where(ok[None], p[:, c], np.nan).reshape(3, -1, CHUNK)
        with np.errstate(all="ignore"):
            lo = np.where(np.isnan(w), inf, w).min(2)         # (3, chunks)
            hi = np.where(np.isnan(w), -inf, w).max(2)
            q = p[:, t * tile:(t + 1) * tile, None]
            gap = np.maximum(np.maximum(lo[:, None] - q, q - hi[:, None]), f32(0))
            lb = ((gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]) * MARGIN
        dmin = d2[t * tile:(t + 1) * tile].reshape(tile, -1, CHUNK).min(2)
        used = lb >= f32(1e-30)
        assert (lb[used] <= dmin[used]).all()
        checked += used.sum()
    assert checked > 0
