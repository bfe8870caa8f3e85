"""The staged sweeps of the SHOT/USC kernels, on the CPU.

``shot_moments_a_tiles`` / ``shot_moments_b_tiles`` (``csrc/shot.cu``)
stage each block's span, the columns q0 − band … q0 + Q + band − 1 (Q =
``kMomentQueries``), as (x, y, z, tag) records: tag is
NaN where the column is not valid or lies outside [0, N), else 0 (pass
A) or the column's fp32 pass-A position, row 4 (pass B). Query p = q0 + i
sweeps span entries i … i + 2·band in candidate order, selecting where
the tag passes (pass A tag == 0, pass B |tag − posA_q| > band, both
false for NaN) and d² <= r2, d² > 1e-18, and sums its 14 moments in that
order; its own x, y, z and posA are its column's, so an invalid query is
served too. The histogram kernels stage their spans (Q = ``kHistWarps``
· 32 / the lanes a query) with the same records, posA in row 7.

Emulated here in numpy with the constants read from the source, on
stage-1 rows of small clouds (``union_clouds.spfh_inputs``: duplicate
points, ~10% invalid columns), at (band, tile) (0, 128), (32, 256) and
(64, 64) (a partial last block where a tile is narrower than a block),
every case covering the first span (no columns before it) and the last
(none after); pass B's posA row also carries −1, NaN, fractional and
negated values on some valid columns and queries:

* the staged selection equals the plain versions' (``band_candidates``)
  candidate by candidate, and the count rows equal
  ``shot_moments_a/b_plain``'s and ``shot_hist_a/b_plain``'s;
* the moment sums, in candidate order, are within 1e-5 of the plain
  version's on the scale Σw·R^k (the plain version sums in another
  order);
* a valid pass-B candidate with a negative posA is selected where
  |posA_c − posA_q| > band (the histograms once rejected it);
* the placed composition, pass B written at the pass-A rows and pass A
  adding them (``plus``), equals ``mom_a.T + mom_b.T[inv_b]`` bit for
  bit through the plain versions and the CPU wrappers;
* the wrappers refuse a bad ``out``, ``rows`` or ``plus``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu_torch.kernels import shot as tk  # noqa: E402
from threecrate_tpu_torch.ops import neighbors as tn  # noqa: E402
from union_clouds import spfh_inputs  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

_SRC = (Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
        / "shot.cu").read_text()
C = {name: int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))
     for name in ("kMomentQueries", "kHistWarps", "kShotGroup", "kUscGroup")}
MOMENT_BLOCK = C["kMomentQueries"]
HIST_BLOCK = {v: C["kHistWarps"] * 32 // C[g] for v, g in (("shot", "kShotGroup"),
                                                          ("usc", "kUscGroup"))}
GEOMETRY = [(0, 128), (32, 256), (64, 64)]
RADII = {"typical": 0.4, "whole": 100.0}
SCALE = 1.0
POWER = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 0, 3, 3, 3])
f32 = np.float32


def _n(tile):
    """Points of a case: a multiple of the tile, with a partial last
    moments block where the tile is narrower than a block."""
    n = max(3 * tile, 1024)
    return n + tile if tile < MOMENT_BLOCK and n % MOMENT_BLOCK == 0 else n


def _rows(tile, pass_b, odd=False, seed=0):
    """Stage-1 rows (7, N), or pass B's with the pass-A positions as an
    fp32 row 7 (8, N); ``odd``: some valid columns' positions replaced by
    −1, NaN, a fractional value or their negation (queries included)."""
    packed, pos = spfh_inputs(tile, SCALE, pass_b, n=_n(tile))
    if not pass_b:
        return packed
    pos = pos.to(torch.float32)
    if odd:
        rng = np.random.default_rng(seed)
        n = pos.shape[1]
        kind = rng.integers(0, 8, n)
        p = pos[0].numpy().copy()
        p = np.where(kind == 0, f32(-1), p)
        p = np.where(kind == 1, f32(np.nan), p)
        p = np.where(kind == 2, p + f32(0.5), p)
        p = np.where(kind == 3, -p, p)
        pos = torch.from_numpy(p.astype(np.float32))[None]
    return torch.cat([packed, pos]).contiguous()


def _moment_rows(packed, pass_b):
    """The moments' (4, N) rows, or pass B's (5, N) with posA as row 4."""
    return packed[[0, 1, 2, 3, 7] if pass_b else [0, 1, 2, 3]].contiguous()


def _staged(p, block, band, pos_row, pass_b):
    """(blocks, block + 2·band, 4) records of each block's staged span:
    (x, y, z, tag), tag NaN where the column is invalid or outside [0, N)."""
    n = p.shape[1]
    cols = np.arange(-(-n // block))[:, None] * block - band + np.arange(block + 2 * band)
    inside = (cols >= 0) & (cols < n)
    c = np.where(inside, cols, 0)
    tag = p[pos_row, c] if pass_b else np.zeros(c.shape, f32)
    tag = np.where(inside & (p[3, c] > 0.5), tag, f32(np.nan))
    xyz = np.where(inside, p[0:3, c], f32(0))
    return np.concatenate([xyz, tag[None]]).transpose(1, 2, 0).astype(f32)


def _sweep(p, block, band, r2, pos_row, pass_b):
    """The staged sweep of every query: (selection, d (3, N, C), d², tags),
    C = 2·band + 1, candidate k of query p at span entry p % block + k."""
    n = p.shape[1]
    recs = _staged(p, block, band, pos_row, pass_b)
    q = np.arange(n)
    cand = recs[(q // block)[:, None], (q % block)[:, None] + np.arange(2 * band + 1)]
    d = np.stack([cand[..., i] - p[i][:, None] for i in range(3)])
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    tag = cand[..., 3]
    with np.errstate(invalid="ignore"):
        ok = np.abs(tag - p[pos_row][:, None]) > f32(band) if pass_b else tag == f32(0)
    return ok & (d2 <= f32(r2)) & (d2 > f32(1e-18)), d, d2, tag


def _emulated_moments(p, band, r2, pass_b):
    """The kernel's (14, N) moments: each query's sums in candidate order."""
    sel, d, d2, _ = _sweep(p, MOMENT_BLOCK, band, r2, 4, pass_b)
    radius = f32(tk._radius_f32(r2))
    acc = np.zeros((14, p.shape[1]), f32)
    for k in range(sel.shape[1]):
        s = sel[:, k]
        dx, dy, dz, dd = d[0][:, k], d[1][:, k], d[2][:, k], d2[:, k]
        w = np.maximum(radius - np.sqrt(np.maximum(dd, f32(0))), f32(0))
        wx, wy, wz, wd2 = w * dx, w * dy, w * dz, w * dd
        terms = (w, wx, wy, wz, wx * dx, wy * dy, wz * dz, wx * dy, wx * dz, wy * dz,
                 np.ones_like(w), wd2 * dx, wd2 * dy, wd2 * dz)
        for m, t in enumerate(terms):
            acc[m] = np.where(s, acc[m] + t, acc[m])
    return acc, sel


def _plain_selection(packed, band, r2, pos_row):
    return tk.band_candidates(packed, 0, packed.shape[1], band, tk._r2_f32(r2), 1e-18,
                              pos_row)[4].numpy()


@pytest.mark.parametrize("radius", list(RADII))
@pytest.mark.parametrize("pass_", ["a", "b", "b odd posA"])
@pytest.mark.parametrize("band,tile", GEOMETRY)
def test_staged_moments_match_plain(band, tile, pass_, radius):
    pass_b = pass_ != "a"
    packed = _moment_rows(_rows(tile, pass_b, odd="odd" in pass_), pass_b)
    r2 = (RADII[radius] * SCALE) ** 2
    got, sel = _emulated_moments(packed.numpy(), band, r2, pass_b)
    np.testing.assert_array_equal(sel, _plain_selection(packed, band, r2,
                                                        4 if pass_b else None))
    ref = (tk.shot_moments_b_plain if pass_b else tk.shot_moments_a_plain)(
        packed, r2, band, tile).numpy()
    np.testing.assert_array_equal(got[10], ref[10])
    scale = np.maximum(ref[0], 1e-30)[None] * tk._radius_f32(r2) ** POWER[:, None]
    assert (np.abs(got - ref) / scale).max() <= 1e-5
    invalid = packed[3].numpy() <= 0.5
    if band == 0:
        assert (ref == 0).all()                 # the query alone: d² = 0 is dropped
    else:
        assert ref[10].mean() > 0.5
        assert (ref[10][invalid] > 0).any()     # invalid queries are served too


@pytest.mark.parametrize("variant", ["shot", "usc"])
@pytest.mark.parametrize("pass_", ["a", "b", "b odd posA"])
@pytest.mark.parametrize("band,tile", GEOMETRY)
def test_staged_hist_selection_matches_plain(band, tile, pass_, variant):
    """The histograms' staged records and tag test select what the plain
    version selects, and their count rows equal the plain count row."""
    pass_b = pass_ != "a"
    packed = _rows(tile, pass_b, odd="odd" in pass_, seed=1)
    r2 = (RADII["typical"] * SCALE) ** 2
    sel = _sweep(packed.numpy(), HIST_BLOCK[variant], band, r2, 7, pass_b)[0]
    np.testing.assert_array_equal(sel, _plain_selection(packed, band, r2,
                                                        7 if pass_b else None))
    q, _ = np.linalg.qr(np.random.default_rng(2).normal(size=(packed.shape[1], 3, 3)))
    x, y = q[:, :, 0], q[:, :, 1]
    lrf = torch.from_numpy(np.concatenate([x, y, np.cross(x, y)], 1).T
                           .astype(np.float32)).contiguous()
    ref = (tk.shot_hist_b_plain if pass_b else tk.shot_hist_a_plain)(
        packed, lrf, r2, band, tile, variant)
    np.testing.assert_array_equal(sel.sum(1), ref[-1].numpy())


@pytest.mark.parametrize("band,tile", GEOMETRY[1:])
def test_negative_posa_candidates_are_selected(band, tile):
    """Valid pass-B candidates with posA −1, fractional or NaN: the staged
    test is the Pallas test on their value. A −1 (or negated) candidate
    far from the query's posA is selected, which the histograms' earlier
    test (a tag of −1 meaning invalid, tag >= 0 required) rejected; a NaN
    one never is."""
    packed = _rows(tile, True, odd=True, seed=3)
    p = packed.numpy()
    r2 = (RADII["whole"] * SCALE) ** 2
    sel, _, _, tag = _sweep(p, HIST_BLOCK["shot"], band, r2, 7, True)
    assert sel[tag < 0].sum() > 0                       # negative posA selected
    assert sel[tag != np.floor(tag)].sum() > 0          # fractional posA selected
    assert not sel[np.isnan(tag)].any() and not sel[np.isnan(p[7])].any()
    with np.errstate(invalid="ignore"):
        old = sel & (tag >= 0)
    assert (old != sel).any()


def _placed_inputs(tile, seed=5):
    """Pass-A (4, N) rows, pass-B (5, N) rows with posA, and the pass-A
    row of each pass-B position (int32) of a cloud sorted twice."""
    pa = _rows(tile, False)
    n = pa.shape[1]
    row_a = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    pb = torch.cat([pa[0:4, row_a], row_a.to(torch.float32)[None]]).contiguous()
    return pa[0:4].contiguous(), pb, row_a


@pytest.mark.parametrize("band,tile", GEOMETRY)
def test_placed_merge_equals_gathered_sum(band, tile):
    """Pass B written at the pass-A rows into a NaN-filled (N, 16) buffer,
    then pass A with ``plus``: every row written (two zero pads), and the
    merged (14, N) rows equal mom_a.T + mom_b.T[inv_b] bit for bit,
    through the plain versions and the CPU wrappers alike."""
    pa, pb, row_a = _placed_inputs(tile)
    n, r2 = pa.shape[1], (RADII["typical"] * SCALE) ** 2
    mom_a = tk.shot_moments_a_plain(pa, r2, band, tile)
    mom_b = tk.shot_moments_b_plain(pb, r2, band, tile)
    want = (mom_a.T + mom_b.T[tn._inverse(row_a)]).T
    rows = row_a.to(torch.int32)
    for b_fn, a_fn in ((tk.shot_moments_b_plain, tk.shot_moments_a_plain),
                       (tk.shot_moments_b_tiles, tk.shot_moments_a_tiles)):
        buf = torch.full((n, tk.MOMENT_ROW), float("nan"))
        assert b_fn(pb, r2, band, tile, out=buf, rows=rows) is buf
        assert torch.equal(buf[row_a, :14], mom_b.T) and (buf[:, 14:] == 0).all()
        got = a_fn(pa, r2, band, tile, plus=buf)
        assert got.shape == (14, n) and torch.equal(got, want)
    if band:
        assert mom_b[10].sum() > 0


def _bad_moment_placements(n):
    """{case: (error, pass, keywords)} of placements the wrappers refuse."""
    ok = torch.zeros((n, tk.MOMENT_ROW))
    rows = torch.arange(n, dtype=torch.int32)
    return {
        "out width": (ValueError, "b", dict(out=torch.zeros((n, 14)), rows=rows)),
        "out dtype": (TypeError, "b", dict(out=ok.double(), rows=rows)),
        "out strided": (ValueError, "b", dict(out=torch.zeros((tk.MOMENT_ROW, n)).T,
                                              rows=rows)),
        "out device": (ValueError, "b", dict(out=ok.to("meta"), rows=rows)),
        "rows dtype": (TypeError, "b", dict(out=ok, rows=rows.long())),
        "rows length": (ValueError, "b", dict(out=ok, rows=rows[:-1])),
        "rows device": (ValueError, "b", dict(out=ok, rows=rows.to("meta"))),
        "rows range": (ValueError, "b", dict(out=ok, rows=rows + 1)),
        "rows negative": (ValueError, "b", dict(out=ok, rows=rows - 1)),
        "out alone": (ValueError, "b", dict(out=ok)),
        "rows alone": (ValueError, "b", dict(rows=rows)),
        "plus width": (ValueError, "a", dict(plus=torch.zeros((n, 14)))),
        "plus dtype": (TypeError, "a", dict(plus=ok.double())),
        "plus length": (ValueError, "a", dict(plus=ok[:-1])),
        "plus device": (ValueError, "a", dict(plus=ok.to("meta"))),
        "plus strided": (ValueError, "a", dict(plus=torch.zeros((2 * n, tk.MOMENT_ROW))[::2])),
    }


@pytest.mark.parametrize("case", list(_bad_moment_placements(8)))
def test_moment_wrappers_refuse_bad_placement(case):
    n, tile = 256, 128
    err, pass_, kwargs = _bad_moment_placements(n)[case]
    packed = torch.zeros(4 if pass_ == "a" else 5, n)
    for fn in ((tk.shot_moments_a_tiles, tk.shot_moments_a_plain) if pass_ == "a"
               else (tk.shot_moments_b_tiles, tk.shot_moments_b_plain)):
        with pytest.raises(err):
            fn(packed, 0.01, 16, tile, **kwargs)
