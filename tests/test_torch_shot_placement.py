"""Query-major placement of the SHOT/USC histogram kernels, on the CPU.

``shot_hist_a_tiles`` / ``shot_hist_b_tiles`` (``csrc/shot.cu``) write
each query's dim + 1 floats as one row of an ``(n_rows, dim + 1)``
buffer at row ``rows[p]``, or add them to what the row holds, so that
``_shot_fused`` sums pass B (written at each position's input row) and
pass A (added at its input row) with no gather of a histogram tensor.
Held here, on small clouds (a smooth height field with its analytic
normals and an invalid tail, Morton-sorted twice as ``_shot_fused``
sorts it, with random orthonormal frames from a numpy seed; tiles 128
and 256, bands 16 and 32, both variants):

* the plain versions' placed modes equal their unplaced outputs,
  permuted and summed, bit for bit;
* the new ``_shot_fused`` equals the old composition (pass B gathered
  into pass-A order, + pass A, a column norm, a row gather to input
  order): valid flags equal, USC descriptors bit-equal (integer counts),
  SHOT within 1e-6 per element (a row norm against a column norm: the
  same squares summed in another order);
* an emulation of the kernel's vote order (``kShotGroup`` or
  ``kUscGroup`` lanes a query, candidates in rounds of that many; in
  each round the lower bins in lane order, then the upper ones; at 8,
  16 and 32 lanes) against the plain version:
  count rows equal, the same bins voted, USC rows bit-equal and SHOT
  votes within 1e-5 of each query's count (the plain version's
  ``scatter_add_`` sums all lower votes first);
* the wrappers refuse a bad ``out`` or ``rows``, and ``rows`` or
  ``accumulate`` without ``out``.

The Pallas parity of the plain versions is ``tests/test_torch_shot_kernels.py``'s.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu_torch.kernels import shot as tk  # noqa: E402
from threecrate_tpu_torch.ops import features as tf  # noqa: E402
from threecrate_tpu_torch.ops import neighbors as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

_SRC = (Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
        / "shot.cu").read_text()
# the lanes a query of the committed kernels, by variant
GROUP = {v: int(re.search(rf"constexpr int k{v.capitalize()}Group = (\d+);", _SRC).group(1))
         for v in ("shot", "usc")}
# (band, tile) of the placed and fused cases; the emulation adds band 0
GEOMETRY = [(16, 128), (32, 256)]
N, RADIUS = 6000, 0.1
VARIANTS = {"shot": tk.SHOT_DIM, "usc": tk.USC_DIM}


def _cloud(n=N, seed=0):
    """Points, normals and mask (an invalid tail) of a smooth height field."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    nrm = np.stack([-0.8 * np.cos(xy[:, 0] * 2.0), 0.51 * np.sin(xy[:, 1] * 1.7),
                    np.ones(n)], -1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = np.ones(n, bool)
    mask[-50:] = False
    return (torch.from_numpy(np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)),
            torch.from_numpy(nrm.astype(np.float32)), torch.from_numpy(mask))


def _frames(n, seed):
    """(9, n) random orthonormal frames [x, y, z] with z = x × y."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, 3, 3)))
    x, y = q[:, :, 0], q[:, :, 1]
    return torch.from_numpy(np.concatenate([x, y, np.cross(x, y)], 1).T
                            .astype(np.float32)).contiguous()


def _inputs(tile, seed=0):
    """Pass-A rows (7, N), pass-B rows (8, N) with posA, frames in both
    orders, and the input row of each pass-A and pass-B position (int32),
    as ``_shot_fused`` builds them."""
    pts, nrm, mask = _cloud(seed=seed)
    pa, pb, row_a, perm_a = tf.fused_stage1_inputs(pts, mask, nrm, tile)
    p8 = torch.cat([pb, row_a.to(torch.float32)[None]]).contiguous()
    lrf = _frames(pa.shape[1], seed + 1)
    rows_a = perm_a.to(torch.int32)
    return pa, p8, lrf, lrf[:, row_a].contiguous(), rows_a, rows_a[row_a]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("band,tile", GEOMETRY)
def test_placed_modes_equal_unplaced(variant, band, tile):
    """Pass B written at its input rows, then pass A added at its input
    rows, equal the unplaced outputs scattered and summed; the wrappers
    on CPU tensors place as the plain versions do."""
    pa, p8, lrf, lrf_b, rows_a, rows_b = _inputs(tile)
    dim, r2 = VARIANTS[variant], RADIUS * RADIUS
    ha = tk.shot_hist_a_plain(pa, lrf, r2, band, tile, variant)
    hb = tk.shot_hist_b_plain(p8, lrf_b, r2, band, tile, variant)
    assert ha.shape == hb.shape == (dim + 1, pa.shape[1])
    assert ha[dim].mean() > 5 and hb[dim].mean() > 1          # real neighbourhoods
    ref = torch.zeros((pa.shape[1], dim + 1))
    ref[rows_b.long()] = hb.T
    out = torch.full_like(ref, float("nan"))
    assert tk.shot_hist_b_plain(p8, lrf_b, r2, band, tile, variant, out=out,
                                rows=rows_b) is out
    assert torch.equal(out, ref)                       # every row written
    ref[rows_a.long()] += ha.T
    tk.shot_hist_a_plain(pa, lrf, r2, band, tile, variant, out=out, rows=rows_a,
                         accumulate=True)
    assert torch.equal(out, ref)
    via = torch.full_like(ref, float("nan"))
    tk.shot_hist_b_tiles(p8, lrf_b, r2, band, tile, variant, out=via, rows=rows_b)
    tk.shot_hist_a_tiles(pa, lrf, r2, band, tile, variant, out=via, rows=rows_a,
                         accumulate=True)
    assert torch.equal(via, ref)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_placement_keeps_other_rows(variant):
    """A write without ``rows`` fills rows 0 … N−1 of a taller buffer and
    leaves the rest; an add at a random permutation adds row by row."""
    band, tile = GEOMETRY[0]
    pa, _, lrf, _, _, _ = _inputs(tile, seed=3)
    dim, r2, n = VARIANTS[variant], RADIUS * RADIUS, pa.shape[1]
    ha = tk.shot_hist_a_plain(pa, lrf, r2, band, tile, variant)
    out = torch.full((n + 7, dim + 1), -1.0)
    tk.shot_hist_a_plain(pa, lrf, r2, band, tile, variant, out=out)
    assert torch.equal(out[:n], ha.T) and (out[n:] == -1).all()
    perm = torch.from_numpy(np.random.default_rng(4).permutation(n + 7)[:n]
                            .astype(np.int32))
    base = torch.from_numpy(np.random.default_rng(5).uniform(0, 3, (n + 7, dim + 1))
                            .astype(np.float32))
    got = base.clone()
    tk.shot_hist_a_tiles(pa, lrf, r2, band, tile, variant, out=got, rows=perm,
                         accumulate=True)
    ref = base.clone()
    ref[perm.long()] = base[perm.long()] + ha.T
    assert torch.equal(got, ref)


def _old_composition(points, mask, nrm, radius, variant, band, tile):
    """``_shot_fused`` as it was composed before the placed kernels:
    pass B of the moments and of the histograms gathered into pass-A
    order, + pass A, a column norm, then a row gather of the transposed
    descriptors into input order."""
    n = points.shape[0]
    r2 = radius * radius
    packed_a, packed_b, row_a, perm_a = tf.fused_stage1_inputs(points, mask, nrm, tile)
    pos_a = row_a.to(torch.float32)[None]
    mom_a = tk.shot_moments_a_tiles(packed_a[0:4].contiguous(), r2, band, tile)
    mom_b = tk.shot_moments_b_tiles(torch.cat([packed_b[0:4], pos_a]).contiguous(), r2,
                                    band, tile)
    inv_b = tn._inverse(row_a)
    lrf = tf.lrf_from_moments(mom_a.T + mom_b.T[inv_b], radius,
                              packed_a[4:7].T if variant == "shot" else None)
    h = tk.shot_hist_b_tiles(torch.cat([packed_b, pos_a]).contiguous(),
                             lrf[row_a].T.contiguous(), r2, band, tile, variant)[:, inv_b]
    h += tk.shot_hist_a_tiles(packed_a, lrf.T.contiguous(), r2, band, tile, variant)
    valid_s = (packed_a[3] > 0.5) & (h[-1] >= 5)
    desc = h[:-1]
    desc /= torch.clamp_min(torch.linalg.vector_norm(desc, dim=0), 1e-12)
    desc *= valid_s
    inv_a = tn._inverse(perm_a)
    return desc.T[inv_a][:n], valid_s[inv_a][:n] & mask


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("band,tile", GEOMETRY)
def test_shot_fused_equals_old_composition(variant, band, tile, monkeypatch):
    """The placed merges (moments: pass B at its pass-A rows, pass A adding
    them; histograms: pass B at its input rows, pass A adding) give the
    old gathered composition's descriptors, with no inverse permutation
    formed."""
    pts, nrm, mask = _cloud(seed=7)
    nrm_in = nrm if variant == "shot" else torch.zeros_like(nrm)
    inverses = []
    inverse = tn._inverse
    monkeypatch.setattr(tn, "_inverse", lambda perm: inverses.append(perm) or inverse(perm))
    desc, valid = tf._shot_fused(pts, mask, nrm_in, RADIUS, variant, band, tile)
    assert not inverses
    monkeypatch.undo()
    ref, ref_valid = _old_composition(pts, mask, nrm_in, RADIUS, variant, band, tile)
    assert desc.shape == ref.shape == (N, VARIANTS[variant])
    assert torch.equal(valid, ref_valid) and valid.float().mean() > 0.5
    if variant == "usc":
        assert torch.equal(desc, ref)
    else:
        assert (desc - ref).abs().max().item() <= 1e-6
    assert (desc[~valid] == 0).all()


def _emulated(packed, lrf, r2, band, tile, excl, variant, group):
    """The kernel's histogram rows (N, dim + 1): candidates k = 0 … 2·band
    in rounds of ``group`` lanes; in a round the lower votes land lane by
    lane, then the upper ones, each an fp32 add to its query's row."""
    dim = VARIANTS[variant]
    n = packed.shape[1]
    sel, lo_bin, v_lo, hi_bin, v_hi = (t.numpy() for t in tk.candidate_votes(
        packed, lrf, r2, band, 0, n, excl, variant))
    # SHOT's upper vote where the lower bin is not the top one
    split = sel & (hi_bin != lo_bin) if variant == "shot" else np.zeros_like(sel)
    hist = np.zeros((n, dim + 1), np.float32)
    q = np.arange(n)
    width = 2 * band + 1
    for k0 in range(0, width, group):
        lanes = range(k0, min(k0 + group, width))
        for bins, votes, on in ((lo_bin, v_lo, sel), (hi_bin, v_hi, split)):
            for k in lanes:
                m = on[:, k]
                hist[q[m], bins[m, k]] = hist[q[m], bins[m, k]] + votes[m, k]
    hist[:, dim] = sel.sum(1)
    return hist


@pytest.mark.parametrize("group", sorted({32, 16, 8, *GROUP.values()}))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("pass_", ["a", "b"])
@pytest.mark.parametrize("band,tile", [(0, 128), *GEOMETRY])
def test_kernel_vote_order_matches_plain(group, variant, pass_, band, tile):
    pa, p8, lrf, lrf_b, _, _ = _inputs(tile, seed=11)
    packed, frames = (pa, lrf) if pass_ == "a" else (p8, lrf_b)
    dim, r2 = VARIANTS[variant], RADIUS * RADIUS
    ref = (tk.shot_hist_a_plain if pass_ == "a" else tk.shot_hist_b_plain)(
        packed, frames, r2, band, tile, variant).T.numpy()
    got = _emulated(packed, frames, r2, band, tile, pass_ == "b", variant, group)
    np.testing.assert_array_equal(got[:, dim], ref[:, dim])
    np.testing.assert_array_equal(got[:, :dim] != 0, ref[:, :dim] != 0)
    if band == 0:
        assert (ref == 0).all()                 # the query alone: d² = 0 is dropped
    else:
        assert ref[:, dim].mean() > (5 if pass_ == "a" else 1)
    if variant == "usc":
        np.testing.assert_array_equal(got, ref)
    else:
        err = np.abs(got[:, :dim] - ref[:, :dim]).max(1)
        assert (err <= 1e-5 * np.maximum(ref[:, dim], 1)).all(), err.max()


def _bad_placements(n, dim):
    """{case: (error, keywords)} of placements the wrappers refuse."""
    ok = torch.zeros((n, dim + 1))
    rows = torch.arange(n, dtype=torch.int32)
    return {
        "out shape": (ValueError, dict(out=torch.zeros((n, dim)))),
        "out rows": (ValueError, dict(out=torch.zeros((n - 1, dim + 1)))),
        "out dtype": (TypeError, dict(out=ok.double())),
        "out strided": (ValueError, dict(out=torch.zeros((dim + 1, n)).T)),
        "rows dtype": (TypeError, dict(out=ok, rows=rows.long())),
        "rows length": (ValueError, dict(out=ok, rows=rows[:-1])),
        "rows device": (ValueError, dict(out=ok, rows=rows.to("meta"))),
        "rows range": (ValueError, dict(out=ok, rows=rows + 1)),
        "rows negative": (ValueError, dict(out=ok, rows=rows - 1)),
        "accumulate alone": (ValueError, dict(accumulate=True)),
        "rows alone": (ValueError, dict(rows=rows)),
    }


@pytest.mark.parametrize("case", list(_bad_placements(8, 1)))
def test_wrappers_refuse_bad_placement(case):
    n, tile = 256, 128
    for variant, dim in VARIANTS.items():
        err, kwargs = _bad_placements(n, dim)[case]
        for wrapper, rows in ((tk.shot_hist_a_tiles, 7), (tk.shot_hist_b_tiles, 8)):
            with pytest.raises(err):
                wrapper(torch.zeros(rows, n), torch.zeros(9, n), 0.01, 16, tile, variant,
                        **kwargs)
