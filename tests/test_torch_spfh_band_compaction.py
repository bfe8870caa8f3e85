"""The compacted pair voting of the banded SPFH kernels, on the CPU.

``spfh_band_a_tiles`` and ``spfh_band_b_tiles`` (``csrc/fpfh.cu``) stage
each tile's span, the tile and ``band`` columns on each side, as (x, y,
z, w) records: w is 0 (pass A) or the column's fp32 pass-A position
(pass B) where the column is valid and NaN where it is not or lies
outside [0, N). A warp of ``kWarp`` consecutive queries (a narrower tile
leaves lanes idle) sweeps ``kBandSteps`` offsets a step: at offset j
lane l tests span column (its query's) + j − band, whether its query
selects it (pass A w == 0, pass B |w − posA_q| > band, and d² <= r2, d²
> 1e-12). Then the warp appends the step's (column, lane) pairs to its
ring of ``kBandQueue`` entries, offset by offset, each offset's in lane
order, and drains a warp of entries while the ring holds that many,
each lane voting one pair into its query's ``32 / kVotesPerWord``-bit
counters; at the end it drains the rest. A query's count is the sum of
its θ votes (each pair casts one).

Emulated here in numpy with the constants read from the source, that
sweep must give ``spfh_band_a_plain`` / ``spfh_band_b_plain``'s 34 rows
bit for bit (the votes of each drained pair from the plain version's own
pair arithmetic, ``fpfh._votes``), the ring must never hold more than
``kBandQueue`` entries nor lose one, and no counter may pass its width.

Inputs (``union_clouds.spfh_inputs``): packed stage-1 rows of small
clouds with duplicate points and 10% invalid columns (invalid queries
included, each still served), pass B with its pass-A positions as row 7;
bands 0, 1, 16, 48 and band = tile at tiles 8 and 16 (narrower than a
warp), 64 and 256, at scales 1e-2, 1 and 1e2, at a typical radius and
one that covers every neighbour; every case covers the first tile (no
columns before it) and the last (none after).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu_torch.kernels import fpfh  # noqa: E402
from union_clouds import spfh_inputs  # noqa: E402

_SRC = (Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
        / "fpfh.cu").read_text()
QUEUE, STEPS, WARP, THREADS, VOTES_PER_WORD = (
    int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))
    for name in ("kBandQueue", "kBandSteps", "kWarp", "kBandThreads", "kVotesPerWord"))
VOTE_BITS = 32 // VOTES_PER_WORD
MAX_BAND = 1024       # the wrappers' largest band (band <= tile <= 1024)
# radius / scale: a typical neighbourhood, every neighbour
RADII = {"typical": 0.4, "whole": 100.0}
CASES = [(tile, band) for tile in (8, 16, 64, 256)
         for band in sorted({0, 1, 16, 48, tile}) if band <= tile]


def _band_rows(tile, scale, pass_b):
    """Stage-1 rows (7, N), or pass B's (8, N) with the pass-A positions
    as fp32 row 7, as ``_fpfh_fused`` builds them."""
    packed, pos = spfh_inputs(tile, scale, pass_b)
    if pass_b:
        packed = torch.cat([packed, pos.to(torch.float32)]).contiguous()
    return packed


def _staged_w(p, tile, band, pass_b):
    """(N // tile, tile + 2·band) w of each block's staged span and the
    span's global columns."""
    n = p.shape[1]
    cols = np.arange(n // tile)[:, None] * tile - band + np.arange(tile + 2 * band)
    inside = (cols >= 0) & (cols < n)
    c = np.where(inside, cols, 0)
    w = p[7, c] if pass_b else np.zeros(c.shape, np.float32)
    return np.where(inside & (p[3, c] > 0.5), w, np.float32(np.nan)), cols


def _sweep(p, tile, band, r2, pass_b):
    """The kernels' sweep: (drained pairs as (query column, candidate
    column) arrays, each query's count)."""
    f32 = np.float32
    n = p.shape[1]
    lanes = min(tile, WARP)              # a narrower tile leaves lanes idle
    n_w = n // lanes
    w, cols = _staged_w(p, tile, band, pass_b)
    xyz = np.where((cols >= 0) & (cols < n), p[0:3, np.clip(cols, 0, n - 1)], f32(0))
    qi = np.arange(n) % tile                                   # query's place in its tile
    blk = np.arange(n) // tile
    span_c = qi[:, None] + np.arange(2 * band + 1)             # (N, 2·band + 1) span columns
    b = xyz[:, blk[:, None], span_c]
    d = b - p[0:3, :, None]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    bw = w[blk[:, None], span_c]
    with np.errstate(invalid="ignore"):
        cand = np.abs(bw - p[7][:, None]) > f32(band) if pass_b else bw == f32(0)
    sel = (cand & (d2 <= r2) & (d2 > f32(1e-12))).reshape(n_w, lanes, -1)
    span_c = span_c.reshape(n_w, lanes, -1)

    ring = np.full((n_w, QUEUE), -1)
    head = np.zeros(n_w, int)
    tail = np.zeros(n_w, int)
    drained_q, drained_c = [], []
    lane_ids = np.arange(WARP)
    warp0 = np.arange(n_w) * lanes                            # lane 0's query column

    def drain(warps, k):
        if len(warps) == 0:
            return
        slots = (head[warps][:, None] + lane_ids[:k]) % QUEUE
        e = ring[warps[:, None], slots]
        assert (e >= 0).all()                   # each entry written, and drained once
        ring[warps[:, None], slots] = -1
        q = warp0[warps][:, None] + e % WARP
        drained_q.append(q.ravel())
        drained_c.append(((q // tile) * tile - band + e // WARP).ravel())
        head[warps] += k

    for j0 in range(0, 2 * band + 1, STEPS):
        for j in range(j0, min(j0 + STEPS, 2 * band + 1)):
            s = sel[:, :, j]
            wi, li = np.nonzero(s)              # lane order within each warp
            before = np.cumsum(s, 1) - s
            slots = (tail[wi] + before[wi, li]) % QUEUE
            assert (ring[wi, slots] == -1).all()    # no entry overwritten undrained
            ring[wi, slots] = span_c[wi, li, j] * WARP + li
            tail += s.sum(1)
            assert (tail - head <= QUEUE).all()
        while True:                             # drain while a warp of pairs waits
            full = np.nonzero(tail - head >= WARP)[0]
            if len(full) == 0:
                break
            drain(full, WARP)
    for k in range(WARP):                        # each warp's last, partial drain
        drain(np.nonzero(tail - head == k)[0], k)
    assert (head == tail).all()
    empty = np.zeros(0, int)
    return (np.concatenate(drained_q or [empty]), np.concatenate(drained_c or [empty]),
            sel.sum(2).ravel())


def _votes_of(packed, pairs_q, pairs_c):
    """(33, N) votes of the drained pairs: the plain version's pair
    arithmetic on each (query, candidate column), added per query."""
    q, c = torch.from_numpy(pairs_q), torch.from_numpy(pairs_c)
    votes = torch.zeros((packed.shape[1], 33))
    d = [(packed[r, c] - packed[r, q])[:, None] for r in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    h = fpfh._votes(d, d2, torch.ones_like(d2, dtype=torch.bool),
                    [packed[r, q][:, None] for r in range(4, 7)],
                    [packed[r, c][:, None] for r in range(4, 7)])
    votes.index_add_(0, q, h[:, :33])          # integer counts, exact in fp32
    return votes.T.numpy()


@pytest.mark.parametrize("pass_b", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("radius", list(RADII))
@pytest.mark.parametrize("scale", [1e-2, 1.0, 1e2], ids=["1e-2", "1", "1e2"])
@pytest.mark.parametrize("tile,band", CASES)
def test_offset_sweep_matches_plain(tile, band, scale, radius, pass_b):
    packed = _band_rows(tile, scale, pass_b)
    r2 = fpfh._r2_f32((RADII[radius] * scale) ** 2)
    plain = fpfh.spfh_band_b_plain if pass_b else fpfh.spfh_band_a_plain
    rows = plain(packed, r2, band, tile).numpy()
    pairs_q, pairs_c, cnt = _sweep(packed.numpy(), tile, band, np.float32(r2), pass_b)
    np.testing.assert_array_equal(cnt.astype(np.float32), rows[33])
    assert len(pairs_q) == rows[33].sum()
    votes = _votes_of(packed, pairs_q, pairs_c)
    np.testing.assert_array_equal(votes, rows[:33])
    np.testing.assert_array_equal(votes[:11].sum(0), rows[33])   # the count, from θ
    # no counter passes its width, at this band or the widest the wrappers take
    assert rows[:33].max(initial=0) < 2 ** VOTE_BITS and 2 * MAX_BAND + 1 < 2 ** VOTE_BITS
    valid = packed[3].numpy() > 0.5
    if band == 0:
        assert rows[33].sum() == 0
    elif band >= 16:
        # invalid queries are served too, and a wide radius fills the ring
        assert rows[33][~valid].sum() > 0
        if radius == "whole" and not pass_b:
            assert rows[33][valid].mean() > band


def test_block_constants():
    """A block holds whole warps, and the ring takes a step's appends on
    top of a partial warp without wrapping onto an undrained entry."""
    assert THREADS % WARP == 0 and QUEUE >= (STEPS + 1) * WARP
