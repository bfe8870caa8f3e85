"""The compacted pair voting of the SPFH histogram kernels, on the CPU.

``spfh_a_tiles`` and ``spfh_b_tiles`` (``csrc/fpfh.cu``) stage each
3-tile window as (x, y, z, tag) records (pass B's tag is the column's
pass-A tile) with the bounding boxes of its ``kSpfhChunk``-column chunks
(one tile where the tile is smaller). A warp of ``kWarp`` queries sweeps
the window in column order, past the chunks whose box distance, shrunk
by ``kCullMargin``, lies above r2 for every one of its queries. At each
column the lanes whose query selects it (valid, d² <= r2, d² > 1e-12
and, in pass B, more than one pass-A tile away) append (column, lane)
to the warp's ring of ``kQueue`` entries in lane order; whenever the
ring holds a warp of entries the warp drains one, each lane voting one
pair into its query's counters, and at the end it drains the rest.

Emulated here in numpy with the constants read from the sources, that
sweep must give ``spfh_a_plain`` / ``spfh_b_plain``'s 34 rows bit for
bit (the votes of each drained pair from the plain version's own pair
arithmetic, ``fpfh._votes``), no culled chunk may hold a column the
plain version selects, and the ring must never hold more than ``kQueue``
entries nor lose one.

Inputs (``union_clouds.spfh_inputs``): packed stage-1 rows of small
clouds with duplicate points and 10% invalid columns, at three radii
(one that selects nothing, a typical one and one that covers the whole
window) and both passes, at scales 1e-2, 1 and 1e2 with tiles 8 and 16
(blocks narrower than a warp), 64 and 256, and at scale 1 with tile
1024; every case covers the first tile (no prev) and the last (no next).

``chip_smoke.open_columns``, which counts the candidates of the kernels'
operation bound, must count exactly the columns this box test keeps.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu_torch.kernels import fpfh  # noqa: E402
from union_clouds import spfh_inputs  # noqa: E402

_CSRC = Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
_SRC = (_CSRC / "fpfh.cu").read_text()
CHUNK, QUEUE, WARP = (int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))
                      for name in ("kSpfhChunk", "kQueue", "kWarp"))
MARGIN = np.float32(1) - np.float32(1) / np.float32(
    re.search(r"kCullMargin = 1\.f - 1\.f / (\d+)\.f;",
              (_CSRC / "window.cuh").read_text()).group(1))
# radius / scale: nothing in radius (below the closest distinct pair), a
# typical neighbourhood, every window column
RADII = {"none": 1e-4, "typical": 0.4, "whole": 100.0}
# (tile, scale): three scales at tiles 8 to 256, tile 1024 at scale 1
GEOMETRY = ([(tile, scale) for tile in (8, 16, 64, 256) for scale in (1e-2, 1.0, 1e2)]
            + [(1024, 1.0)])
_PAIR_BATCH = 1 << 20


def _window_selection(p, pos, tile, r2):
    """(selected (N, 3·tile), beyond (N, 3·tile)): each query's selection
    of its window columns before culling, and the columns of the chunks
    whose fp32 box bound lies beyond r2 for it."""
    f32, inf = np.float32, np.float32(np.inf)
    n = p.shape[1]
    chunk = min(CHUNK, tile)
    shift = tile.bit_length() - 1
    n_t = n // tile
    cols = (np.arange(n_t)[:, None] - 1) * tile + np.arange(3 * tile)      # (T, 3·tile)
    inside = (cols >= 0) & (cols < n)
    c = np.where(inside, cols, 0)
    ok = inside & (p[3, c] > 0.5)
    w = np.where(ok[None], p[0:3, c], np.nan).reshape(3, n_t, -1, chunk)
    lo = np.where(np.isnan(w), inf, w).min(3)                              # (3, T, chunks)
    hi = np.where(np.isnan(w), -inf, w).max(3)
    q = p[0:3].reshape(3, n_t, tile, 1)
    with np.errstate(invalid="ignore", over="ignore"):
        gap = np.maximum(np.maximum(lo[:, :, None] - q, q - hi[:, :, None]), f32(0))
        lb = ((gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]) * MARGIN
    beyond = np.repeat(lb > np.maximum(r2, f32(1e-30)), chunk, 2)           # (T, tile, 3·tile)
    d = p[0:3, c][:, :, None, :] - q
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    sel = ok[:, None] & (d2 <= r2) & (d2 > f32(1e-12))
    if pos is not None:
        dt = (pos[c] >> shift)[:, None, :] - (pos.reshape(n_t, tile, 1) >> shift)
        sel &= (dt < -1) | (dt > 1)
    return sel.reshape(n, 3 * tile), beyond.reshape(n, 3 * tile)


def _sweep(p, pos, tile, r2):
    """The kernels' sweep: (drained pairs as (query column, window column
    index) arrays, each lane's count, the (N, 3·tile) selection before
    culling and the culled columns)."""
    n = p.shape[1]
    lanes = min(tile, WARP)              # a narrower tile leaves lanes idle
    n_w = n // lanes
    sel, beyond = _window_selection(p, pos, tile, r2)
    # a warp passes over a chunk only where every one of its queries may
    culled = np.repeat(beyond.reshape(n_w, lanes, -1).all(1), lanes, 0)
    swept = (sel & ~culled).reshape(n_w, lanes, -1)
    ring = np.full((n_w, QUEUE), -1)
    head = np.zeros(n_w, int)
    tail = np.zeros(n_w, int)
    drained_q, drained_c = [], []
    lane_ids = np.arange(WARP)

    def drain(warps, k):
        if len(warps) == 0:
            return
        slots = (head[warps][:, None] + lane_ids[:k]) % QUEUE
        e = ring[warps[:, None], slots]
        assert (e >= 0).all()                   # each entry drained once
        ring[warps[:, None], slots] = -1
        drained_q.append((warps[:, None] * lanes + e % WARP).ravel())
        drained_c.append((e // WARP).ravel())
        head[warps] += k

    for c in range(3 * tile):
        s = swept[:, :, c]
        if not s.any():
            continue
        wi, li = np.nonzero(s)                  # lane order within each warp
        before = np.cumsum(s, 1) - s
        slots = (tail[wi] + before[wi, li]) % QUEUE
        assert (ring[wi, slots] == -1).all()    # no entry overwritten undrained
        ring[wi, slots] = c * WARP + li
        tail += s.sum(1)
        assert (tail - head <= QUEUE).all()
        drain(np.nonzero(tail - head >= WARP)[0], WARP)
        assert (tail - head < WARP).all()
    for k in range(WARP):                        # each warp's last, partial drain
        drain(np.nonzero(tail - head == k)[0], k)
    assert (head == tail).all()
    return (np.concatenate(drained_q), np.concatenate(drained_c), swept.sum(2).ravel(),
            sel, culled)


def _votes_of(packed, pairs_q, pairs_c, tile):
    """(33, N) votes of the drained pairs: the plain version's pair
    arithmetic on each (query, window column), added per query."""
    n = packed.shape[1]
    pairs_q = torch.from_numpy(pairs_q)
    cand = (pairs_q // tile - 1) * tile + torch.from_numpy(pairs_c)
    votes = torch.zeros((n, 33))
    for s in range(0, len(pairs_q), _PAIR_BATCH):
        q, c = pairs_q[s:s + _PAIR_BATCH], cand[s:s + _PAIR_BATCH]
        d = [(packed[r, c] - packed[r, q])[:, None] for r in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        h = fpfh._votes(d, d2, torch.ones_like(d2, dtype=torch.bool),
                        [packed[r, q][:, None] for r in range(4, 7)],
                        [packed[r, c][:, None] for r in range(4, 7)])
        votes.index_add_(0, q, h[:, :33])      # integer counts, exact in fp32
    return votes.T.numpy()


@pytest.mark.parametrize("pass_b", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("radius", list(RADII))
@pytest.mark.parametrize("tile,scale", GEOMETRY)
def test_compacted_sweep_matches_plain(tile, scale, radius, pass_b, monkeypatch):
    if tile >= 1024:
        monkeypatch.setattr(fpfh, "_CHUNK_TILES", 1)     # one tile's pairs at a time
    packed, pos = spfh_inputs(tile, scale, pass_b)
    r2 = fpfh._r2_f32((RADII[radius] * scale) ** 2)
    if pass_b:
        rows = fpfh.spfh_b_plain(packed, pos, r2, tile).numpy()
    else:
        rows = fpfh.spfh_a_plain(packed, r2, tile).numpy()
    pos_np = None if pos is None else pos[0].numpy()
    pairs_q, pairs_c, cnt, sel, culled = _sweep(packed.numpy(), pos_np, tile, np.float32(r2))
    # the selection before culling is the plain version's, and culling
    # passes over none of it
    np.testing.assert_array_equal(sel.sum(1).astype(np.float32), rows[33])
    assert not (sel & culled).any()
    np.testing.assert_array_equal(cnt.astype(np.float32), rows[33])
    np.testing.assert_array_equal(_votes_of(packed, pairs_q, pairs_c, tile), rows[:33])
    assert len(pairs_q) == rows[33].sum()
    valid = packed[3].numpy() > 0.5
    if radius == "none":
        assert rows[33].sum() == 0 and culled[valid].any()
    elif radius == "typical":
        assert 0 < rows[33][valid].mean() < 3 * tile
    else:   # pass A takes the whole valid window, pass B what lies beyond ±1 A tile
        assert rows[33][valid].mean() > (0 if pass_b else tile / 2)


@pytest.mark.parametrize("pass_b", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("radius", list(RADII))
@pytest.mark.parametrize("tile", [8, 64, 256])
def test_bound_counts_unculled_columns(tile, radius, pass_b):
    """``chip_smoke.open_columns``, which sets the operation bound of
    kernels 6-9, counts for each valid query the columns of the chunks
    that the sweep's box test cannot exclude, and one test per chunk."""
    import chip_smoke
    packed, pos = spfh_inputs(tile, 1.0, pass_b)
    r2 = fpfh._r2_f32(RADII[radius] ** 2)
    pos_np = None if pos is None else pos[0].numpy()
    _, beyond = _window_selection(packed.numpy(), pos_np, tile, np.float32(r2))
    valid = packed[3].numpy() > 0.5
    cols, tests = chip_smoke.open_columns(packed, tile, r2, "kSpfhChunk")
    assert cols == (~beyond)[valid].sum()
    assert tests == valid.sum() * 3 * tile // min(CHUNK, tile)
