"""The culled sweep of the ICP correspondence kernel, on the CPU.

``icp_match_tiles`` (``csrc/icp_match.cu``, records body) stages each
source tile's window of w_tiles·tile target columns as (x, y, z, tag)
records with the bounding boxes of their ``kChunk``-column chunks; a
target at the sentinel magnitude ``kFarTarget`` is tagged out of the
boxes. ``kIcpQueries`` points share a thread (point i with i ± T, T =
⌈tile / Q⌉). A warp sweeps the chunks by the fp32 box distance of its
points' centroid, nearest first (with more than 32 chunks: from the
window's middle tile on), and a thread passes over a chunk whose fp32
box bound (shrunk by ``kCullMargin``) exceeds the running minimum of
each of its points; a block with a point at or above ``kNearQuery`` in
magnitude culls nothing. Each point keeps its minimum d², the column
where it last fell and the number of columns at it; exact ties average
their payloads, summed in column order from column 0.

Emulated here in numpy with the constants read from the sources, that
sweep must give the minimum and tie count of a full sweep in column
order (the rows body's, and the Pallas kernel's selection), the same
column where the minimum is unique, and payloads equal to
``icp_match_plain``'s: the match flag bit for bit everywhere, every row
bit for bit where the nearest target is unique, and within 1e-6 (1e-4
at scale 1e2) where ties average (the plain version sums them in a
matmul). A few cases go on to the Pallas kernel in interpret mode,
which ``tests/test_torch_kernels.py`` also holds the plain version
against.

Inputs: Morton-sorted targets with duplicates (ties), a sentinel tail
and a few targets invalid at random; sources near them, Morton-sorted in
the target's frame with the tile-mean key's window, a few invalid; one
tile's window wholly in the sentinel tail (no match), one window
reaching past each end of the target (columns outside are sentinels);
w_tiles 3, 4 and 16, E 0, 3 and 6, at scales 1e-2, 1 and 1e2, and at
tiles 8, 100 and 128. ``chip_smoke.icp_open_columns``, which counts the
candidates of the kernel's operation bound, must count exactly the
columns of the chunks whose box bound does not exceed each point's
final minimum.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.kernels.icp_pallas import icp_match_tiles as pallas_icp  # noqa: E402
from threecrate_tpu_torch.kernels.icp import icp_match_plain  # noqa: E402
from threecrate_tpu_torch.ops import morton  # noqa: E402

_CSRC = Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
_SRC = (_CSRC / "icp_match.cu").read_text()
_HDR = (_CSRC / "window.cuh").read_text()
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", _HDR).group(1))
QUERIES = int(re.search(r"constexpr int kIcpQueries = (\d+);", _SRC).group(1))
SENTINEL = np.float32(re.search(r"constexpr float kSentinel = ([0-9e.]+)f;", _SRC).group(1))
_far = re.search(r"constexpr float kFarTarget = (\w+);", _SRC).group(1)
FAR = SENTINEL if _far == "kSentinel" else np.float32(_far.rstrip("f"))
NEAR = np.float32(re.search(r"constexpr float kNearQuery = ([0-9e.]+)f;", _SRC).group(1))
MARGIN = np.float32(1) - np.float32(1) / np.float32(
    re.search(r"kCullMargin = 1\.f - 1\.f / (\d+)\.f;", _HDR).group(1))
WARP_ORDER = re.search(r"constexpr bool kWarpOrder = (\w+);", _SRC).group(1) == "true"
F32 = np.float32


def icp_case(tile, w_tiles, n_extra, scale, seed=0, special=True):
    """(src (4, Ns), tgt (4+E, Nt), window_start) numpy inputs as the
    static-sort ICP builds them (Nt = 20 tiles, Ns = 8 tiles)."""
    rng = np.random.default_rng(seed + 7 * w_tiles + n_extra)
    nt, ns = 20 * tile, 8 * tile
    n_valid = nt - 2 * tile - 5
    x = (rng.normal(0, 1, (nt, 3)) * scale).astype(np.float32)
    x[1:n_valid:7] = x[0:n_valid - 1:7]                 # duplicate targets: ties
    tm = np.arange(nt) < n_valid
    tm[rng.choice(n_valid, 6, replace=False)] = False
    pts, mask = torch.from_numpy(x), torch.from_numpy(tm)
    mn, sc = morton.frame(pts, mask)
    keys, order = torch.sort(morton.keys_in_frame(pts, mask, mn, sc), stable=True)
    tv = tm[order.numpy()]
    coords = np.where(tv[:, None], x[order.numpy()], SENTINEL)
    extra = rng.normal(0, 1, (n_extra, nt)).astype(np.float32)
    tgt = np.concatenate([coords.T, tv[None].astype(np.float32), extra]).astype(np.float32)
    # sources: noisy copies of valid targets, some exactly on a target
    pick = rng.choice(np.nonzero(tm)[0], ns)
    src = x[pick] + (rng.normal(0, 0.02, (ns, 3)) * scale).astype(np.float32)
    src[::9] = x[pick[::9]]
    sp = torch.from_numpy(src)
    sm = torch.ones(ns, dtype=torch.bool)
    so = torch.sort(morton.keys_in_frame(sp, sm, mn, sc), stable=True).indices.numpy()
    src = src[so]
    reps = torch.from_numpy(src.reshape(-1, tile, 3).mean(1))
    rep_keys = morton.keys_in_frame(reps, torch.ones(len(reps), dtype=torch.bool), mn, sc)
    ws = np.clip(torch.searchsorted(keys, rep_keys).numpy() // tile - (w_tiles - 1) // 2,
                 0, nt // tile - w_tiles).astype(np.int32)
    valid_s = (rng.uniform(0, 1, ns) > 0.1).astype(np.float32)
    if special:
        ws[1] = nt // tile - 1                                       # in the sentinel tail
        ws[2] = -1                                                   # before the first tile
        ws[3] = nt // tile - w_tiles + 1                             # past the last tile
    return (np.concatenate([src.T, valid_s[None]]).astype(np.float32), tgt, ws)


def _window(tgt, ws, tile, w_tiles):
    """Staged records of each source tile's window: coordinates (3, T, wc)
    with sentinels outside the target, the tag (T, wc) (in the boxes) and
    the payload rows (E, T, wc)."""
    nt = tgt.shape[1]
    cols = ws[:, None].astype(np.int64) * tile + np.arange(w_tiles * tile)
    inside = (cols >= 0) & (cols < nt)
    c = np.clip(cols, 0, nt - 1)
    xyz = np.where(inside[None], tgt[0:3, c], SENTINEL).astype(np.float32)
    near = inside & (np.abs(xyz).max(0) < FAR)
    extra = np.where(inside[None], tgt[4:, c], F32(0)).astype(np.float32)
    return xyz, near, extra


def _d2(xyz, q):
    """(Ns, wc) d² of each source point to its tile's window columns, in
    tc::sq_dist's order: dx = c − q, ((dx² + dy²) + dz²)."""
    tile = q.shape[1] // xyz.shape[1]
    w = np.repeat(xyz, tile, axis=1)                       # (3, Ns, wc)
    with np.errstate(over="ignore", invalid="ignore"):
        d = [w[r] - q[r][:, None] for r in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def _boxes(xyz, near, chunk):
    """(lo, hi) (3, T, n_chunks) of each chunk's tagged columns."""
    t, wc = near.shape
    nch = -(-wc // chunk)
    pad = nch * chunk - wc
    inf = F32(np.inf)
    w = np.pad(np.where(near[None], xyz, np.nan), ((0, 0), (0, 0), (0, pad)),
               constant_values=np.nan).reshape(3, t, nch, chunk)
    return (np.where(np.isnan(w), inf, w).min(3), np.where(np.isnan(w), -inf, w).max(3))


def _box_bound(lo, hi, q, tile):
    """(Ns, n_chunks) fp32 box bound of tc::chunk_beyond for each point."""
    lo_q, hi_q = np.repeat(lo, tile, axis=1), np.repeat(hi, tile, axis=1)
    with np.errstate(over="ignore", invalid="ignore"):
        gap = np.maximum(np.maximum(lo_q - q[:, :, None], q[:, :, None] - hi_q), F32(0))
        return ((gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]) * MARGIN


def _warp_orders(q, lo, hi, tile, threads, w_tiles):
    """(warps, n_chunks) chunk order of each warp of the records body:
    by the fp32 box distance of the warp's centroid (its lanes' sums of
    their QUERIES points, added across lanes as the xor butterfly adds
    them), nearest first, where the block has full warps and at most 32
    chunks; else the middle tile first, then the chunks after it and
    those before. Warp w of tile t holds threads 32·(w % ⌈T/32⌉) on."""
    nch = lo.shape[2]
    n_t = q.shape[1] // tile
    wpt = -(-threads // 32)                            # warps a tile
    ch0 = ((w_tiles - 1) // 2) * tile // CHUNK
    cyclic = (ch0 + np.arange(nch)) % nch
    if not (WARP_ORDER and nch <= 32 and threads % 32 == 0):
        return np.repeat(cyclic[None], n_t * wpt, 0)
    members = np.minimum(np.arange(threads)[:, None] + threads * np.arange(QUERIES), tile - 1)
    qt = q.reshape(3, n_t, tile)[:, :, members]        # (3, T, threads, Q)
    s = np.zeros((3, n_t, threads), F32)
    for j in range(QUERIES):
        s = s + qt[..., j]
    s = s.reshape(3, n_t, wpt, 32)
    lane = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ d]
    c = (s[..., 0] * F32(1.0 / (32 * QUERIES))).astype(F32)          # (3, T, wpt)
    with np.errstate(over="ignore", invalid="ignore"):
        g = np.maximum(np.maximum(lo[:, :, None] - c[..., None], c[..., None] - hi[:, :, None]),
                       F32(0))                                        # (3, T, wpt, nch)
        gap2 = ((F32(0) + g[0] * g[0]) + g[1] * g[1]) + g[2] * g[2]
    key = (gap2.astype(F32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        np.arange(nch, dtype=np.uint64)
    return np.argsort(key, -1).reshape(n_t * wpt, nch)


def emulate_sweep(src, tgt, ws, tile, w_tiles):
    """The records body's sweep: (m, the column where m was last lowered,
    the number of columns at m, the columns its thread examined and the
    columns its warp swept: those of every chunk that any of its
    threads examined) per source point, and the window data."""
    ns = src.shape[1]
    wc = w_tiles * tile
    xyz, near, extra = _window(tgt, ws, tile, w_tiles)
    q = src[0:3]
    d2 = _d2(xyz, q)
    lo, hi = _boxes(xyz, near, CHUNK)
    lb = _box_bound(lo, hi, q, tile)
    nch = lb.shape[1]
    cull = np.repeat((np.abs(q).max(0) < NEAR).reshape(-1, tile).all(1), tile)
    # the thread of each point, its (clamped) points and its warp's order
    threads = -(-tile // QUERIES)
    members = np.minimum(np.arange(threads)[:, None] + threads * np.arange(QUERIES), tile - 1)
    base = np.arange(ns // tile)[:, None, None] * tile
    thread_pts = (base + members[None]).reshape(-1, QUERIES)        # (threads·T, Q)
    tid = (np.arange(ns) % tile) % threads
    thread_of = (np.arange(ns) // tile) * threads + tid
    orders = _warp_orders(q, lo, hi, tile, threads, w_tiles)
    warp_of = (np.arange(ns) // tile) * -(-threads // 32) + tid // 32
    inf = F32(np.inf)
    m = np.full(ns, inf, F32)
    first = np.zeros(ns, np.int64)
    ties = np.zeros(ns, np.int64)
    examined = np.zeros(ns, np.int64)
    swept = np.zeros(ns, np.int64)
    rows = np.arange(ns)
    for step in range(nch):
        ch = orders[warp_of, step]                                  # (Ns,)
        beyond = lb[rows, ch] > np.maximum(m, F32(1e-30))
        active = ~(cull & beyond[thread_pts].all(1)[thread_of])
        warp_runs = np.zeros(warp_of.max() + 1, bool)
        warp_runs[warp_of[active]] = True
        swept += warp_runs[warp_of] * np.minimum(CHUNK, wc - ch * CHUNK)
        for off in range(CHUNK):
            c = ch * CHUNK + off
            ok = active & (c < wc)
            s = d2[rows, np.minimum(c, wc - 1)]
            lt = ok & (s < m)
            eq = ok & (s == m) & ~lt
            ties = np.where(lt, 1, ties + eq)
            first = np.where(lt, c, first)
            m = np.where(lt, s, m)
            examined += ok
    return m, first, ties, (examined, swept), (xyz, extra, d2, lb)


def emulate_rows(src, tgt, ws, tile, w_tiles):
    """The kernel's output rows (4 + E, Ns) from the emulated sweep."""
    m, first, ties, _, (xyz, extra, d2, _) = emulate_sweep(src, tgt, ws, tile, w_tiles)
    ns = src.shape[1]
    rows = np.concatenate([xyz, extra])                    # (3 + E, T, wc)
    tl = np.arange(ns) // tile
    found = m < np.inf
    out = np.zeros((rows.shape[0] + 1, ns), np.float32)
    out[3] = ((src[3] > 0.5) & found).astype(np.float32)
    pay = rows[:, tl, first]                               # (3 + E, Ns)
    for qi in np.nonzero(found & (ties > 1))[0]:
        acc = np.zeros(rows.shape[0], np.float32)
        for c in range(d2.shape[1]):                    # from column 0
            if d2[qi, c] == m[qi]:
                acc = acc + rows[:, tl[qi], c]              # float32, column order
        pay[:, qi] = acc / np.float32(ties[qi])
    pay[:, ~found] = 0
    out[0:3], out[4:] = pay[0:3], pay[3:]
    return out, ties


def _column_order(src, tgt, ws, tile, w_tiles):
    """The rows body's selection: a full sweep in column order."""
    xyz, _, _ = _window(tgt, ws, tile, w_tiles)
    d2 = _d2(xyz, src[0:3])
    m = d2.min(1)
    return m, np.argmin(d2, 1), (d2 == m[:, None]).sum(1)


CASES = [(tile, w, e, scale) for w in (3, 4, 16) for e in (0, 3, 6)
         for scale, tile in ((1e-2, 128), (1.0, 8), (1e2, 100))]


@pytest.mark.parametrize("tile,w_tiles,n_extra,scale", CASES)
def test_culled_sweep_matches_plain(tile, w_tiles, n_extra, scale):
    src, tgt, ws = icp_case(tile, w_tiles, n_extra, scale)
    m, first, ties, (examined, swept), _ = emulate_sweep(src, tgt, ws, tile, w_tiles)
    rm, rfirst, rties = _column_order(src, tgt, ws, tile, w_tiles)
    found = rm < np.inf
    np.testing.assert_array_equal(m, rm)
    single = found & (ties == 1)
    np.testing.assert_array_equal(first[single], rfirst[single])
    np.testing.assert_array_equal(ties[found], rties[found])
    got, _ = emulate_rows(src, tgt, ws, tile, w_tiles)
    ref = icp_match_plain(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(ws),
                          tile, w_tiles).numpy()
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[:, single], ref[:, single])
    np.testing.assert_allclose(got, ref, atol=1e-6 * max(scale, 1.0), rtol=0)
    # the inputs reach what they are meant to: ties, windows without a
    # match (in the sentinel tail), invalid sources, and culled chunks
    assert (ties[found] > 1).any() and (~found[tile:2 * tile]).all()
    assert (ref[3] == 0).any() and (ref[3] == 1).mean() > 0.5
    assert examined.mean() < w_tiles * tile and (swept >= examined).all()


@pytest.mark.parametrize("w_tiles,n_extra", [(3, 0), (4, 3)])
def test_culled_sweep_matches_pallas(w_tiles, n_extra):
    src, tgt, ws = icp_case(128, w_tiles, n_extra, 1.0, seed=3, special=False)
    got, ties = emulate_rows(src, tgt, ws, 128, w_tiles)
    ref = np.asarray(pallas_icp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ws),
                                tile=128, w_tiles=w_tiles, interpret=True))
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert (ties > 1).any()


def test_far_queries_turn_culling_off():
    """A block with a point at or above kNearQuery culls nothing, and a
    target at the sentinel magnitude can then still be its nearest."""
    src, tgt, ws = icp_case(128, 3, 0, 1.0, special=False)
    src[0:3, 5] = NEAR * 30                     # near the sentinels, in tile 0
    _, _, _, (examined, _), _ = emulate_sweep(src, tgt, ws, 128, 3)
    assert (examined[:128] == 3 * 128).all() and (examined[128:] < 3 * 128).any()
    got, _ = emulate_rows(src, tgt, ws, 128, 3)
    ref = icp_match_plain(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(ws),
                          128, 3).numpy()
    np.testing.assert_array_equal(got[3], ref[3])


@pytest.mark.parametrize("w_tiles", [3, 16])
@pytest.mark.parametrize("scale", [1e-2, 1.0, 1e2])
def test_bound_counts_open_columns(w_tiles, scale):
    """``chip_smoke.open_columns``, which sets the kernel's operation
    bound, counts for each source point the columns of the chunks whose
    box bound does not exceed its final minimum, and one box test per
    chunk."""
    import chip_smoke
    src, tgt, ws = icp_case(128, w_tiles, 0, scale)
    m, _, _, _, (_, _, _, lb) = emulate_sweep(src, tgt, ws, 128, w_tiles)
    kept = lb <= np.maximum(m, F32(1e-30))[:, None]
    t = torch.from_numpy
    cols, tests = chip_smoke.icp_open_columns(t(src), t(tgt), t(ws), 128, w_tiles, t(m))
    assert cols == kept.sum() * CHUNK
    assert tests == src.shape[1] * lb.shape[1]
