"""The two selection bodies of the window kNN kernel, on the CPU.

``knn_window_tiles`` (``csrc/knn_window.cu``) stages each 3-tile window
as (x, y, z, tag) records with the bounding boxes of their
``kChunk``-column chunks, and selects in one of two ways:

* list body (k <= 16): kernel 4's exact selection, one query a thread.
  The k-th d² of the ±min(2k, tile) sorted neighbours seeds a
  right-aligned list of 12 or 16 entries (k copies of the float above
  it); one sweep in column order takes each candidate that strictly
  beats the list's k-th, after the entries equal to it, and passes over
  a chunk whose fp32 box bound (shrunk by ``kCullMargin``) already
  reaches the k-th (the strict test). The insertions are deferred: a
  thread queues the columns (``kListQueue`` at most) and its warp
  (min(32, tile) consecutive queries) inserts them in rounds at each
  chunk where a queue could overflow and at the end, each tested again
  against the k-th. Under ``exclude_self`` the columns with the query's
  id enter neither step.
* warp body (16 < k <= 128): one query a warp, candidates as 64-bit
  keys (d² bits, column). The whole warps of columns nearest
  ``kSeedPerK``·k around the query (one more under ``exclude_self``)
  come first, then the rest in column order, 32 at a
  time; a key below the threshold (the k-th key of the merged list,
  none before k are merged) joins the warp's buffer in lane order, and
  each 32 buffered keys are merged into the sorted list of the KB
  smallest (KB = k rounded up to 32, 64 or 128). A pair of chunks whose box bound exceeds the threshold's d²
  (the test that is not strict) is passed over.

Emulated here in numpy with the constants read from the sources, each
body must give ``knn_window_plain``'s −d², ids and coordinates bit for
bit in every slot (slots past the finite candidates: −inf with column 0
of the clamped window), the deferred insertions must end as direct ones,
the list body must cull no column it needs, and the warp's buffer must
never hold 64 keys; a few cases go on to the Pallas kernel in interpret
mode, which ``tests/test_torch_window_knn.py`` also holds the plain
version against.

Inputs (``union_clouds.union_cloud``): duplicate points (ties), ~10%
invalid columns, and a last tile whose window holds k − 1 valid points
(fewer than k); ids a random permutation with the invalid columns' and
a padded tail's ids repeated (0), as the padded callers give them;
every case covers tile 0 and the last tile; k in {1, 9, 10, 12, 13, 16,
17, 33, 64, 128} with and without ``exclude_self`` at tiles 8 and 128
and scales 1e-2, 1 and 1e2, and at tile 1024.
``chip_smoke.knn_open_columns``, which counts the candidates of the
kernel's operation bound, must count exactly the columns of the chunks
whose box bound does not exceed each query's final k-th d².
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.kernels.knn_pallas import knn_window_tiles as pallas_knn  # noqa: E402
from threecrate_tpu_torch.kernels.knn_window import knn_window_plain  # noqa: E402
from union_clouds import union_cloud  # noqa: E402

_CSRC = Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
_SRC = (_CSRC / "knn_window.cu").read_text()
_HDR = (_CSRC / "window.cuh").read_text()
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", _HDR).group(1))
WARP = int(re.search(r"constexpr int kWarp = (\d+);", _SRC).group(1))
SEED_PER_K = int(re.search(r"constexpr int kSeedPerK = (\d+);", _SRC).group(1))
QUEUE = int(re.search(r"constexpr int kListQueue = (\d+);", _SRC).group(1))
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SRC).group(1))
MARGIN = np.float32(1) - np.float32(1) / np.float32(
    re.search(r"kCullMargin = 1\.f - 1\.f / (\d+)\.f;", _HDR).group(1))
# the bodies and list sizes of tc_knn_window's dispatch, in order
DISPATCH = [(int(kk), body, int(size)) for kk, body, size in re.findall(
    r"if \(k <= (\d+)\) return launch_(list|warp)<(\d+)>", _SRC)]
F32, EMPTY = np.float32, np.uint64(2 ** 64 - 1)


def body_of(k):
    """(body, list size) that tc_knn_window runs for k."""
    return next((body, size) for kk, body, size in DISPATCH if k <= kk)


def knn_case(tile, k, scale, seed=0):
    """(3, N) sorted points, (N,) validity and (N,) int32 ids (numpy)."""
    n = max(4 * tile, 512)
    pts, valid = union_cloud(n, tile, k, scale, seed=seed + k)
    rng = np.random.default_rng(seed + 100 + k)
    ids = rng.permutation(n).astype(np.int32)
    ids[valid.numpy() < 0.5] = 0
    ids[-tile // 2:] = 0                      # a padded tail: one id repeated
    return pts.numpy(), valid.numpy(), ids


def _window(pts, valid, ids, tile):
    """Per query tile: records (3, T, 3·tile), their validity (T, 3·tile)
    (prev of tile 0, next of the last tile invalid), ids of the clamped
    window and the coordinates/id of its column 0."""
    n = pts.shape[1]
    n_t = n // tile
    j = np.arange(3 * tile)
    ct = np.clip(np.arange(n_t)[:, None] - 1 + j // tile, 0, n_t - 1)
    cols = ct * tile + j % tile
    inside = (np.arange(n_t)[:, None] - 1 + j // tile >= 0) & \
        (np.arange(n_t)[:, None] - 1 + j // tile < n_t)
    ok = inside & (valid[cols] > 0.5)
    return pts[:, cols], ok, ids[cols], cols


def _d2(win, q):
    """(T, tile, 3·tile) d² in tc::sq_dist's order."""
    d = [win[r][:, None, :] - q[r][:, :, None] for r in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def _box_bound(win, ok, q, chunk):
    """(T, tile, n_chunks) fp32 box bound of tc::chunk_beyond."""
    t, w3 = ok.shape
    nch = -(-w3 // chunk)
    pad = nch * chunk - w3
    inf = F32(np.inf)
    w = np.pad(np.where(ok[None], win, np.nan), ((0, 0), (0, 0), (0, pad)),
               constant_values=np.nan).reshape(3, t, nch, chunk)
    lo = np.where(np.isnan(w), inf, w).min(3)[:, :, None]
    hi = np.where(np.isnan(w), -inf, w).max(3)[:, :, None]
    qq = q[:, :, :, None]
    with np.errstate(over="ignore", invalid="ignore"):
        gap = np.maximum(np.maximum(lo - qq, qq - hi), F32(0))
        return ((gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]) * MARGIN


def _inputs(pts, valid, ids, tile, exclude_self):
    """d² (N, 3·tile) with +inf where a column may not be selected, box
    bounds (N, n_chunks) and the window's ids, coordinates and column 0."""
    n = pts.shape[1]
    n_t = n // tile
    win, ok, wid, cols = _window(pts, valid, ids, tile)
    q = pts.reshape(3, n_t, tile)
    with np.errstate(over="ignore"):
        d2 = _d2(win, q)
    sel = ok[:, None, :] & np.isfinite(d2)
    if exclude_self:
        sel &= wid[:, None, :] != ids.reshape(n_t, tile)[:, :, None]
    d2 = np.where(sel, d2, F32(np.inf)).reshape(n, 3 * tile)
    lb = _box_bound(win, ok, q, CHUNK).reshape(n, -1)
    return d2, lb, win, wid, cols


def _insert(best, col, who, v, c):
    """insert_ranked of v (column c) into the lists of the queries who."""
    b, cl, vv = best[who], col[who], v[:, None]
    keep = b <= vv
    put = np.concatenate([np.ones_like(keep[:, :1]), keep[:, :-1]], 1)
    prev_b = np.concatenate([b[:, :1], b[:, :-1]], 1)
    prev_c = np.concatenate([cl[:, :1], cl[:, :-1]], 1)
    best[who] = np.where(keep, b, np.where(put, vv, prev_b))
    col[who] = np.where(keep, cl, np.where(put, c[:, None], prev_c))


def emulate_list(d2, lb, tile, k, kmax, queue=QUEUE):
    """The list body's columns (N, k) (−1 where not found) after the
    seeded sweep with the strict box test and, with a queue, deferred
    insertions drained by warps (a warp: min(32, tile) consecutive
    queries); and the insertion steps each query's warp runs: drain
    rounds with a queue, else one for each column that any of its
    queries inserts."""
    n, w3 = d2.shape
    inf = F32(np.inf)
    i = np.arange(n) % tile
    band = min(2 * k, tile)
    seed_d2 = np.take_along_axis(d2, tile + i[:, None] + np.arange(-band, band + 1), 1)
    r2 = np.sort(seed_d2, 1)[:, k - 1]
    best = np.full((n, kmax), -inf, F32)
    best[:, kmax - k:] = np.nextafter(r2, inf)[:, None]
    col = np.zeros((n, kmax), np.int64)
    rows = np.arange(n)
    warp = rows // min(WARP, tile, THREADS)
    qcols = np.zeros((n, max(queue, 1)), np.int64)
    qn = np.zeros(n, np.int64)
    rounds = np.zeros(n, np.int64)

    def drain(who):
        most = np.zeros(warp.max() + 1, np.int64)
        np.maximum.at(most, warp[who], qn[who])
        rounds[who] += most[warp[who]]
        for r in range(qn[who].max() if len(who) else 0):
            w = who[qn[who] > r]
            c = qcols[w, r]
            v = d2[w, c]
            enter = v < best[w, -1]
            _insert(best, col, w[enter], v[enter], c[enter])
        qn[who] = 0

    for c0 in range(0, w3, CHUNK):
        if queue:
            full = np.zeros(warp.max() + 1, bool)
            np.logical_or.at(full, warp, qn > queue - CHUNK)
            drain(np.nonzero(full[warp])[0])
        live = ~(lb[:, c0 // CHUNK] >= np.maximum(best[:, -1], F32(1e-30)))
        for c in range(c0, min(c0 + CHUNK, w3)):
            v = d2[:, c]
            enter = live & (v < best[:, -1])
            if not enter.any():
                continue
            if queue:
                w = rows[enter]
                qcols[w, qn[w]] = c
                qn[w] += 1
                assert qn.max() <= queue
            else:
                hit = np.zeros(warp.max() + 1, bool)
                hit[warp[enter]] = True
                rounds += hit[warp]
                _insert(best, col, rows[enter], v[enter], np.full(enter.sum(), c))
    if queue:
        drain(rows)
    last = best[:, kmax - k:]
    return np.where(last < inf, col[:, kmax - k:], -1), rounds


def _keys(d2, cols):
    """64-bit keys (d² bits, column), EMPTY where d² is +inf."""
    bits = d2.view(np.uint32).astype(np.uint64)
    return np.where(np.isfinite(d2), (bits << np.uint64(32)) | cols.astype(np.uint64), EMPTY)


def emulate_warp(d2, lb, tile, k, kb, exclude_self):
    """The warp body's columns (N, k) (−1 where not found), the most keys
    its buffer held and the merges per query."""
    n, w3 = d2.shape
    nb = min(max((SEED_PER_K * k + WARP // 2) // WARP, 1) * WARP + exclude_self, w3)
    qc = tile + np.arange(n) % tile
    lo = np.minimum(np.maximum(qc - nb // 2, 0), w3 - nb)
    best = np.full((n, kb), EMPTY, np.uint64)
    buf = np.full((n, 2 * WARP), EMPTY, np.uint64)
    cnt = np.zeros(n, np.int64)
    thr = np.full(n, EMPTY, np.uint64)
    merges = np.zeros(n, np.int64)
    peak = [0]
    lanes = np.arange(WARP)

    def merge(who, take):
        """Merge the first `take` (<= 32) buffered keys of the queries `who`."""
        part = np.where(lanes[None] < take[:, None], buf[who, :WARP], EMPTY)
        best[who] = np.sort(np.concatenate([best[who], part], 1), 1)[:, :kb]
        left = cnt[who] - take
        assert (left < WARP).all()
        rest = np.take_along_axis(buf[who], np.minimum(take[:, None] + lanes, 2 * WARP - 1), 1)
        buf[who] = EMPTY
        buf[who, :WARP] = np.where(lanes < left[:, None], rest, EMPTY)
        cnt[who] = left
        thr[who] = best[who, k - 1]
        merges[who] += 1

    def offer(c, take):
        """Lane l of each query's warp offers column c[:, l] where take:
        keys below the threshold join the buffer in lane order; a buffer
        that holds kb keys is merged."""
        cc = np.clip(c, 0, w3 - 1)
        key = np.where(take, _keys(np.take_along_axis(d2, cc, 1), cc), EMPTY)
        inn = key < thr[:, None]
        pos = cnt[:, None] + np.cumsum(inn, 1) - inn
        qi, li = np.nonzero(inn)
        buf[qi, pos[qi, li]] = key[qi, li]
        cnt[:] += inn.sum(1)
        peak[0] = max(peak[0], cnt.max())
        assert cnt.max() < 2 * WARP
        full = np.nonzero(cnt >= WARP)[0]
        if len(full):
            merge(full, np.full(len(full), WARP))

    def flush():
        who = np.nonzero(cnt > 0)[0]
        if len(who):
            merge(who, cnt[who].copy())

    for g in range(0, nb, WARP):
        offer(lo[:, None] + g + lanes, np.broadcast_to(g + lanes < nb, (n, WARP)))
    flush()
    for c0 in range(0, w3, WARP):
        thr_d2 = np.where(thr == EMPTY, EMPTY, thr >> np.uint64(32)).astype(np.uint32)
        thr_d2 = np.where(thr == EMPTY, F32(np.inf), thr_d2.view(F32))
        ch = c0 // CHUNK
        open_ = np.zeros(n, bool)
        for cc in (ch, ch + 1):
            if cc < lb.shape[1]:
                open_ |= ~(lb[:, cc] > np.maximum(thr_d2, F32(1e-30)))
        c = c0 + lanes
        take = open_[:, None] & (c < w3) & ((c < lo[:, None]) | (c >= lo[:, None] + nb))
        offer(np.broadcast_to(c, (n, WARP)), take)
    flush()
    top = best[:, :k]
    chosen = np.where(top == EMPTY, -1, (top & np.uint64(0xffffffff)).astype(np.int64))
    return chosen, peak[0], merges


def slots_of(chosen, d2, win, wid, cols, tile, with_coords=True):
    """The kernel's outputs from each query's chosen window columns."""
    n = d2.shape[0]
    t = np.arange(n) // tile
    found = chosen >= 0
    c = np.where(found, chosen, 0)
    neg = np.where(found, -np.take_along_axis(d2, c, 1), F32(-np.inf)).T
    idx = wid[t[:, None], c].T
    crd = np.stack([win[r][t[:, None], c] for r in range(3)], -1).reshape(n, -1).T
    return neg, idx, crd


def _check(pts, valid, ids, tile, k, exclude_self):
    d2, lb, win, wid, cols = _inputs(pts, valid, ids, tile, exclude_self)
    body, size = body_of(k)
    if body == "list":
        chosen, _ = emulate_list(d2, lb, tile, k, size)
        # the deferred insertions end as the direct sweep's
        np.testing.assert_array_equal(chosen, emulate_list(d2, lb, tile, k, size, queue=0)[0])
        peak = merges = None
    else:
        chosen, peak, merges = emulate_warp(d2, lb, tile, k, size, exclude_self)
    got = slots_of(chosen, d2, win, wid, cols, tile)
    ref = knn_window_plain(torch.from_numpy(pts), torch.from_numpy(valid)[None],
                           torch.from_numpy(ids)[None], k, tile, with_coords=True,
                           exclude_self=exclude_self)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    return got, body, peak, merges


CASES = ([(tile, k, scale, excl) for tile in (8, 128) for k in (1, 9, 10, 12, 13, 16, 17,
                                                                 33, 64, 128)
          for scale in (1e-2, 1.0, 1e2) for excl in (False, True) if k <= 3 * tile]
         + [(1024, k, 1.0, excl) for k in (10, 17, 64, 128) for excl in (False, True)])


@pytest.mark.parametrize("tile,k,scale,exclude_self", CASES)
def test_selection_matches_plain(tile, k, scale, exclude_self):
    pts, valid, ids = knn_case(tile, k, scale)
    got, body, peak, merges = _check(pts, valid, ids, tile, k, exclude_self)
    n = pts.shape[1]
    # fewer than k finite candidates in the last tile, k of them elsewhere
    assert np.isinf(got[0][:, n - tile:]).any() and np.isfinite(got[0]).all(0).any()
    if body == "warp":
        assert peak < 2 * WARP and merges.max() >= 1




@pytest.mark.parametrize("k,exclude_self", [(10, False), (17, True), (64, True)])
def test_selection_matches_pallas(k, exclude_self):
    """The Pallas kernel forms d² in its own order: its −d² agree within
    1e-6 relative, the finite slots are the same, and ids and coordinates
    agree in every slot whose −d² stands apart from its neighbours'
    (as tests/test_torch_window_knn.py holds the plain version)."""
    tile = 128
    pts, valid, ids = knn_case(tile, k, 1.0, seed=5)
    d2, lb, win, wid, cols = _inputs(pts, valid, ids, tile, exclude_self)
    body, size = body_of(k)
    chosen = (emulate_list(d2, lb, tile, k, size)[0] if body == "list"
              else emulate_warp(d2, lb, tile, k, size, exclude_self)[0])
    got = slots_of(chosen, d2, win, wid, cols, tile)
    ref = [np.asarray(r) for r in pallas_knn(
        jnp.asarray(pts), jnp.asarray(valid[None]), jnp.asarray(ids[None]), k, tile=tile,
        interpret=True, with_coords=True, exclude_self=exclude_self)]
    fin = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), fin)
    np.testing.assert_allclose(got[0][fin], ref[0][fin], rtol=1e-6, atol=1e-12)
    neg = ref[0].T
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(neg, axis=-1)) > 1e-6 * np.maximum(
            np.abs(neg[..., 1:]), np.abs(neg[..., :-1])) + 1e-12
    apart = np.isfinite(neg)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    apart = apart.T
    np.testing.assert_array_equal(got[1][apart], ref[1][apart])
    np.testing.assert_array_equal(got[2][np.repeat(apart, 3, 0)], ref[2][np.repeat(apart, 3, 0)])
    assert apart.mean() > 0.5


def test_list_body_culls_no_needed_column():
    """The strict box test passes over no chunk holding a column of the
    final k (a column at the k-th d² and a lower index would have entered
    first: the sweep runs in column order)."""
    tile, k = 128, 10
    pts, valid, ids = knn_case(tile, k, 1.0)
    d2, lb, *_ = _inputs(pts, valid, ids, tile, False)
    chosen, _ = emulate_list(d2, lb, tile, k, body_of(k)[1])
    kth = np.take_along_axis(d2, np.maximum(chosen[:, -1:], 0), 1)[:, 0]
    ch = np.where(chosen >= 0, chosen // CHUNK, 0)
    assert (np.take_along_axis(lb, ch, 1) <= np.maximum(kth, F32(1e-30))[:, None]).all()


@pytest.mark.parametrize("k,exclude_self", [(10, False), (64, True), (128, False)])
def test_bound_counts_open_columns(k, exclude_self):
    """``chip_smoke.knn_open_columns``, which sets the kernel's operation
    bound, counts for each query the columns of the chunks whose box
    bound does not exceed its final k-th d² (every chunk where fewer
    than k candidates are finite), and one box test per chunk."""
    import chip_smoke
    tile = 128
    pts, valid, ids = knn_case(tile, k, 1.0)
    d2, lb, *_ = _inputs(pts, valid, ids, tile, exclude_self)
    kth = np.sort(d2, 1)[:, k - 1]
    kept = lb <= np.maximum(kth, F32(1e-30))[:, None]
    neg = knn_window_plain(torch.from_numpy(pts), torch.from_numpy(valid)[None],
                           torch.from_numpy(ids)[None], k, tile, exclude_self=exclude_self)[0]
    cols, tests = chip_smoke.knn_open_columns(torch.from_numpy(pts),
                                              torch.from_numpy(valid)[None], neg, tile)
    assert cols == kept.sum() * CHUNK
    assert tests == d2.shape[0] * lb.shape[1]
