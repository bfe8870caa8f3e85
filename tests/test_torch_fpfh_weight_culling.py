"""The candidate sweep of the FPFH weighted-sum kernels, on the CPU.

``fpfh_weight_a_tiles`` and ``fpfh_weight_b_tiles`` (``csrc/fpfh.cu``)
stage each 3-tile window as (x, y, z, tag) records, pass B's tag being
the column's pass-A tile, and box every chunk of ``kWeightChunk``
columns (one tile where the tile is smaller) over its valid columns in
fp32. A query passes over a chunk whose box distance, shrunk by
``kCullMargin``, lies above r2, and weights every other column that is
valid, within r2, not a duplicate of it (d² > 1e-12) and, in pass B,
more than one pass-A tile from it. That is exact only if no column that
the plain version selects ever lies in a passed-over chunk. Emulated
here in numpy with the kernel's own chunk and margin read from its
sources, the sweep must select only what the plain version selects and
count exactly its count row.

The inputs (``union_clouds.weight_inputs``) are ``fused_stage1_inputs``'
packed rows of small clouds with duplicate points and 10% invalid
columns, at three radii (one that selects nothing, a typical one and one
that covers the whole window) and both passes, at scales 1e-2, 1 and 1e2
with tiles 64 and 256 and at scale 1 with tile 1024; every case covers
the first tile (no prev) and the last (no next).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu_torch.kernels import fpfh  # noqa: E402
from union_clouds import weight_inputs  # noqa: E402

_CSRC = Path(__file__).resolve().parent.parent / "threecrate_tpu_torch" / "csrc"
CHUNK = int(re.search(r"constexpr int kWeightChunk = (\d+);",
                      (_CSRC / "fpfh.cu").read_text()).group(1))
MARGIN = np.float32(1) - np.float32(1) / np.float32(
    re.search(r"kCullMargin = 1\.f - 1\.f / (\d+)\.f;",
              (_CSRC / "window.cuh").read_text()).group(1))
# radius / scale: nothing in radius (below the closest distinct pair), a
# typical neighbourhood, every window column
RADII = {"none": 1e-4, "typical": 0.4, "whole": 100.0}
# (tile, scale): three scales at tiles 64 and 256, tile 1024 at scale 1
GEOMETRY = [(tile, scale) for tile in (64, 256) for scale in (1e-2, 1.0, 1e2)] + [(1024, 1.0)]


def _sweep(p, pos, tile, r2):
    """The kernel's sweep: (selected (N, 3·tile), culled (N, 3·tile)) in
    numpy, from the (4+, N) rows p and the pass-A positions pos (or None)."""
    f32, inf = np.float32, np.float32(np.inf)
    n = p.shape[1]
    chunk = min(CHUNK, tile)
    shift = tile.bit_length() - 1
    sel = np.zeros((n, 3 * tile), bool)
    culled = np.zeros((n, 3 * tile), bool)
    for t in range(n // tile):
        cols = (t - 1) * tile + np.arange(3 * tile)
        inside = (cols >= 0) & (cols < n)
        c = np.where(inside, cols, 0)
        ok = inside & (p[3, c] > 0.5)
        w = np.where(ok[None], p[0:3, c], np.nan).reshape(3, -1, chunk)
        lo = np.where(np.isnan(w), inf, w).min(2)          # (3, chunks)
        hi = np.where(np.isnan(w), -inf, w).max(2)
        q = p[0:3, t * tile:(t + 1) * tile, None]
        with np.errstate(invalid="ignore", over="ignore"):
            gap = np.maximum(np.maximum(lo[:, None] - q, q - hi[:, None]), f32(0))
            lb = ((gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]) * MARGIN
        cut = np.repeat(lb > np.maximum(r2, f32(1e-30)), chunk, 1)   # (tile, 3·tile)
        d = p[0:3, c][:, None, :] - q
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        s = ok[None] & (d2 <= r2) & (d2 > f32(1e-12)) & ~cut
        if pos is not None:
            dt = (pos[c] >> shift)[None] - (pos[t * tile:(t + 1) * tile] >> shift)[:, None]
            s &= (dt < -1) | (dt > 1)
        sel[t * tile:(t + 1) * tile] = s
        culled[t * tile:(t + 1) * tile] = cut
    return sel, culled


@pytest.mark.parametrize("pass_b", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("radius", list(RADII))
@pytest.mark.parametrize("tile,scale", GEOMETRY)
def test_culled_sweep_matches_plain(tile, scale, radius, pass_b):
    packed, pos = weight_inputs(tile, scale, pass_b)
    r2 = fpfh._r2_f32((RADII[radius] * scale) ** 2)
    if pass_b:
        rows = fpfh.fpfh_weight_b_plain(packed, pos, r2, tile).numpy()
    else:
        rows = fpfh.fpfh_weight_a_plain(packed, r2, tile).numpy()
    n = packed.shape[1]
    # the plain version's own selection, (N, 3·tile)
    _, _, plain_sel = fpfh._chunk_geometry(packed, 0, n // tile, tile, r2, pos)
    plain_sel = plain_sel.reshape(n, 3 * tile).numpy()
    sel, culled = _sweep(packed.numpy(), None if pos is None else pos[0].numpy(), tile,
                         np.float32(r2))
    assert not (plain_sel & culled).any()
    np.testing.assert_array_equal(sel.sum(1).astype(np.float32), rows[33])
    valid = packed[3].numpy() > 0.5
    if radius == "none":
        assert rows[33].sum() == 0 and culled[valid].mean() > 0.5
    elif radius == "typical":
        assert 0 < rows[33][valid].mean() < tile and culled[valid].mean() > 0.2
    else:   # pass A takes the whole valid window, pass B what lies beyond ±1 A tile
        assert rows[33][valid].mean() > (0 if pass_b else tile)
