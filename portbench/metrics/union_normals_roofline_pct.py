"""Kernels 1-2 (the union-window normal passes, ``union_kernel`` on the
device) against their roofline: the least time of each launch's work
(``roofline.union_work`` at tile 256, band max(16, k), k selected pairs a
query) over the device time of those kernels in the traced window."""

from portbench import roofline

TILE, BAND = 256, 16


def read(ctx):
    spent = sum(e - s for name, s, e in ctx.events if "union_kernel" in name)
    launches = ctx.launches.get("union_window_a", 0) + ctx.launches.get("union_window_b", 0)
    if not spent or not launches:
        return None
    k = ctx.shapes["k"]
    pts = ctx.shapes["union_points"]
    n = -(-int(sum(pts) / len(pts)) // TILE) * TILE
    work_a, work_b = roofline.union_work(n, TILE, max(BAND, k), k * n, k * n)
    least = sum(roofline.bound(*w)[0] for w in (work_a, work_b)) * launches / 2
    return 100.0 * least / spent
