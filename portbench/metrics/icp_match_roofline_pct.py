"""Kernel 3 (``icp_match``: each moved source point's nearest target in
its window) against its roofline: the least time of each launch's work
(``roofline.icp_match_work``, bound by its bytes) over the device time of
the ``icp_match`` kernels in the traced window."""

from portbench import roofline

TILE = 128


def read(ctx):
    spent = sum(e - s for name, s, e in ctx.events if "icp_match" in name)
    launches = ctx.launches.get("icp_match", 0)
    if not spent or not launches:
        return None
    ns = sum(ctx.shapes["icp_source"]) / len(ctx.shapes["icp_source"])
    nt = sum(ctx.shapes["icp_target"]) / len(ctx.shapes["icp_target"])
    ns, nt = (-(-int(x) // TILE) * TILE for x in (ns, nt))
    return 100.0 * roofline.bound(*roofline.icp_match_work(ns, nt, TILE))[0] * launches / spent
