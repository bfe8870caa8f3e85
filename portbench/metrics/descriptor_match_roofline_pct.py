"""Descriptor matching (``match_descriptors`` with its mutual pass)
against its roofline: the least time of its work (``roofline.search_work``
with no hypotheses and no correspondences: 2·Q·N·D operations a matching
pass) over the device's busy time of the work launched inside the
program's ``match`` spans in the stage pass (``portbench/stages.py``).
RANSAC is left out, which ``search_roofline_pct`` cannot do."""

from portbench import roofline, stages


def read(ctx):
    st = stages.collect(ctx)
    spans = st["spans"].get("match", 0) if st else 0
    if not spans or not st["busy_ms"].get("match"):
        return None
    s = ctx.shapes
    q = sum(s["search_queries"]) / len(s["search_queries"])
    n = sum(s["search_targets"]) / len(s["search_targets"])
    nbytes, ops = roofline.search_work(q, n, s["descriptor_dim"], s["search_passes"], 0, 0)
    return 100.0 * roofline.bound(nbytes, ops)[0] * spans / (st["busy_ms"]["match"] / 1e3)
