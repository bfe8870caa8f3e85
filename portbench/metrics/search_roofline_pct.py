"""The descriptor search stage (``global_registration_with_features``:
matching with its mutual pass, then RANSAC scoring) against its roofline:
the least time of its work (``roofline.search_work``: 2·Q·N·D operations a
matching pass, the hypotheses the traced calls scored) over the stage's
time, CUDA events around each call of the stage in the traced window."""

from portbench import roofline


def read(ctx):
    spans = ctx.spans.get("search", [])
    if not spans:
        return None
    s = ctx.shapes
    q = sum(s["search_queries"]) / len(s["search_queries"])
    n = sum(s["search_targets"]) / len(s["search_targets"])
    hyp = ctx.counters["ransac_batches"] * s["hypothesis_batch"] / len(spans)
    nbytes, ops = roofline.search_work(q, n, s["descriptor_dim"], s["search_passes"], hyp,
                                       s["correspondences"])
    return 100.0 * roofline.bound(nbytes, ops)[0] * len(spans) / (sum(spans) / 1e3)
