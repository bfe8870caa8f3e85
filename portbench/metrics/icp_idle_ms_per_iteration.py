"""The device's idle time an ICP iteration: the gaps between device
intervals during which the host was inside the program's ``icp`` span
(its sync sites included), at each gap's midpoint, over the iterations
counted (``icp.iterations``) in the stage pass (``portbench/stages.py``)."""

from portbench import stages


def read(ctx):
    st = stages.collect(ctx)
    its = st["counters"].get("icp.iterations", 0) if st else 0
    if not its or "icp" not in st["busy_ms"]:
        return None
    return st["idle_ms"].get("icp", 0.0) / its
