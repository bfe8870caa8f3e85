"""An ICP iteration on the device: the busy time of the work launched
inside the program's ``icp`` spans less that inside ``icp.setup`` (the
sorts and packing), over the iterations counted (``icp.iterations``) in
the stage pass (``portbench/stages.py``)."""

from portbench import stages


def read(ctx):
    st = stages.collect(ctx)
    its = st["counters"].get("icp.iterations", 0) if st else 0
    if not its or "icp" not in st["busy_ms"]:
        return None
    busy = st["busy_ms"]
    return (busy["icp"] - busy.get("icp.setup", 0.0)) / its
