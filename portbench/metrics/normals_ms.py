"""The normals stage a call: the device's busy time (the union of the
kernel, copy and memset intervals) of the work launched inside the
program's ``normals`` span, over the calls of the stage pass
(``portbench/stages.py``). It reads the same work whatever kernels do it."""

from portbench import stages


def read(ctx):
    st = stages.collect(ctx)
    if not st or not st["calls"] or "normals" not in st["busy_ms"]:
        return None
    return st["busy_ms"]["normals"] / st["calls"]
