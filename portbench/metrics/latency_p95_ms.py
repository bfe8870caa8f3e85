"""The 95th percentile (nearest rank) over every call of the window of
its time from start to pose on the host, read from CUDA events recorded
at both ends: a closed loop leaves the stream idle at each call's start,
so the events time the call as its caller sees it."""

import math


def read(ctx):
    lat = sorted(ctx.latencies_ms)
    return lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
