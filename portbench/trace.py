"""What a traced run reads: device intervals, host syncs, idle gaps.

* ``device_events`` and ``union_s`` copy the arithmetic of
  ``threecrate_tpu_torch/utils/profiling.py:52-97`` (``_union_us`` and
  ``device_profile``): the device's kernel, copy and memset intervals
  read from the profiler's raw results, busy time their union.
* ``count_host_syncs`` copies ``chip_smoke.py:1275-1290``
  (``host_syncs``): the warnings ``torch.cuda.set_sync_debug_mode("warn")``
  raises, an exact count.
* ``idle_gaps`` names each long gap between device intervals by the
  innermost host operation running at its midpoint.
"""

from __future__ import annotations

import collections
import warnings
from typing import Callable, List, Tuple

import torch

Interval = Tuple[str, float, float]   # (name, start s, end s)


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _events(prof, device_type) -> List[Interval]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == device_type:
            start = e.start_ns() / 1e9
            out.append((e.name(), start, start + e.duration_ns() / 1e9))
    return out


def device_events(fn: Callable) -> Tuple[List[Interval], float]:
    """(device intervals, host-clock seconds) of ``fn()`` and a
    synchronise under ``torch.profiler`` with CUDA activity only."""
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _events(prof, torch.autograd.DeviceType.CUDA), wall


def by_name(events: List[Interval], top: int = 10):
    """[[name, summed seconds], ...] of the ``top`` names by time."""
    acc = collections.defaultdict(float)
    for name, s, e in events:
        acc[name] += e - s
    return [[n[:160], t] for n, t in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The (start, end) gaps in [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return [(s, e) for s, e in out if e > s]


def idle_gaps(fn: Callable, top: int = 10):
    """[[host operation, seconds], ...]: the ``top`` longest gaps between
    device intervals in one call of ``fn`` traced with host activity,
    each named by the shortest host event covering its midpoint."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = _events(prof, torch.autograd.DeviceType.CUDA)
    host = [e for e in _events(prof, torch.autograd.DeviceType.CPU)
            if not e[0].startswith("Activity Buffer")]
    if not dev or not host:
        return []
    lo, hi = min(s for _, s, _ in host), max(e for _, _, e in host)
    out = []
    for s, e in sorted(gaps([(a, b) for _, a, b in dev], lo, hi), key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        cover = [(b - a, n) for n, a, b in host if a <= mid <= b]
        out.append([min(cover)[1][:160] if cover else "host", e - s])
    return out


def count_host_syncs(fn: Callable) -> int:
    """Host syncs in one call of ``fn``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)
