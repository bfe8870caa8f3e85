"""Timing on the card with CUDA events, and a device profile of one
call with ``torch.profiler``."""

from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, List, Tuple

import torch


def median_time(fn: Callable, warmup: int = 2, iters: int = 5) -> float:
    """Median seconds of ``fn()`` over ``iters`` runs after ``warmup``.

    Each run is bracketed by CUDA events on the current stream, so the
    time covers the device work ``fn`` enqueues and any host gaps in
    between. There is no CPU fallback: a time is only ever measured on
    the card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("median_time measures on a CUDA device; none found")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def _union_us(intervals) -> float:
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


def device_profile(fn: Callable, top: int = 10, warmup: int = 1) -> Tuple[float, float, List]:
    """One call of ``fn`` under ``torch.profiler`` (CUDA activity only:
    host events are not read, and tracing them made a call of thousands
    of launches several times slower to profile) after ``warmup`` calls: (wall
    ms on the host clock around the call and a synchronise, device busy
    ms, ``top`` device entries as (name, summed ms, count) by summed
    time). Busy time is the union of the call's kernel, copy and memset
    intervals; 1 − busy / wall is the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == cuda]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        by_name[name][0] += (e - s) / 1e3
        by_name[name][1] += 1
    entries = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda t: -t[1])
    return wall_ms, _union_us([(s, e) for _, s, e in events]) / 1e3, entries[:top]
