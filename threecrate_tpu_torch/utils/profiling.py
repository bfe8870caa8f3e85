"""Timing on the card with CUDA events, a device profile of one call
with ``torch.profiler``, and the JAX package's profiling helpers mapped
onto torch: ``sync`` (a synchronise and a checksum), ``trace`` (a
``torch.profiler`` trace of a block written into a directory, as
``jax.profiler`` writes one), ``Timer`` (host sections),
``device_memory_stats``, ``measure_peak_memory`` and ``program_memory``
(the CUDA caching allocator's counters)."""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


def median_time(fn: Callable, warmup: int = 2, iters: int = 5,
                sync_fn: Optional[Callable] = None) -> float:
    """Median seconds of ``fn()`` over ``iters`` runs after ``warmup``.

    Each run is bracketed by CUDA events on the current stream, so the
    time covers the device work ``fn`` enqueues and any host gaps in
    between. ``sync_fn`` (default :func:`sync`) is applied to each
    result, as the JAX package applies it, after the end event is
    recorded: the time is ``fn``'s, and ``sync_fn``'s own work lies
    outside it. There is no CPU fallback: a time is only ever measured
    on the card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("median_time measures on a CUDA device; none found")
    sync_fn = sync if sync_fn is None else sync_fn
    for _ in range(warmup):
        sync_fn(fn())
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        sync_fn(out)
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


def _tensors(out) -> List[torch.Tensor]:
    """The tensors of a nested result (tuples, lists, dicts, named tuples
    and dataclasses), in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    elif hasattr(out, "__dataclass_fields__"):
        out = [getattr(out, f) for f in out.__dataclass_fields__]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


def sync(out) -> float:
    """Wait for the card (``torch.cuda.synchronize()`` when ``out`` holds
    a CUDA tensor) and return a checksum of the first tensor of ``out``:
    the sum of its finite values as float32 (the count of True for a
    bool tensor), 0.0 when ``out`` holds no tensor."""
    leaves = _tensors(out)
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    if not leaves:
        return 0.0
    leaf = leaves[0]
    if leaf.dtype == torch.bool:
        return float(leaf.sum())
    x = leaf.to(torch.float32)
    return float(torch.where(torch.isfinite(x), x, 0.0).sum())


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/threecrate_trace"):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's where there is one), written into ``log_dir`` as a Chrome
    trace in TensorBoard's layout (``<host>_<pid>.<stamp>.pt.trace.json``)
    when the block ends; yields ``log_dir``, as the JAX package's
    ``trace`` does around ``jax.profiler``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


class Timer:
    """Accumulating section timer for host-side pipeline phases."""

    def __init__(self) -> None:
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"{k}: {v * 1e3:.2f} ms ({v / max(total, 1e-12):.0%})"
                 for k, v in sorted(self.sections.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)


def device_memory_stats(device=None) -> Dict[str, int]:
    """The CUDA caching allocator's counters (``torch.cuda.memory_stats``)
    with the JAX package's two keys added, ``bytes_in_use`` and
    ``peak_bytes_in_use`` (allocated bytes now and at peak); {} without a
    card."""
    if not torch.cuda.is_available():
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = torch.cuda.memory_allocated(device)
    stats["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(device)
    return stats


def measure_peak_memory(fn, device=None):
    """(result, peak allocated bytes above those allocated before the
    call) of one call of ``fn``: the peak counter is reset first. 0
    without a card."""
    if not torch.cuda.is_available():
        return fn(), 0
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    sync(out)
    return out, max(torch.cuda.max_memory_allocated(device) - before, 0)


def program_memory(fn, *args, **kwargs) -> Dict[str, int]:
    """The peak of one call: eager PyTorch has no compiled program whose
    buffers could be counted ahead, as XLA's memory analysis counts them
    in the JAX package, so this runs ``fn(*args, **kwargs)`` once and
    returns {"argument_bytes": bytes allocated before the call,
    "peak_bytes": the peak during it above them, "output_bytes": bytes
    still allocated after it above them}; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    sync(out)
    result = {"argument_bytes": before,
              "peak_bytes": max(torch.cuda.max_memory_allocated() - before, 0),
              "output_bytes": max(torch.cuda.memory_allocated() - before, 0)}
    del out
    return result
