"""Timing on the card with CUDA events, a device profile of one call
with ``torch.profiler``, the program's stage spans and counters, and
the JAX package's profiling helpers mapped onto torch: ``sync`` (a
synchronise and a checksum), ``trace`` (a ``torch.profiler`` trace of a
block written into a directory, as ``jax.profiler`` writes one, with
the stage spans in it), ``Timer`` (host sections),
``device_memory_stats``, ``measure_peak_memory`` and ``program_memory``
(the CUDA caching allocator's counters).

Stage spans and counters: ``span(name)`` brackets a stage of the
program (``spanned(name)`` a whole function), ``count(name, n)`` adds
to a counter, ``host_sync(site, on)`` brackets a copy that makes the
host wait for the device (counter and leaf span ``sync.<site>``), and
``recording()`` switches span recording on for a block and yields the
``Records``. Off, a span is one flag test and a shared no-op context;
counters always count. Stamps are ``time.time_ns()``, the Unix-epoch
clock on which ``torch.profiler`` puts its host and device events, so
spans and device intervals compare without conversion; while a profiler
is active each span also opens a ``record_function`` range of its name.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import statistics
import threading
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
    time; ``top=None`` all of them). Busy time is the union of the call's
    kernel, copy and memset intervals; 1 − busy / wall is the device's
    idle share. The device events are read from the profiler's raw
    results: building ``prof.events()`` costs ~50 µs an event on the host,
    seconds for a call of 10^5 launches."""
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
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start = e.start_ns() / 1e3
            events.append((e.name(), start, start + e.duration_ns() / 1e3))
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
    when the block ends, the stage spans recorded (``recording``) as
    ranges of their names; yields ``log_dir``, as the JAX package's
    ``trace`` does around ``jax.profiler``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=activities,
                              on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


class Span:
    """One recorded stage: its ``name``, ``id``, its ``parent``'s id (None
    for a root), the ``call`` id (its root's id: the spans of one call
    share it) and its ``start_ns`` / ``end_ns`` stamps (``time.time_ns``)."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns")

    def __init__(self, name: str, id: int, parent: Optional[int], call: int, start_ns: int):
        self.name, self.id, self.parent, self.call = name, id, parent, call
        self.start_ns, self.end_ns = start_ns, start_ns


class Records:
    """What ``recording()`` kept: ``spans`` in the order they ended,
    ``counters`` (what each counter counted inside the block) and
    ``calls`` (the root spans, one a call, in the order they began)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}

    @property
    def calls(self) -> List[Span]:
        return sorted((s for s in self.spans if s.parent is None), key=lambda s: s.start_ns)


counters: Dict[str, int] = collections.defaultdict(int)   # every count since import
_recording = False                                  # the flag a span tests
_active: List[Records] = []
_local = threading.local()                          # .stack: the open spans
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "span", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.fn = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.fn = torch.ops.profiler._record_function_enter_new(self.name, None)
        start = time.time_ns()
        sid = next(_ids)
        self.span = Span(self.name, sid, parent.id if parent else None,
                         parent.call if parent else sid, start)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        if self.fn is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(self.fn)
        sp = self.span
        sp.end_ns = time.time_ns()
        _local.stack.pop()
        for r in _active:
            r.spans.append(sp)
        return False


def span(name: str):
    """A context bracketing one stage of the program; recorded (name, ids,
    stamps) only inside ``recording()``, else a shared no-op."""
    if not _recording:
        return _OFF
    return _Open(name)


def spanned(name: str):
    """Decorate a function so that each call is a ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    counters[name] += n


def host_sync(site: str, on, n: int = 1):
    """The context of ``n`` copies that make the host wait for the device
    ``on`` (a tensor's or a device): a read onto the host, or a write from
    pageable host memory. Where ``on`` is off the CPU it counts ``n`` to
    ``sync.<site>`` and is a leaf span of that name; on the CPU nothing
    waits and nothing counts."""
    if on.is_cpu if isinstance(on, torch.Tensor) else torch.device(on).type == "cpu":
        return _OFF
    name = "sync." + site
    counters[name] += n
    return span(name)


@contextlib.contextmanager
def recording():
    """Record the spans opened in the block, on every thread, and what the
    counters count there: yields the ``Records``, filled as spans end
    (``counters`` when the block ends). Blocks may nest; each keeps all
    that ends inside it."""
    global _recording
    rec = Records()
    before = dict(counters)
    _active.append(rec)
    _recording = True
    try:
        yield rec
    finally:
        _active.remove(rec)
        _recording = bool(_active)
        rec.counters = {k: v - before.get(k, 0) for k, v in counters.items()
                        if v != before.get(k, 0)}


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
