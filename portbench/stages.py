"""The program's stages on the device: a pass after the traced window that
reads the stage spans and counters of ``threecrate_tpu_torch`` (its
``utils.profiling.recording``) against a device profile.

``collect(ctx)`` makes the pass once a run, when the first stage metric
asks for it: the cell's pool made again from the run's ``--seed`` (the
same inputs as the window's), its entry built, one call to regrow the
allocator, then one call of each pool item with recording on under
``torch.profiler`` with CUDA activity only (as ``trace.device_events``).
``attribute`` puts each device interval down to the innermost span in
which its launch happened (the profiler links a kernel, copy or memset to
its ``cudaLaunchKernel``/``cudaMemcpyAsync`` runtime event by correlation
id, and that event's host stamp falls inside a span) and charges each gap
between device intervals inside a call to the innermost span the host was
in at the gap's midpoint. Span stamps and profiler events share a clock
(``time.time_ns``, Unix-epoch nanoseconds), so nothing is converted.

A program without the recorder (one older than the stage spans) yields
None, and every stage metric with it. Standard error gets the sync sites
(``syncs <site>: <per call>``), each stage's busy and idle time a call and
the longest gaps named ``<innermost span> | <host call>``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import trace

# (id, parent id or None, call id, name, start ns, end ns)
SpanRow = Tuple[int, Optional[int], int, str, int, int]
# (name, start ns, end ns, correlation id)
Event = Tuple[str, int, int, int]


def _seed() -> int:
    """The run's ``--seed`` (0 where the process was given none)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


class _Spans:
    """Innermost-span lookup by host time, a call at a time."""

    def __init__(self, spans: Sequence[SpanRow]):
        self.by_id = {s[0]: s for s in spans}
        roots = sorted((s for s in spans if s[1] is None), key=lambda s: s[4])
        self.roots = roots
        self.starts = [r[4] for r in roots]
        members = collections.defaultdict(list)
        for s in spans:
            members[s[2]].append(s)
        self.members = members
        depth: Dict[int, int] = {}
        for s in spans:
            d, p = 0, s[1]
            while p is not None and p in self.by_id:
                d, p = d + 1, self.by_id[p][1]
            depth[s[0]] = d
        self.depth = depth

    def innermost(self, t: int) -> Optional[int]:
        """The id of the deepest span open at host time ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t > self.roots[i][5]:
            return None
        best = None
        for s in self.members[self.roots[i][0]]:
            if s[4] <= t <= s[5] and (best is None or self.depth[s[0]] > self.depth[best]):
                best = s[0]
        return best

    def chain(self, sid: Optional[int]) -> List[str]:
        """The names of span ``sid`` and of every span around it."""
        out = []
        while sid is not None and sid in self.by_id:
            out.append(self.by_id[sid][3])
            sid = self.by_id[sid][1]
        return out


def attribute(spans: Sequence[SpanRow], runtime: Sequence[Event], device: Sequence[Event]):
    """(launched, gaps): ``launched`` each device interval as (start ns, end
    ns, id of the innermost span open at its launch or None), the launch
    found by correlation id among the host's runtime events; ``gaps`` each
    stretch of a call (a root span) with no device interval as (start ns,
    end ns, innermost span open at its midpoint or None, the shortest
    runtime call covering the midpoint or "host")."""
    look = _Spans(spans)
    launch_at = {corr: s for _, s, _, corr in runtime}
    launched = [(s, e, look.innermost(launch_at[corr]) if corr in launch_at else None)
                for _, s, e, corr in device]
    busy = [(s, e) for _, s, e, _ in device]
    calls = sorted(runtime, key=lambda r: r[1])
    starts = [r[1] for r in calls]
    out = []
    for root in look.roots:
        for s, e in trace.gaps(busy, root[4], root[5]):
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            cover = [(b - a, n) for n, a, b, _ in calls[max(i - 8, 0):i] if mid <= b]
            out.append((s, e, look.innermost(mid), min(cover)[1] if cover else "host"))
    return launched, out


def totals(spans: Sequence[SpanRow], launched, gaps):
    """({name: device busy ms launched inside a span of that name},
    {name: idle ms charged inside one}): busy the union of the intervals,
    a span's name counting for everything under it."""
    look = _Spans(spans)
    by_name = collections.defaultdict(list)
    for s, e, sid in launched:
        for name in set(look.chain(sid)):
            by_name[name].append((s, e))
    idle = collections.defaultdict(float)
    for s, e, sid, _ in gaps:
        for name in set(look.chain(sid)):
            idle[name] += (e - s) / 1e6
    return {n: trace.union_s(v) / 1e6 for n, v in by_name.items()}, dict(idle)


def rows(records) -> List[SpanRow]:
    """The recorder's spans as ``SpanRow`` tuples."""
    return [(s.id, s.parent, s.call, s.name, s.start_ns, s.end_ns) for s in records.spans]


def profile_events(prof):
    """(runtime events, device events) of a ``torch.profiler`` profile, as
    ``Event`` tuples: the host's CUDA API calls (``cuda*``, ``cu*``) and
    the device's kernel, copy and memset intervals."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    runtime, device = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
        if e.device_type() == cuda:
            device.append(row)
        elif e.device_type() == cpu and e.name().startswith("cu"):
            runtime.append(row)
    return runtime, device


def summary(records, runtime, device, top: int = 10) -> Dict:
    """What the stage metrics read from one recorded, profiled pass."""
    sp = rows(records)
    launched, gaps = attribute(sp, runtime, device)
    busy, idle = totals(sp, launched, gaps)
    look = _Spans(sp)
    named = collections.defaultdict(float)
    for s, e, sid, op in gaps:
        names = look.chain(sid)
        named[f"{names[0] if names else 'host'} | {op}"] += (e - s) / 1e9
    return {"calls": len(look.roots), "busy_ms": busy, "idle_ms": idle,
            "spans": dict(collections.Counter(s[3] for s in sp)),
            "counters": dict(records.counters),
            "unlinked": collections.Counter(
                device[i][0][:60] for i, (_, _, sid) in enumerate(launched) if sid is None),
            "device_events": len(device), "runtime_events": len(runtime),
            "idle_gaps": sorted(([n, t] for n, t in named.items()), key=lambda g: -g[1])[:top]}


def report(st: Dict, out=None) -> None:
    """The summary's sync sites, stages and longest gaps, on ``out``
    (standard error)."""
    out = out or sys.stderr
    calls = max(st["calls"], 1)
    for k, v in sorted(st["counters"].items()):
        if k.startswith("sync."):
            print(f"syncs {k[len('sync.'):]}: {v / calls!r}", file=out)
    for k in sorted(set(st["busy_ms"]) | set(st["idle_ms"])):
        print(f"stage {k}: busy {st['busy_ms'].get(k, 0.0) / calls!r} ms, idle "
              f"{st['idle_ms'].get(k, 0.0) / calls!r} ms a call", file=out)
    for name, s in st["idle_gaps"]:
        print(f"idle {name}: {s!r} s", file=out)
    unlinked = st["unlinked"]
    print(f"stages: {st['calls']} calls, {st['device_events']} device intervals "
          f"({sum(unlinked.values())} outside any span: {unlinked.most_common(4)}), "
          f"{st['runtime_events']} runtime events", file=out)


def collect(ctx) -> Optional[Dict]:
    """The stage summary of the run (``summary``), made once and kept on
    ``ctx``; None off the card or where the program records no spans."""
    if hasattr(ctx, "stages"):
        return ctx.stages
    ctx.stages = None
    import torch

    from threecrate_tpu_torch.utils import profiling

    if not torch.cuda.is_available() or not hasattr(profiling, "recording"):
        return None
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    seed = _seed()
    entry = importlib.import_module(f"portbench.entries.{ctx.traffic['entry']}")
    items = entry.pool(ctx.cfg, ctx.traffic, seed, "cuda")
    program = entry.Program(ctx.cfg, "cuda", seed)
    try:
        inputs = [program.prepare(p) for p in items]
        program.call(inputs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.recording() as rec:
                for x in inputs:
                    program.call(x)
                torch.cuda.synchronize()
    finally:
        program.close()
    del inputs, items
    runtime, device = profile_events(prof)
    ctx.stages = summary(rec, runtime, device)
    report(ctx.stages)
    print(f"stages: the pass took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return ctx.stages
