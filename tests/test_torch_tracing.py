"""The port's stage spans and counters (``utils.profiling``): nesting and
ids, recording off, counters, the clock against ``torch.profiler``, the
exporter, and the spans the two benchmarked entries record.

The file imports no JAX, so its ``cuda`` test also runs on the card, in
a process of its own (after several profiles in one process, torch's
profiler has lost the device events of a later one):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py

Stated tolerances: a span's stamps within 50 µs of its
``record_function`` event's (the range opens just before the start stamp
and closes just before the end stamp); on the card, the ``sync.*``
counters of a call plus the caller's one pose read equal the syncs the
sync debug mode counts, exactly.
"""

import collections
import json
import threading
import traceback
import warnings

import numpy as np
import pytest
import torch

import threecrate_tpu_torch as tt
from threecrate_tpu_torch.ops import registration
from threecrate_tpu_torch.utils import profiling

torch.set_num_threads(2)   # the suite runs several workers per host


def _names(rec):
    return [s.name for s in rec.spans]


def test_spans_nest_with_parent_and_call_ids():
    with profiling.recording() as rec:
        for _ in range(2):
            with profiling.span("call") as root:
                with profiling.span("stage") as stage:
                    with profiling.span("leaf") as leaf:
                        pass
                with profiling.span("stage2"):
                    pass
            assert stage.parent == root.id and leaf.parent == stage.id
            assert root.parent is None and root.call == stage.call == leaf.call == root.id
    assert _names(rec) == ["leaf", "stage", "stage2", "call"] * 2
    calls = rec.calls
    assert [c.name for c in calls] == ["call", "call"] and calls[0].id != calls[1].id
    assert {s.call for s in rec.spans} == {c.id for c in calls}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = next(q for q in rec.spans if q.id == s.parent)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_recording_off_records_nothing():
    assert profiling.span("a") is profiling.span("b")     # one shared no-op
    with profiling.span("a") as got:
        assert got is None
    with profiling.recording() as rec:
        pass
    with profiling.span("after"):
        pass
    assert rec.spans == [] and rec.calls == [] and rec.counters == {}
    assert not profiling._recording


def test_counters_count():
    before = profiling.counters["test.counted"]
    profiling.count("test.counted")
    with profiling.recording() as rec:
        profiling.count("test.counted", 3)
        profiling.count("test.other")
    profiling.count("test.counted", 2)
    assert profiling.counters["test.counted"] == before + 6
    assert rec.counters["test.counted"] == 3 and rec.counters["test.other"] == 1


def test_host_sync_counts_reads_off_the_host_only():
    with profiling.recording() as rec:
        with profiling.host_sync("test.host", torch.ones(2)):
            pass
        with profiling.host_sync("test.meta", torch.empty(2, device="meta")):
            pass
        with profiling.host_sync("test.copies", torch.device("meta"), 2):
            pass
    assert rec.counters == {"sync.test.meta": 1, "sync.test.copies": 2}
    assert _names(rec) == ["sync.test.meta", "sync.test.copies"]


def test_nested_recordings_and_threads_keep_their_own_stacks():
    seen = {}

    def worker():
        with profiling.span("thread") as s:
            seen["span"] = s

    with profiling.recording() as outer:
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            with profiling.recording() as inner:
                with profiling.span("inner"):
                    pass
    assert seen["span"].parent is None              # not under the other thread's span
    assert sorted(_names(outer)) == ["inner", "main", "thread"]
    assert _names(inner) == ["inner"]


def test_stamps_on_the_profiler_clock():
    """Each span's stamps against its range's in the profiler's events,
    the closest of four profiles (a preempted thread can stall between the
    two stamps), and the ATen ops issued inside each span within its
    stamps. Each profile records an op before the spans: the first event
    of a profile on a thread sets up the profiler's buffers for it."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    gap = {}
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.mm(x, x)
            with profiling.recording() as rec:
                for i in range(3):
                    with profiling.span(f"stage{i}"):
                        torch.mm(x, x).sum()
        events = list(prof.profiler.kineto_results.events())
        ranges = {e.name(): e for e in events if e.name().startswith("stage")}
        for s in rec.spans:
            e = ranges[s.name]
            off = max(abs(e.start_ns() - s.start_ns),
                      abs(e.start_ns() + e.duration_ns() - s.end_ns))
            gap[s.name] = min(gap.get(s.name, off), off)
        ops = [e for e in events if e.name() in ("aten::mm", "aten::sum")
               and e.start_ns() >= min(s.start_ns for s in rec.spans)]
        assert sum(e.name() == "aten::mm" for e in ops) == 3
        for op in ops:
            assert any(s.start_ns <= op.start_ns()
                       and op.start_ns() + op.duration_ns() <= s.end_ns for s in rec.spans)
    assert len(gap) == 3 and max(gap.values()) <= 50_000, gap


def test_trace_writes_the_stages(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced.stage"):
            torch.ones(8).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "traced.stage" in names
    assert not profiling._recording


def _pair(n=3000, seed=0):
    g = torch.Generator().manual_seed(seed)
    tgt = torch.rand(n, 3, generator=g) * torch.tensor([10.0, 10.0, 1.0])
    return tgt + torch.tensor([0.05, -0.03, 0.02]), tgt


def test_perception_step_records_its_stages():
    src, tgt = _pair()
    m = torch.ones(src.shape[0], dtype=torch.bool)
    step = tt.PerceptionStep(k=10, max_iterations=20, device="cpu")
    with profiling.recording() as rec:
        step(src, m, tgt, m)
    names = _names(rec)
    assert [c.name for c in rec.calls] == ["perception"]
    assert {"perception", "normals", "icp", "icp.iteration"} <= set(names)
    assert names.count("icp.iteration") == rec.counters["icp.iterations"] >= 1
    assert not any(k.startswith("sync.") for k in rec.counters)   # nothing waits on the CPU
    by = {s.name: s for s in rec.spans}
    assert by["normals"].parent == by["icp"].parent == by["perception"].id


@pytest.mark.parametrize("window", [False, True])
def test_icp_iterations_counted(window):
    src, tgt = _pair(2048, 1)
    m = torch.ones(src.shape[0], dtype=torch.bool)
    with profiling.recording() as rec:
        _, _, it, _, _ = registration._icp_p2p(src, m, tgt, m, torch.eye(4), 20, 1e-6,
                                               torch.inf, window=window)
    names = _names(rec)
    assert rec.counters["icp.iterations"] == it == names.count("icp.iteration")
    assert names.count("icp.setup") == int(window)
    assert [c.name for c in rec.calls] == ["icp"]


def _bumpy(n=700, seed=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.5 * np.sin(xy[:, 0] * 2.5) * np.cos(xy[:, 1] * 1.5)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def _registration_pair():
    pts = _bumpy()
    t = (tt.Transform.from_axis_angle([0, 0, 1.0], 0.6)
         @ tt.Transform.from_translation([1.5, -0.8, 0.4])).matrix.numpy()
    return pts, (pts @ t[:3, :3].T + t[:3, 3]).astype(np.float32)


def test_registration_model_records_its_stages():
    src, tgt = _registration_pair()
    model = tt.RegistrationModel(max_iterations=30, ransac_iterations=8192, fpfh_radius=0.5,
                                 distance_threshold=0.05, hypothesis_batch=2048)
    with profiling.recording() as rec:
        res = model(tt.PointCloud.from_numpy(src, device="cpu"),
                    tt.PointCloud.from_numpy(tgt, device="cpu"))
    names = _names(rec)
    assert [c.name for c in rec.calls] == ["registration"]
    for name, n in (("normals", 2), ("fpfh", 2), ("match", 1), ("ransac", 1)):
        assert names.count(name) == n, name
    # the RANSAC stage's ICP refinement, then the model's own
    assert names.count("icp") == 2
    assert names.count("icp.iteration") == rec.counters["icp.iterations"] >= res.iterations
    batches = rec.counters["ransac.hypotheses"] // 2048
    assert 1 <= batches <= 4 and rec.counters["ransac.hypotheses"] == 2048 * batches
    by = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "match":
            assert by[s.parent].name == "registration"


def test_span_site_costs_little_when_off():
    import time

    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("off"):
            pass
    per = (time.perf_counter() - t0) / n
    assert per < 20e-6     # a loose ceiling for a loaded host; PERF.md gives the timing


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["perception", "registration"])
def test_sync_sites_count_every_host_sync_on_the_card(entry, monkeypatch):
    """Every host sync of a call is one a ``sync.*`` site counts (the
    caller's pose read aside), at sizes that take the window paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: host syncs exist only on the card")
    from threecrate_tpu_torch.ops import features as tf
    from threecrate_tpu_torch.ops import normals as tn

    monkeypatch.setattr(tn, "AUTO_WINDOW_THRESHOLD", 4096)
    monkeypatch.setattr(tf, "FUSED_FPFH_THRESHOLD", 4096)
    monkeypatch.setattr(registration, "CORRESPONDENCE_WINDOW_THRESHOLD", 2 ** 20)
    if entry == "perception":
        src, tgt = (x.cuda() for x in _pair(16_640, 2))
        m = torch.ones(src.shape[0], dtype=torch.bool, device="cuda")
        step = tt.PerceptionStep(k=10, max_iterations=20, device="cuda")

        def call():
            return step(src, m, tgt, m).transform.cpu()
    else:
        s, t = _registration_pair()
        src, tgt = (tt.PointCloud.from_numpy(x, device="cuda") for x in (s, t))
        model = tt.RegistrationModel(max_iterations=30, ransac_iterations=8192,
                                     fpfh_radius=0.5, distance_threshold=0.05,
                                     hypothesis_batch=2048)

        def call():
            return model(src, tgt).transformation.cpu()
    call()
    torch.cuda.synchronize()
    where = []

    def seen(message, *args, **kwargs):
        if "called a synchronizing" in str(message):   # not the mode's once-a-process notice
            where.append(" <- ".join(f"{f.filename.split('/')[-1]}:{f.lineno}"
                                     for f in traceback.extract_stack()[-2:-6:-1]))

    with profiling.recording() as rec:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    sites = {k: v for k, v in rec.counters.items() if k.startswith("sync.")}
    assert sum(sites.values()) + 1 == len(where), (sites, collections.Counter(where))
    assert _names(rec).count("sync.icp.moments") == sites["sync.icp.moments"]
