"""The stage pass (``portbench/stages.py``) and the four metrics that read
it, on synthetic spans and profiler events; on the card, a kernel
launched inside a span and a host sleep inside a span between two
launches, run in a process of its own (after several profiles in one
process, torch's profiler has lost the device events of a later one):

    python -m pytest --noconftest -p no:cacheprovider portbench/tests/test_portbench_stages.py
"""

import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import roofline, run, stages

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "portbench" / "metrics"
NEW = ("normals_ms", "icp_ms_per_iteration", "icp_idle_ms_per_iteration",
       "descriptor_match_roofline_pct")
MS = 1_000_000   # ns


def metric(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# two calls: perception > normals, icp > icp.setup, icp.iteration > sync
SPANS = [
    (1, None, 1, "perception", 0, 100 * MS),
    (2, 1, 1, "normals", 1 * MS, 30 * MS),
    (3, 1, 1, "icp", 31 * MS, 99 * MS),
    (4, 3, 1, "icp.setup", 32 * MS, 40 * MS),
    (5, 3, 1, "icp.iteration", 41 * MS, 70 * MS),
    (6, 5, 1, "sync.icp.moments", 60 * MS, 70 * MS),
    (7, None, 7, "perception", 200 * MS, 250 * MS),
    (8, 7, 7, "icp", 201 * MS, 249 * MS),
]
RUNTIME = [("cudaLaunchKernel", 2 * MS, 3 * MS, 10),      # inside normals
           ("cudaLaunchKernel", 33 * MS, 34 * MS, 11),    # inside icp.setup
           ("cudaLaunchKernel", 42 * MS, 43 * MS, 12),    # inside icp.iteration
           ("cudaMemcpyAsync", 60 * MS, 70 * MS, 13),     # the moments' read
           ("cudaLaunchKernel", 202 * MS, 203 * MS, 14),  # second call's icp
           ("cudaLaunchKernel", 150 * MS, 151 * MS, 15)]  # between calls
DEVICE = [("union_kernel", 3 * MS, 30 * MS, 10),
          ("sort", 34 * MS, 40 * MS, 11),
          ("icp_match_kernel", 43 * MS, 60 * MS, 12),
          ("Memcpy DtoH", 69 * MS, 70 * MS, 13),
          ("icp_match_kernel", 203 * MS, 240 * MS, 14),
          ("fill", 151 * MS, 152 * MS, 15),
          ("orphan", 95 * MS, 96 * MS, 99)]               # no runtime event


def test_launch_is_put_down_to_the_innermost_span():
    launched, _ = stages.attribute(SPANS, RUNTIME, DEVICE)
    assert [sid for _, _, sid in launched] == [2, 4, 5, 6, 8, None, None]


def test_gap_is_charged_to_the_span_at_its_midpoint():
    _, gaps = stages.attribute(SPANS, RUNTIME, DEVICE)
    by_start = {s // MS: (e // MS, sid, op) for s, e, sid, op in gaps}
    assert by_start[0] == (3, 2, "host")                   # mid 1.5 ms: normals
    assert by_start[30] == (34, 4, "host")                 # mid 32: icp.setup begins at 32
    assert by_start[40] == (43, 5, "host")                 # mid 41.5: before the launch
    assert by_start[60] == (69, 6, "cudaMemcpyAsync")      # the read's wait
    assert by_start[70] == (95, 3, "host")
    assert by_start[96] == (100, 3, "host")                # mid 98: icp ends at 99
    assert by_start[200] == (203, 8, "host")
    assert by_start[240] == (250, 8, "host")
    assert not any(150 <= s // MS < 200 for s, _, _, _ in gaps)   # between calls: no gap


def test_totals_count_a_span_for_everything_under_it():
    launched, gaps = stages.attribute(SPANS, RUNTIME, DEVICE)
    busy, idle = stages.totals(SPANS, launched, gaps)
    assert busy["normals"] == pytest.approx(27.0)
    assert busy["icp.setup"] == pytest.approx(6.0)
    assert busy["icp"] == pytest.approx(6.0 + 17.0 + 1.0 + 37.0)
    assert busy["perception"] == pytest.approx(27.0 + 61.0)
    assert idle["icp"] == pytest.approx(4 + 3 + 9 + 25 + 4 + 3 + 10)
    assert idle["sync.icp.moments"] == pytest.approx(9.0)
    assert idle["normals"] == pytest.approx(3.0)
    assert idle["perception"] == pytest.approx(3 + 4 + 3 + 9 + 25 + 4 + 3 + 10)


class _Records:
    def __init__(self, spans, counters):
        self.spans = [SimpleNamespace(id=i, parent=p, call=c, name=n, start_ns=s, end_ns=e)
                      for i, p, c, n, s, e in spans]
        self.counters = counters


def test_summary_and_report(capsys):
    rec = _Records(SPANS, {"icp.iterations": 3, "sync.icp.moments": 3, "sync.icp.result": 4})
    st = stages.summary(rec, RUNTIME, DEVICE)
    assert st["calls"] == 2 and st["spans"]["icp"] == 2
    assert st["unlinked"] == {"fill": 1, "orphan": 1}
    assert st["idle_gaps"][0] == ["icp | host", pytest.approx(0.025 + 0.004 + 0.003 + 0.010)]
    assert ["sync.icp.moments | cudaMemcpyAsync", pytest.approx(0.009)] in st["idle_gaps"]
    stages.report(st)
    err = capsys.readouterr().err
    assert "syncs icp.moments: 1.5\n" in err and "syncs icp.result: 2.0\n" in err


def _ctx(busy, idle, counters, spans, calls=2, shapes=None):
    st = {"calls": calls, "busy_ms": busy, "idle_ms": idle, "counters": counters,
          "spans": spans}
    return SimpleNamespace(stages=st, shapes=shapes or {})


def test_stage_metric_arithmetic():
    ctx = _ctx({"normals": 50.0, "icp": 80.0, "icp.setup": 20.0}, {"icp": 12.0},
               {"icp.iterations": 15}, {"normals": 2, "icp": 2})
    assert metric("normals_ms")(ctx) == pytest.approx(25.0)
    assert metric("icp_ms_per_iteration")(ctx) == pytest.approx(4.0)
    assert metric("icp_idle_ms_per_iteration")(ctx) == pytest.approx(0.8)
    shapes = {"search_queries": [16384], "search_targets": [2 ** 20], "descriptor_dim": 33,
              "search_passes": 2}
    least_ms = 1e3 * roofline.bound(*roofline.search_work(16384, 2 ** 20, 33, 2, 0, 0))[0]
    ctx = _ctx({"match": 2 * 40 * least_ms}, {}, {}, {"match": 2}, shapes=shapes)
    assert metric("descriptor_match_roofline_pct")(ctx) == pytest.approx(2.5)
    assert least_ms == pytest.approx(1e3 * 2 * 16384 * 2 ** 20 * 33 * 2 / 67e12)


@pytest.mark.parametrize("name", NEW)
def test_stage_metrics_read_nothing_without_spans(name):
    assert metric(name)(SimpleNamespace(stages=None, shapes={})) is None
    assert metric(name)(_ctx({}, {}, {}, {})) is None


def test_stage_pass_yields_nothing_off_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = SimpleNamespace(traffic={"entry": "perception_step"}, cfg={})
    assert stages.collect(ctx) is None and ctx.stages is None
    assert stages.collect(ctx) is None


def test_stage_metrics_per_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    layer = {n: {m["name"] for m in run.metrics_for(bench, w, "per_layer")}
             for n, w in cells.items()}
    assert set(NEW[:3]) <= layer["lidar-8m.track"]
    assert not set(NEW[3:]) & layer["lidar-8m.track"]
    assert NEW[3] in layer["lidar-1m.relocalize"]
    assert not set(NEW[:3]) & layer["lidar-1m.relocalize"]
    for name in NEW:
        assert run.metric_file(name).name == f"{name}.py"


@pytest.mark.cuda
def test_launch_and_sleep_on_the_card_are_put_down_to_their_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler's device intervals come from the card")
    from torch.profiler import ProfilerActivity, profile

    from threecrate_tpu_torch.utils import profiling

    x = torch.ones(1 << 22, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            with profiling.span("outer"):
                with profiling.span("launch"):
                    y = x * 2.0
                torch.cuda.synchronize()
                with profiling.span("nap"):
                    time.sleep(0.05)
                z = y + 1.0
                torch.cuda.synchronize()
    runtime, device = stages.profile_events(prof)
    assert runtime and len(device) >= 2
    sp = stages.rows(rec)
    ids = {row[3]: row[0] for row in sp}
    launched, gaps = stages.attribute(sp, runtime, device)
    assert [sid for _, _, sid in launched][:2] == [ids["launch"], ids["outer"]]
    longest = max(gaps, key=lambda g: g[1] - g[0])
    assert longest[2] == ids["nap"] and longest[1] - longest[0] >= 45 * MS
    busy, idle = stages.totals(sp, launched, gaps)
    assert idle["nap"] >= 45.0 and busy["launch"] > 0
    assert float(z[0]) == 3.0
