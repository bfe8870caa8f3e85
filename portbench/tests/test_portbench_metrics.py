"""The metric arithmetic on synthetic readings."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import roofline, trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def metric(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("intervals, union", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 1.0), (0.5, 2.0)], 2.0),
    ([(2.0, 3.0), (0.0, 1.0)], 2.0),
    ([(0.0, 4.0), (1.0, 2.0), (3.0, 5.0)], 5.0),
])
def test_union_of_intervals(intervals, union):
    assert trace.union_s(intervals) == pytest.approx(union)


def test_gaps_between_intervals():
    assert trace.gaps([(1.0, 2.0), (1.5, 3.0), (4.0, 5.0)], 0.0, 6.0) == \
        [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]
    assert trace.gaps([(0.0, 6.0)], 0.0, 6.0) == []


def test_p95_is_over_every_call():
    read = metric("latency_p95_ms")
    lat = list(range(1, 101))       # 1..100 ms
    assert read(SimpleNamespace(latencies_ms=lat)) == 95
    assert read(SimpleNamespace(latencies_ms=[7.0])) == 7.0
    assert read(SimpleNamespace(latencies_ms=lat[::-1] + [1000.0] * 10)) == 1000.0
    assert read(SimpleNamespace(latencies_ms=[])) is None


def test_rate_and_idle_share():
    assert metric("scans_per_s")(SimpleNamespace(calls=50, window_s=2.0)) == 25.0
    assert metric("idle_share")(SimpleNamespace(busy_s=0.5, window_s=2.0)) == 0.75
    assert metric("host_syncs_per_scan")(SimpleNamespace(host_syncs=73, sync_calls=8)) == 9.125


def test_roofline_takes_the_larger_bound():
    assert roofline.bound(3.35e12, 0) == (1.0, "bytes")
    assert roofline.bound(0, 67e12) == (1.0, "operations")
    assert roofline.bound(3.35e12, 2 * 67e12) == (2.0, "operations")


def test_search_work_counts_the_passes():
    nbytes, ops = roofline.search_work(16384, 2 ** 20, 33, 2, 4096, 2048)
    assert ops == 2.0 * 16384 * 2 ** 20 * 33 * 2 + 31.0 * 4096 * 2048
    assert roofline.bound(nbytes, ops)[1] == "operations"


def test_union_roofline_reader():
    n, k = 2 ** 20, 10
    work_a, work_b = roofline.union_work(n, 256, 16, k * n, k * n)
    least = roofline.bound(*work_a)[0] + roofline.bound(*work_b)[0]
    ctx = SimpleNamespace(
        events=[("void union_kernel<12, false>(...)", 0.0, least * 5),
                ("void union_kernel<12, true>(...)", 1.0, 1.0 + least * 5),
                ("void other_kernel()", 2.0, 3.0)],
        launches={"union_window_a": 1, "union_window_b": 1},
        shapes={"k": k, "union_points": [n]})
    assert metric("union_normals_roofline_pct")(ctx) == pytest.approx(10.0)
    ctx.events = ctx.events[2:]
    assert metric("union_normals_roofline_pct")(ctx) is None


def test_icp_roofline_reader():
    least = roofline.bound(*roofline.icp_match_work(1024, 2048, 128))[0]
    ctx = SimpleNamespace(events=[("void icp_match_kernel<1>(...)", 0.0, 4 * least)] * 2,
                          launches={"icp_match": 2},
                          shapes={"icp_source": [1024], "icp_target": [2048]})
    assert metric("icp_match_roofline_pct")(ctx) == pytest.approx(25.0)
    ctx.launches = {"icp_match": 0}
    assert metric("icp_match_roofline_pct")(ctx) is None


def test_search_roofline_reader():
    shapes = {"search_queries": [16384], "search_targets": [2 ** 20], "descriptor_dim": 33,
              "search_passes": 2, "hypothesis_batch": 4096, "correspondences": 2048}
    nbytes, ops = roofline.search_work(16384, 2 ** 20, 33, 2, 4096 * 2, 2048)
    least_ms = 1e3 * roofline.bound(nbytes, ops)[0]
    ctx = SimpleNamespace(spans={"search": [least_ms * 20, least_ms * 20]},
                          counters={"ransac_batches": 4}, shapes=shapes)
    assert metric("search_roofline_pct")(ctx) == pytest.approx(5.0)
    ctx.spans = {"search": []}
    assert metric("search_roofline_pct")(ctx) is None
