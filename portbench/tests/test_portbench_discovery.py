"""Cells, configurations, scene kinds, traffic mixes, entries and metrics
are found by name, and a new cell is new files only."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = run.load_cell(cell, BENCH)
    assert c.cell["chips"] == 1
    assert hasattr(c.entry, "Program") and hasattr(c.entry, "reference")
    assert c.check["limits"] and all(v > 0 for v in c.check["limits"].values())
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in run.metrics_for(BENCH, c.cell, kind)]
        assert names
        for name in names:
            assert run.metric_file(name).is_file()


def test_metric_sets_per_cell():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {n: {m["name"] for m in run.metrics_for(BENCH, w, "end_to_end")} for n, w in cells.items()}
    layer = {n: {m["name"] for m in run.metrics_for(BENCH, w, "per_layer")} for n, w in cells.items()}
    assert e2e["lidar-8m.track"] == {"scans_per_s.track", "latency_p95_ms", "setup_s"}
    assert layer["lidar-8m.track"] == {"host_syncs_per_scan.track", "union_normals_roofline_pct",
                                       "icp_match_roofline_pct", "idle_share.track"}
    assert e2e["lidar-1m.relocalize"] == {"scans_per_s.relocalize", "setup_s"}
    assert layer["lidar-1m.relocalize"] == {"host_syncs_per_scan.relocalize",
                                            "search_roofline_pct", "idle_share.relocalize"}


def test_a_split_metric_is_read_by_its_base_reader():
    assert run.metric_file("scans_per_s.track") == run.metric_file("scans_per_s")
    assert run.metric_file("idle_share.relocalize").name == "idle_share.py"
    assert run.metric_file("setup_s").name == "setup_s.py"


def test_every_config_file_is_listed_once():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert (ROOT / f).is_file() and f.startswith("portbench/")


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell("no-such.cell", BENCH)


def _copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    return pb, {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}


def _run_cell(tmp_path, bench, cell):
    """Write ``bench`` beside the copy and run ``cell`` there on the CPU:
    (result, forbidden modules loaded)."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from portbench import run; "
            f"res, _ = run.run({cell!r}, 5, 0.2, False, device='cpu'); "
            "print(json.dumps(res)); print(json.dumps(run.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    *_, line, found = out.stdout.strip().splitlines()
    return json.loads(line), json.loads(found)


def test_a_throwaway_cell_is_new_files_only(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a check,
    a metric and BENCHMARK.json entries, edit no file, and run the new
    cell on the CPU at a small size."""
    pb, before = _copy(tmp_path)
    (pb / "configs" / "tiny-ring.json").write_text(json.dumps({
        "scene": {"kind": "ring", "points": 70000},
        "perception_step": {"k": 10, "max_iterations": 20, "conv_thresh": 1e-6}}))
    (pb / "traffic" / "tiny-track.json").write_text(json.dumps({
        "entry": "perception_step", "pool_pairs": 1, "warmup_calls": 1, "trace_seconds": 0.1,
        "motion": {"of": "points", "yaw_rad": [0, 0],
                   "translation_m": [[0.05, 0.05], [0, 0], [0, 0]]}}))
    (pb / "workloads" / "tiny-ring.tiny-track.json").write_text(json.dumps({
        "check_items": 1, "truth_tolerance": {"m": 0.001, "rad": 0.0001},
        "limits": {"normals_p99_rad": 2e-4, "rms_gap_m": 5e-4}}))
    (pb / "metrics" / "calls_total.py").write_text("def read(ctx):\n    return ctx.calls\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-ring", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tiny-ring.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny-ring.tiny-track", "config": "tiny-ring",
                               "traffic": "tiny-track", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_total", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-ring.tiny-track"]})
    res, found = _run_cell(tmp_path, bench, "tiny-ring.tiny-track")
    assert {p: p.read_bytes() for p in before} == before
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "calls_total"}
    assert res["metrics"]["calls_total"]["value"] == res["attempted"] >= 1
    assert found == []


SLAB_KIND = """
import math
import torch


def cloud(scene, gen, device):
    n = scene["points"]
    xy = (torch.rand((n, 2), generator=gen, device=device) - 0.5) * scene["side_m"]
    z = scene["wave_m"] * torch.sin(xy[:, 0]) * torch.cos(0.5 * xy[:, 1])
    return torch.cat([xy, z[:, None]], 1)
"""

NORMALS_ENTRY = """
import torch

from portbench import compare, scenes
from portbench.reference import plain


def pool(cfg, traffic, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kind = scenes.kind(cfg["scene"]["kind"])
    return [kind.cloud(cfg["scene"], gen, device) for _ in range(traffic["pool_items"])]


def _mask(points):
    return torch.ones(points.shape[0], dtype=torch.bool, device=points.device)


class Program:
    def __init__(self, cfg, device, seed=0):
        self.k = cfg["k"]
        self.spans, self.counters, self.time_spans = {}, {}, False

    def prepare(self, points):
        from threecrate_tpu_torch import PointCloud

        return PointCloud.from_points(points)

    def call(self, cloud, keep=False):
        from threecrate_tpu_torch.ops.normals import (NormalEstimationConfig,
                                                      estimate_normals_detailed)

        res = estimate_normals_detailed(cloud, NormalEstimationConfig(k_neighbors=self.k))
        share = float(res.valid.double().mean())
        return share, ({"normals": res.normals, "valid": res.valid} if keep else None)

    def close(self):
        pass


def missed(points, share, check):
    return share < check["min_valid_share"]


def shapes(cfg, items):
    return {}


def reference(points, cfg, prec=plain.FP32, seed=0):
    nrm, _, valid = plain.union_normals(points, _mask(points), cfg["k"], prec)
    return {"normals": nrm, "valid": valid}


def numbers(kept, ref):
    return {"normals_p99_rad": compare.normals_p99_rad(kept["normals"], kept["valid"],
                                                       ref["normals"], ref["valid"])}
"""


def test_a_new_scene_kind_and_an_entry_with_no_pose_are_new_files_only(tmp_path):
    """A cell whose inputs are single clouds of a new scene kind, driving
    an entry whose answer is no pose (the share of valid normals) and
    which judges ``failed`` itself: new files and BENCHMARK.json entries."""
    pb, before = _copy(tmp_path)
    (pb / "scenes" / "slab.py").write_text(SLAB_KIND)
    (pb / "entries" / "normals_only.py").write_text(NORMALS_ENTRY)
    (pb / "configs" / "tiny-slab.json").write_text(json.dumps({
        "scene": {"kind": "slab", "points": 70000, "side_m": 20.0, "wave_m": 0.3}, "k": 10}))
    (pb / "traffic" / "normals.json").write_text(json.dumps({
        "entry": "normals_only", "pool_items": 2, "warmup_calls": 1, "trace_seconds": 0.1}))
    (pb / "workloads" / "tiny-slab.normals.json").write_text(json.dumps({
        "check_items": 2, "min_valid_share": 0.99, "limits": {"normals_p99_rad": 2e-4}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-slab", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tiny-slab.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny-slab.normals", "config": "tiny-slab",
                               "traffic": "normals", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "scans_per_s.normals", "unit": "scans/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-slab.normals"]})
    res, found = _run_cell(tmp_path, bench, "tiny-slab.normals")
    assert {p: p.read_bytes() for p in before} == before
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1 and set(res["metrics"]) == {"scans_per_s.normals", "setup_s"}
    assert res["checks"]["normals_p99_rad"]["value"] <= 2e-4
    assert found == []
