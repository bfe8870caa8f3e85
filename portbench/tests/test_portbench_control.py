"""The check against its control and against faults planted in the timed
path: each must read as not correct, where sound runs read as correct.

The control is the plain reference computed in TF32 (every product's
operands rounded to a 10-bit mantissa), put in the program's place. The
faults break the program underneath a whole run (``run.run`` without the
harness's look for a card): an ICP step that returns the pose unchanged,
the pass-B half of every union-window neighbourhood left out, the match
coordinates altered by ±1 mm in the kernel that produces them, and the
FPFH weighted sums' θ bins reversed where they are produced. CPU runs are at a small size
(the port's kernels run their plain versions there); the ``cuda`` tests
take the control at each cell's own size on the card.
"""

import json
from pathlib import Path

import pytest
import torch

from portbench import calibrate, run

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"config": {"scene": {"points": 70_000},
                    "registration_model": {"max_query_descriptors": 2048,
                                           "ransac_iterations": 2048, "hypothesis_batch": 1024}},
         "traffic": {"pool_pairs": 1, "warmup_calls": 1}}


def limits(cell):
    return json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json").read_text())["limits"]


def fails(numbers, lim):
    return [k for k in lim if numbers[k] > lim[k]]


@pytest.fixture
def fused_fpfh_at_small_sizes(monkeypatch):
    from threecrate_tpu_torch.ops import features

    from portbench.reference import plain

    monkeypatch.setattr(features, "FUSED_FPFH_THRESHOLD", 0)
    monkeypatch.setattr(plain, "FUSED_FPFH_ABOVE", 0)


def test_control_fails_track_on_cpu():
    lim = limits("lidar-8m.track")
    (r,) = calibrate.readings("lidar-8m.track", [2 ** 31 + 3], True, "cpu", SMALL)
    assert not fails(r["program"], lim)
    assert fails(r["control"], lim)


def test_control_fails_relocalize_on_cpu(fused_fpfh_at_small_sizes):
    lim = limits("lidar-1m.relocalize")
    (r,) = calibrate.readings("lidar-1m.relocalize", [2 ** 31 + 4], True, "cpu", SMALL)
    assert not fails(r["program"], lim)
    assert fails(r["control"], lim)


def _pose_unchanged(monkeypatch):
    from threecrate_tpu_torch.ops import linalg

    monkeypatch.setattr(linalg, "kabsch_from_moments", lambda m: torch.eye(4))


def _union_half(monkeypatch):
    from threecrate_tpu_torch.kernels import knn

    def pass_a_only(pts, valid, pos_a, hi_a, k, tile=256, band=16):
        return torch.zeros((11, pts.shape[1]), dtype=torch.float32, device=pts.device)

    monkeypatch.setattr(knn, "window_union_b_tiles", pass_a_only)


def _match_altered(monkeypatch):
    from threecrate_tpu_torch.kernels import icp

    orig = icp.icp_match_tiles

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[0, 0::2] += 1e-3
        out[0, 1::2] -= 1e-3
        return out

    monkeypatch.setattr(icp, "icp_match_tiles", altered)


@pytest.mark.parametrize("fault", [None, _pose_unchanged, _union_half, _match_altered],
                         ids=["sound", "pose_unchanged", "union_half", "match_altered"])
def test_track_faults_read_not_correct(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    res, checks = run.run("lidar-8m.track", 2 ** 31 + 21, 0.2, False, "cpu", SMALL)
    assert res["correct"] is (fault is None), checks


def test_relocalize_fpfh_altered_reads_not_correct(fused_fpfh_at_small_sizes, monkeypatch):
    from threecrate_tpu_torch.kernels import fpfh

    orig = fpfh.fpfh_weight_a_tiles

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        return torch.cat([out[0:11].flip(0), out[11:]])

    monkeypatch.setattr(fpfh, "fpfh_weight_a_tiles", altered)
    res, checks = run.run("lidar-1m.relocalize", 2 ** 31 + 22, 0.2, False, "cpu", SMALL)
    assert res["correct"] is False, checks
    assert checks["fpfh_mean"][0] > checks["fpfh_mean"][1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lidar-8m.track", "lidar-1m.relocalize"])
def test_control_fails_at_full_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the card")
    lim = limits(cell)
    rows = list(calibrate.readings(cell, [2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33], True))
    assert all(not fails(r["program"], lim) for r in rows)
    assert all(fails(r["control"], lim) for r in rows)
