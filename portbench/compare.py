"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference works out from the same inputs.

Each is a share or a distance that is 0 where the two agree, so its
limit (in the cell's ``workloads/<cell>.json``) is an upper one.
"""

from __future__ import annotations

import math

import torch

LEVER_M = 100.0   # the scans' reach: a rotation gap is read at this radius


def _p99(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    xs = torch.sort(x.double().flatten()).values
    return float(xs[min(xs.numel() - 1, math.ceil(0.99 * xs.numel()) - 1)])


def normals_p99_rad(got, got_valid, ref, ref_valid) -> float:
    """99th percentile over points valid on either side of the angle
    between the two normals (π where only one side is valid)."""
    both = got_valid & ref_valid
    either = got_valid | ref_valid
    a, b = got.double(), ref.double()
    ang = torch.atan2(torch.linalg.vector_norm(torch.linalg.cross(a, b), dim=-1), (a * b).sum(-1))
    ang = torch.where(both, ang, math.pi)
    return _p99(ang[either])


def curvature_p99(got, got_valid, ref, ref_valid) -> float:
    """99th percentile over points valid on both sides of |Δ curvature|."""
    both = got_valid & ref_valid
    return _p99((got.double() - ref.double()).abs()[both])


def fpfh_mean(got, got_valid, ref, ref_valid) -> float:
    """Mean over points valid on either side of the L1 gap of the two
    descriptors over its most (300: three sub-histograms of 100 each), 1
    where only one side is valid."""
    either = got_valid | ref_valid
    gap = (got.double() - ref.double()).abs().sum(-1) / 300.0
    gap = torch.where(got_valid & ref_valid, gap, 1.0)
    return float(gap[either].mean()) if bool(either.any()) else 0.0


def match_mismatch(j_got, ok_got, j_ref, ok_ref) -> float:
    """Share of the queries matched on either side whose match differs."""
    either = ok_got | ok_ref
    differ = (ok_got != ok_ref) | (ok_got & (j_got != j_ref))
    return float(differ[either].double().mean()) if bool(either.any()) else 0.0


def pose_gap_m(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Bound on how far the two poses place a point within ``LEVER_M``:
    ‖Δt‖ + LEVER_M·‖ΔR‖_F."""
    d = got.double().cpu() - ref.double().cpu()
    return float(torch.linalg.vector_norm(d[:3, 3]) + LEVER_M * torch.linalg.matrix_norm(d[:3, :3]))


def rms_gap_m(mse_got: float, mse_ref: float) -> float:
    """|√mse − √mse_ref|: the gap in the final correspondences' RMS."""
    return abs(math.sqrt(max(mse_got, 0.0)) - math.sqrt(max(mse_ref, 0.0)))
