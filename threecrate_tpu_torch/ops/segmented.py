"""Segmented sums and means over sorted runs.

Counterpart of ``threecrate_tpu.ops.segmented``. The segments are
contiguous runs of a sorted array (voxel cells), marked by a ``new_run``
flag on each run's first row. The JAX package reduces them with a
two-level segmented reverse scan, because a scatter-add is slow on its
TPU; here each run is reduced on its own by ``torch.segment_reduce``
over the run lengths. Either way every partial sum stays at run
magnitude: no whole-array prefix sum, whose cancellation would grow
with the array, and no atomics, whose order would change from call to
call.
"""

from __future__ import annotations

import torch


def sorted_run_sums(values: torch.Tensor, new_run: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Per-run sums of ``values`` over contiguous sorted runs.

    values: (N, C); new_run: (N,) bool, True at the first row of each run
    (rows before the first run start belong to no run); valid: (N,) bool,
    invalid rows contribute nothing. Runs reset at ``new_run`` alone: a
    run whose first row is invalid still starts its own run.

    Returns (N, C + 1) float32: at each run-start row the run's
    [Σ values, Σ valid], zeros elsewhere.
    """
    n, c = values.shape
    ext = torch.cat([torch.where(valid[:, None], values.to(torch.float32), 0.0),
                     valid.to(torch.float32)[:, None]], 1)
    out = torch.zeros((n, c + 1), dtype=torch.float32, device=values.device)
    starts = torch.nonzero(new_run).flatten()
    if starts.numel() == 0:
        return out
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    out[starts] = torch.segment_reduce(ext[starts[0]:], "sum", lengths=ends - starts,
                                       axis=0)
    return out


def sorted_run_means(values: torch.Tensor, new_run: torch.Tensor,
                     valid: torch.Tensor):
    """(means (N, C) at run-start rows, counts (N,)); see
    ``sorted_run_sums``."""
    s = sorted_run_sums(values, new_run, valid)
    cnt = s[:, -1]
    return s[:, :-1] / torch.clamp_min(cnt, 1.0)[:, None], cnt
