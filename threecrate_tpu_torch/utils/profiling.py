"""Timing on the card with CUDA events."""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def median_time(fn: Callable, warmup: int = 2, iters: int = 5) -> float:
    """Median seconds of ``fn()`` over ``iters`` runs after ``warmup``.

    Each run is bracketed by CUDA events on the current stream, so the
    time covers the device work ``fn`` enqueues and any host gaps in
    between. There is no CPU fallback: a time is only ever measured on
    the card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("median_time measures on a CUDA device; none found")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)
