"""``ring``: the JAX package's benchmark cloud (``chip_smoke.py:745-761``,
``scan_labels``, copied with its distribution): ground out to ~100 m,
radius |N(0, 25)| + 2 m, 5 cm thick, 30% of the points lifted uniformly
up to 4 m. The scene is the cloud itself, so the source of a pair is the
target moved rigidly (``chip_smoke.py:994-999``, ``registration_pair``,
and the shifted PerceptionStep pair).

Scene keys: ``points``, the size of a scan.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import scenes


def ring_scan(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, 3) float32: ``scan_labels``' distribution, drawn on ``device``."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    ang = rand(n) * (2 * math.pi)
    r = randn(n).abs() * 25.0 + 2.0
    z = randn(n) * 0.05
    lift = rand(n) < 0.3
    z = torch.where(lift, rand(n) * 4.0, z)
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang), z], -1)


def pairs(scene: Dict, motion: Dict, n_pairs: int, gen, host, device) -> List[scenes.Pair]:
    if motion["of"] != "points":
        raise ValueError("a ring scan has no sensor to move: its motion is of the points")
    out = []
    for _ in range(n_pairs):
        target = ring_scan(scene["points"], gen, device)
        truth = scenes.draw_motion(motion, host)
        out.append(scenes.Pair(scenes.apply(torch.linalg.inv(truth), target), target,
                               truth.float()))
    return out
