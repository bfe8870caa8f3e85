"""Scan pairs made from the seed, on the device that runs the cell.

A configuration's ``scene`` names its kind, and the kind's generator is
``portbench/scenes/<kind>.py``, found by that name; a traffic mix names
the motion between the two scans of a pair. A new kind of scene is a new
file here. Every scan is in its own sensor's frame, and a pair's truth
is the source sensor's pose in the target sensor's frame: the transform
that maps source points onto the target.

A kind's module has ``pairs(scene, motion, n_pairs, gen, host, device)``:
``n_pairs`` pairs, the point draws on ``device`` from ``gen``, the
motions (``draw_motion``) and any layout from the host generator
``host``. Entries that do not register pairs call their own kind's
functions through ``kind``.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

HERE = Path(__file__).resolve().parent


class Pair(NamedTuple):
    source: torch.Tensor       # (Ns, 3) float32, source sensor frame
    target: torch.Tensor       # (Nt, 3) float32, target sensor frame
    truth: torch.Tensor        # (4, 4) float32 on the host: source → target


def kind(name: str):
    """The module ``portbench/scenes/<name>.py``."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown scene kind {name!r}: no {path.name} in {HERE}")
    spec = importlib.util.spec_from_file_location(f"portbench_scene_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pose(yaw: float, t) -> torch.Tensor:
    """(4, 4) float64 host pose: a rotation by ``yaw`` about z, then ``t``."""
    c, s = math.cos(yaw), math.sin(yaw)
    m = torch.eye(4, dtype=torch.float64)
    m[:2, :2] = torch.tensor([[c, -s], [s, c]], dtype=torch.float64)
    m[:3, 3] = torch.as_tensor(t, dtype=torch.float64)
    return m


def apply(m: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``m`` (a float64 host pose) applied to float32 points on their
    device, the product in float64."""
    m = m.to(points.device)
    return (points.double() @ m[:3, :3].T + m[:3, 3]).float()


def draw_motion(motion: Dict, gen: torch.Generator) -> torch.Tensor:
    """The source sensor's pose in the target sensor's frame, each of yaw
    and translation drawn uniformly from its [lo, hi] (fixed where lo ==
    hi). ``of: "points"`` gives the motion of the target's points that
    makes the source, whose inverse is the sensor's pose."""
    def u(lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * float(torch.rand((), generator=gen, dtype=torch.float64))

    m = pose(u(motion["yaw_rad"]), [u(r) for r in motion["translation_m"]])
    if motion["of"] == "points":
        return torch.linalg.inv(m)
    if motion["of"] != "sensor":
        raise ValueError(f"motion of {motion['of']!r}: expected 'points' or 'sensor'")
    return m


def make_pairs(scene: Dict, motion: Dict, n_pairs: int, seed: int, device) -> List[Pair]:
    """``n_pairs`` distinct pairs of the scene's kind drawn from ``seed``:
    the draws on the device from one generator, the motions on the host
    from another."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    host = torch.Generator()
    host.manual_seed(seed)
    return kind(scene["kind"]).pairs(scene, motion, n_pairs, gen, host, device)


def pose_error(estimate: torch.Tensor, truth: torch.Tensor):
    """(translation error m, rotation error rad) of a (4, 4) estimate."""
    e = estimate.double().cpu()
    t = truth.double().cpu()
    r = (torch.linalg.inv(t) @ e)[:3, :3]
    skew = torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    angle = torch.atan2(torch.linalg.vector_norm(skew), r.trace() - 1.0)
    return float(torch.linalg.vector_norm(e[:3, 3] - t[:3, 3])), float(angle)


def misses(estimate: torch.Tensor, truth: torch.Tensor, tolerance: Dict) -> bool:
    """Whether ``estimate`` lies beyond ``tolerance`` ({"m", "rad"}) of the truth."""
    t_err, r_err = pose_error(estimate, truth)
    return not (t_err <= tolerance["m"] and r_err <= tolerance["rad"])
