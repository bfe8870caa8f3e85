"""``hdl64``: a street of boxes standing on a ground plane
(``chip_smoke.py:837-864``, ``street_scene``'s layout: boxes on a grid
with a pitch of the box plus 3.5 m in x and 4 m in y, 10-40 m from the
origin), ray-cast through a Velodyne HDL-64E beam model. A motion of the
sensor casts the source anew from the moved sensor; a motion of the
points moves the target's sweep rigidly, as in the ring scene.

Scene keys: ``beams``, ``elevation_deg`` (top, bottom), ``azimuth_step_deg``,
``mount_height_m``, ``range_m`` (gate), ``range_noise_m``, ``boxes``,
``box_m`` (x, y, z), ``road_x_m`` (the target sensor's span along the road).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import scenes


def street_boxes(scene: Dict, gen: torch.Generator) -> torch.Tensor:
    """(B, 2, 3) float64 min and max corners of the street's boxes, their
    centres drawn without replacement from the grid candidates."""
    lx, ly, lz = scene["box_m"]
    cands = [(x, y) for x in torch.arange(-40.0, 40.01, lx + 3.5).tolist()
             for y in torch.arange(-40.0, 40.01, ly + 4.0).tolist()
             if 10 <= math.hypot(x, y) <= 40]
    pick = torch.randperm(len(cands), generator=gen)[:scene["boxes"]]
    c = torch.tensor([cands[i] for i in pick.tolist()], dtype=torch.float64)
    lo = torch.stack([c[:, 0] - lx / 2, c[:, 1] - ly / 2, torch.zeros(len(c), dtype=torch.float64)], -1)
    return torch.stack([lo, lo + torch.tensor([lx, ly, lz], dtype=torch.float64)], 1)


def beam_directions(scene: Dict, device) -> torch.Tensor:
    """(beams · steps, 3) float64 unit rays in the sensor frame: the
    beams' elevations evenly from the top to the bottom one, each swept
    through a full turn of azimuth steps."""
    el = torch.linspace(math.radians(scene["elevation_deg"][0]),
                        math.radians(scene["elevation_deg"][1]), scene["beams"],
                        dtype=torch.float64, device=device)
    steps = round(360.0 / scene["azimuth_step_deg"])
    az = torch.arange(steps, dtype=torch.float64, device=device) * (2 * math.pi / steps)
    el, az = el[:, None], az[None, :]
    return torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                        torch.sin(el).expand(-1, az.shape[1])], -1).reshape(-1, 3)


def raycast(scene: Dict, boxes: torch.Tensor, sensor: torch.Tensor, gen: torch.Generator,
            device) -> torch.Tensor:
    """(M, 3) float32 returns in the sensor frame of one sweep from the
    world pose ``sensor`` (its origin at the mounting height): the nearest
    hit of each ray on the ground plane z = 0 or a box, within the range
    gate, with Gaussian range noise."""
    dirs = beam_directions(scene, device)
    world = sensor.to(device)
    u = dirs @ world[:3, :3].T
    o = world[:3, 3]
    with torch.no_grad():
        t_ground = torch.where(u[:, 2] < 0, -o[2] / u[:, 2].clamp(max=-1e-12), torch.inf)
        b = boxes.to(device)
        inv = 1.0 / torch.where(u.abs() < 1e-12, torch.full_like(u, 1e-12), u)
        t1 = (b[None, :, 0, :] - o) * inv[:, None, :]
        t2 = (b[None, :, 1, :] - o) * inv[:, None, :]
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (near <= far) & (near > 0)
        t_box = torch.where(hit, near, torch.inf).amin(-1)
        t = torch.minimum(t_ground, t_box)
    lo, hi = scene["range_m"]
    keep = (t >= lo) & (t <= hi)
    rng = t[keep] + scene["range_noise_m"] * torch.randn(
        int(keep.sum()), generator=gen, device=device, dtype=torch.float64)
    return (dirs[keep] * rng[:, None]).float()


def pairs(scene: Dict, motion: Dict, n_pairs: int, gen, host, device) -> List[scenes.Pair]:
    boxes = street_boxes(scene, host)
    lo, hi = scene["road_x_m"]
    out = []
    for _ in range(n_pairs):
        x = lo + (hi - lo) * float(torch.rand((), generator=host, dtype=torch.float64))
        at = scenes.pose(0.0, [x, 0.0, scene["mount_height_m"]])
        truth = scenes.draw_motion(motion, host)
        target = raycast(scene, boxes, at, gen, device)
        source = (scenes.apply(torch.linalg.inv(truth), target) if motion["of"] == "points"
                  else raycast(scene, boxes, at @ truth, gen, device))
        out.append(scenes.Pair(source, target, truth.float()))
    return out
