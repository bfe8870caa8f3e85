"""``PerceptionStep``: the target's union-window normals (kernels 1-2),
then point-to-point ICP on the static-sort window (kernel 3).

A call is one scan pair; it ends when its pose is on the host.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import compare, scenes
from ..reference import plain


def pool(cfg: Dict, traffic: Dict, seed: int, device):
    """The calls' inputs: ``pool_pairs`` scan pairs of the configuration's
    scene under the traffic's motion."""
    return scenes.make_pairs(cfg["scene"], traffic["motion"], traffic["pool_pairs"], seed, device)


def missed(pair, pose, check: Dict) -> bool:
    """A call fails where its pose misses the pair's truth."""
    return scenes.misses(pose, pair.truth, check["truth_tolerance"])


class Program:
    """The timed path. ``call`` returns the pose on the host and, with
    ``keep``, the outputs the check compares."""

    def __init__(self, cfg: Dict, device, seed: int = 0):
        from threecrate_tpu_torch import PerceptionStep

        s = cfg["perception_step"]
        self.step = PerceptionStep(k=s["k"], max_iterations=s["max_iterations"],
                                   conv_thresh=s["conv_thresh"], device=device)
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}

    @staticmethod
    def prepare(pair):
        """The call's inputs, made once in set-up: points and masks."""
        def mask(p):
            return torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        return pair.source, mask(pair.source), pair.target, mask(pair.target)

    def call(self, inputs, keep: bool = False):
        res = self.step(*inputs)
        pose = res.transform.cpu()
        if not keep:
            return pose, None
        return pose, {"normals": res.normals, "curvature": res.curvature, "pose": pose,
                      "mse": float(res.mse)}

    def close(self):
        self.step = None


def shapes(cfg: Dict, pairs) -> Dict:
    """What the per-layer metrics count work from."""
    n = [p.target.shape[0] for p in pairs]
    s = cfg["perception_step"]
    return {"union_points": n, "icp_source": [p.source.shape[0] for p in pairs],
            "icp_target": n, "k": s["k"]}


def reference(pair, cfg: Dict, prec=plain.FP32, seed: int = 0) -> Dict:
    ones = torch.ones
    return plain.perception_step(
        pair.source, ones(pair.source.shape[0], dtype=torch.bool, device=pair.source.device),
        pair.target, ones(pair.target.shape[0], dtype=torch.bool, device=pair.target.device),
        cfg["perception_step"], prec)


def numbers(kept: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared, each 0 where program and reference agree."""
    got_valid = kept["normals"].abs().sum(-1) > 0
    return {
        "normals_p99_rad": compare.normals_p99_rad(kept["normals"], got_valid, ref["normals"],
                                                   ref["normals_valid"]),
        "curvature_p99": compare.curvature_p99(kept["curvature"], got_valid, ref["curvature"],
                                               ref["normals_valid"]),
        "rms_gap_m": compare.rms_gap_m(kept["mse"], ref["mse"]),
    }
