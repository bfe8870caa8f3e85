"""``RegistrationModel``: union normals on both clouds (kernels 1-2), the
fused-window FPFH (kernels 6-9), descriptor matching, batched RANSAC,
then the coarse-then-full ICP refinement (kernel 3).

A call is one scan pair; it ends when its pose is on the host. The call
returns only the refined pose, so the check reads the stages' outputs
through taps: the program's stage functions, looked up by name where
they are called, are wrapped for the whole run. A tap keeps a reference
to what its stage returned (only in the calls the check samples) and,
in the traced run, brackets the search stage with CUDA events. Every
tap has to fire in every call: a call in which a stage was not called
by its name raises, naming the stage, since the check and
``search_roofline_pct`` would otherwise lose sight of it.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import compare, scenes
from ..reference import plain

_REG_KEYS = ("ransac_iterations", "distance_threshold", "inlier_ratio", "fpfh_radius",
             "max_correspondences", "max_query_descriptors", "refine_with_icp", "k_normals",
             "hypothesis_batch", "mutual_check")


def settings(cfg: Dict, seed: int) -> Dict:
    """The registration settings of the configuration, with the RANSAC
    generator's seed drawn from the run's."""
    s = dict(cfg["registration_model"])
    s["seed"] = seed % (2 ** 63)
    return s


def pool(cfg: Dict, traffic: Dict, seed: int, device):
    """The calls' inputs: ``pool_pairs`` scan pairs of the configuration's
    scene under the traffic's motion."""
    return scenes.make_pairs(cfg["scene"], traffic["motion"], traffic["pool_pairs"], seed, device)


def missed(pair, pose, check: Dict) -> bool:
    """A call fails where its pose misses the pair's truth."""
    return scenes.misses(pose, pair.truth, check["truth_tolerance"])


class Program:
    def __init__(self, cfg: Dict, device, seed: int = 0):
        from threecrate_tpu_torch import RegistrationModel
        from threecrate_tpu_torch.ops import features
        from threecrate_tpu_torch.ops import global_registration as greg

        s = settings(cfg, seed)
        self.model = RegistrationModel(max_iterations=s["max_iterations"], seed=s["seed"],
                                       **{k: s[k] for k in _REG_KEYS})
        self.keep = False
        self.time_spans = False
        self.kept: Dict[str, list] = {}
        self.spans: Dict[str, list] = {"search": []}
        self.counters: Dict[str, int] = {"ransac_batches": 0}
        self._saved = []
        self.fired = set()
        self._tap(greg, "estimate_normals_detailed", "normals")
        self._tap(features, "extract_fpfh_features_with_normals", "fpfh")
        self._tap(features, "match_descriptors", "match")
        self._tap(greg, "global_registration_with_features", None, span="search")
        self._tap(greg, "score_hypotheses", None, counter="ransac_batches")

    def _tap(self, module, name, kept, span=None, counter=None):
        orig = getattr(module, name)

        def tapped(*args, **kwargs):
            self.fired.add(name)
            timed = span is not None and self.time_spans
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            out = orig(*args, **kwargs)
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.spans[span].append((start, end))
            if counter is not None:
                self.counters[counter] += 1
            if kept is not None and self.keep:
                self.kept.setdefault(kept, []).append(out)
            return out

        setattr(module, name, tapped)
        self._saved.append((module, name, orig))

    @staticmethod
    def prepare(pair):
        from threecrate_tpu_torch import PointCloud

        return PointCloud.from_points(pair.source), PointCloud.from_points(pair.target)

    def call(self, inputs, keep: bool = False):
        self.keep, self.kept, self.fired = keep, {}, set()
        try:
            res = self.model(*inputs)
            pose = res.transformation.cpu()
        finally:
            self.keep = False
        missing = [name for _, name, _ in self._saved if name not in self.fired]
        if missing:
            raise RuntimeError(f"RegistrationModel called no {missing}: the check and "
                               "search_roofline_pct read these stages by name")
        if not keep:
            return pose, None
        k = self.kept
        (src_n, tgt_n), (src_f, tgt_f) = k["normals"], k["fpfh"]
        j, _, ok = k["match"][0]
        return pose, {"src_normals": src_n.normals, "src_normals_valid": src_n.valid,
                      "tgt_normals": tgt_n.normals, "tgt_normals_valid": tgt_n.valid,
                      "src_desc": src_f.descriptors, "src_desc_valid": src_f.valid,
                      "tgt_desc": tgt_f.descriptors, "tgt_desc_valid": tgt_f.valid,
                      "match_j": j, "match_ok": ok, "pose": pose, "mse": float(res.mse)}

    def close(self):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved = []
        self.model = None


def shapes(cfg: Dict, pairs) -> Dict:
    s = cfg["registration_model"]
    n_src = [p.source.shape[0] for p in pairs]
    mq = s["max_query_descriptors"]
    queries = [-(-n // -(-n // mq)) if mq and n > mq else n for n in n_src]
    return {"union_points": n_src + [p.target.shape[0] for p in pairs],
            "search_queries": queries, "search_targets": [p.target.shape[0] for p in pairs],
            "descriptor_dim": 33, "search_passes": 2 if s["mutual_check"] else 1,
            "hypothesis_batch": min(s["hypothesis_batch"], s["ransac_iterations"]),
            "correspondences": s["max_correspondences"], "k": s["k_normals"]}


def reference(pair, cfg: Dict, prec=plain.FP32, seed: int = 0) -> Dict:
    ones = torch.ones
    s = settings(cfg, seed)
    return plain.registration_model(
        pair.source, ones(pair.source.shape[0], dtype=torch.bool, device=pair.source.device),
        pair.target, ones(pair.target.shape[0], dtype=torch.bool, device=pair.target.device),
        s, prec)


def numbers(kept: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared, each 0 where program and reference agree."""
    return {
        "normals_p99_rad": max(
            compare.normals_p99_rad(kept[s + "_normals"], kept[s + "_normals_valid"],
                                    ref[s + "_normals"], ref[s + "_normals_valid"])
            for s in ("src", "tgt")),
        "fpfh_mean": max(compare.fpfh_mean(kept[s + "_desc"], kept[s + "_desc_valid"],
                                           ref[s + "_desc"], ref[s + "_desc_valid"])
                         for s in ("src", "tgt")),
        "match_mismatch": compare.match_mismatch(kept["match_j"], kept["match_ok"],
                                                 ref["match_j"], ref["match_ok"]),
        "pose_gap_m": compare.pose_gap_m(kept["pose"], ref["pose"]),
        "rms_gap_m": compare.rms_gap_m(kept["mse"], ref["mse"]),
    }
