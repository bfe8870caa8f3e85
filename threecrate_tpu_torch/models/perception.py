"""PerceptionStep: normals + ICP scan-pair alignment.

Counterpart of ``threecrate_tpu.models.perception.PerceptionStep``:
the target's normals (the two-window union at 65,536 points and above,
exact kNN below) and point-to-point ICP of source onto target (the
static-sort window search above 2^32 source×target pairs, brute-force
1-NN below), dispatched on the input sizes as the JAX step does. As
there, ICP matches the full source on every iteration (no coarse
subsample phase).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import normals as normals_mod
from ..ops import registration


class PerceptionResult(NamedTuple):
    transform: torch.Tensor     # (4, 4) src → tgt alignment
    mse: torch.Tensor           # () final correspondence MSE
    normals: torch.Tensor       # (N, 3) target normals
    curvature: torch.Tensor     # (N,) target surface variation


class PerceptionStep:
    """>>> step = PerceptionStep(k=10, max_iterations=20, device="cuda")
    >>> res = step(src_pts, src_mask, tgt_pts, tgt_mask)

    Inputs (numpy arrays or tensors) are moved to ``device`` once; every
    tensor the step makes stays there.
    """

    def __init__(self, k: int = 10, max_iterations: int = 20,
                 conv_thresh: float = 1e-6, device="cuda"):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.conv_thresh = float(conv_thresh)
        self.device = torch.device(device)

    def __call__(self, src, src_mask, tgt, tgt_mask) -> PerceptionResult:
        def put(x, dtype):
            return torch.as_tensor(x).to(device=self.device, dtype=dtype)

        src, tgt = put(src, torch.float32), put(tgt, torch.float32)
        src_mask, tgt_mask = put(src_mask, torch.bool), put(tgt_mask, torch.bool)
        mn = torch.where(tgt_mask[:, None], tgt, 3e38).amin(0)
        mx = torch.where(tgt_mask[:, None], tgt, -3e38).amax(0)
        vp = normals_mod._viewpoint(mn, mx)
        n_t = tgt.shape[0]
        big_cloud = n_t >= normals_mod.AUTO_WINDOW_THRESHOLD
        nrm, curv, _valid = normals_mod._estimate(
            tgt, tgt_mask, self.k, False, 0.0, vp, True, moments=big_cloud,
            window_merge="union" if big_cloud else "tighter")
        use_window = (src.shape[0] * n_t
                      > registration.CORRESPONDENCE_WINDOW_THRESHOLD)
        t, mse, _it, _conv, _n = registration._icp_p2p(
            src, src_mask, tgt, tgt_mask, torch.eye(4), self.max_iterations,
            self.conv_thresh, torch.inf, window=use_window)
        return PerceptionResult(t, mse, nrm, curv)
