"""PerceptionStep (normals + ICP scan-pair alignment), OdometryModel
(KISS-ICP scan-to-map odometry), RegistrationModel (global FPFH +
RANSAC initialisation, then ICP) and ReconstructionModel (outlier
filter, normals, auto reconstruction, simplification).

Counterpart of ``threecrate_tpu.models.perception.PerceptionStep``:
the target's normals (the two-window union at 65,536 points and above,
exact kNN below) and point-to-point ICP of source onto target (the
static-sort window search above 2^32 source×target pairs, brute-force
1-NN below), dispatched on the input sizes as the JAX step does. As
there, ICP matches the full source on every iteration (no coarse
subsample phase).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.point_cloud import PointCloud
from ..core.transform import Transform
from ..ops import global_registration, kiss_icp
from ..ops import normals as normals_mod
from ..ops import registration
from ..utils import profiling


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

    @profiling.spanned("perception")
    def __call__(self, src, src_mask, tgt, tgt_mask) -> PerceptionResult:
        def put(x, dtype):
            return torch.as_tensor(x).to(device=self.device, dtype=dtype)

        src, tgt = put(src, torch.float32), put(tgt, torch.float32)
        src_mask, tgt_mask = put(src_mask, torch.bool), put(tgt_mask, torch.bool)
        n_t = tgt.shape[0]
        big_cloud = n_t >= normals_mod.AUTO_WINDOW_THRESHOLD
        with profiling.span("normals"):
            mn = torch.where(tgt_mask[:, None], tgt, 3e38).amin(0)
            mx = torch.where(tgt_mask[:, None], tgt, -3e38).amax(0)
            vp = normals_mod._viewpoint(mn, mx)
            nrm, curv, _valid = normals_mod._estimate(
                tgt, tgt_mask, self.k, False, 0.0, vp, True, moments=big_cloud,
                window_merge="union" if big_cloud else "tighter")
        use_window = (src.shape[0] * n_t
                      > registration.CORRESPONDENCE_WINDOW_THRESHOLD)
        t, mse, _it, _conv, _n = registration._icp_p2p(
            src, src_mask, tgt, tgt_mask, torch.eye(4), self.max_iterations,
            self.conv_thresh, torch.inf, window=use_window)
        return PerceptionResult(t, mse, nrm, curv)


class OdometryModel:
    """Scan-to-map LiDAR odometry (KISS-ICP): feed scans, read poses.
    Counterpart of the JAX ``OdometryModel``, a thin wrapper over
    :class:`ops.kiss_icp.KissIcpOdometry`; the keyword arguments build a
    ``KissIcpConfig``.

    >>> model = OdometryModel(voxel_size=1.0)
    >>> pose = model.step(scan_cloud)   # (4, 4) world pose, a Transform
    """

    def __init__(self, **config):
        self._odom = kiss_icp.KissIcpOdometry(kiss_icp.KissIcpConfig(**config))
        self.poses = []

    def step(self, scan: PointCloud) -> Transform:
        """Register one scan; returns its world pose."""
        pose = self._odom.register_frame(scan)
        self.poses.append(pose)
        return pose

    @property
    def local_map(self):
        return self._odom.local_map


class RegistrationModel:
    """Global initialisation (FPFH + RANSAC, ``global_registration``)
    followed by point-to-point ICP refinement: counterpart of the JAX
    ``RegistrationModel``.

    >>> model = RegistrationModel(max_iterations=30, fpfh_radius=0.5)
    >>> res = model(source_cloud, target_cloud)   # an ICPResult

    The keyword arguments build a ``GlobalRegistrationConfig``; the
    clouds' device is where every step runs.
    """

    def __init__(self, max_iterations: int = 30, **global_config):
        self.max_iterations = int(max_iterations)
        self.config = global_registration.GlobalRegistrationConfig(**global_config)

    @profiling.spanned("registration")
    def __call__(self, source, target) -> registration.ICPResult:
        init = global_registration.global_registration(source, target, self.config)
        return registration.icp_point_to_point(
            source, target, max_iterations=self.max_iterations,
            init=init.as_transform())


class ReconstructionModel:
    """Points → mesh: outlier filter → normals → surface reconstruction
    (data-driven algorithm choice + fallback chain) → simplification;
    counterpart of the JAX ``ReconstructionModel`` (reference:
    pipeline.rs:814-846 auto_reconstruct).

    The filter, compaction, normals and the analysis run on the cloud's
    device, as does the picked algorithm's device work; simplification
    runs on the host."""

    def __init__(self, k: int = 10, target_faces: Optional[int] = None):
        self.k = int(k)
        self.target_faces = target_faces

    def __call__(self, cloud: PointCloud):
        from ..ops import filtering
        from ..reconstruction import pipeline as recon
        from .. import simplification

        filt = filtering.statistical_outlier_removal(cloud, k=self.k)
        clean = filt.cloud.compact()
        withn = normals_mod.estimate_normals(clean, k=self.k)
        mesh = recon.auto_reconstruct(withn)
        if self.target_faces is not None:
            mesh = simplification.simplify_mesh(mesh, self.target_faces)
        return mesh
