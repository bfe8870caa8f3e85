"""Drop-in adapters for the reference python module's exact surface.

Counterpart of ``threecrate_tpu.compat``. The reference extension module
(threecrate-python/src/lib.rs:2504-2591) registers ~55 functions with
flat, scalar-argument calling conventions. The native API keeps its
config-dataclass conventions; this module provides every reference
entry-point NAME with the reference's exact signature and defaults,
adapting to the native implementations. A reference user script runs
unmodified against ``import threecrate_tpu_torch as tc``.

Two conventions meet on some names (``gicp``, ``kiss_icp``,
``ndt_registration``, ``global_registration``, ``extract_fpfh_features``,
``simplify_mesh``): the adapters dispatch on the second argument's type
(config dataclass = native, scalars = reference) so both call styles
work on the same ``tc.*`` name.

Registration results gain the reference's ``result.transformation()``
method call without losing the ``result.transformation`` field: the
adapters store the matrix as a callable host ndarray view
(:class:`_Mat4`). Only these entry points pay the device→host copy;
the native functions underneath are untouched.

Device: an ``(N, 3)`` array becomes a cloud on ``device``, the card
unless the caller asks for the CPU (``device="cpu"``), as the readers'
``device`` keyword does; a ``PointCloud`` or typed view stays where it
lies.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from .core.errors import InvalidDataError
from .core.mesh import TriangleMesh
from .core.point_cloud import PointCloud
from .core.transform import Transform
from .core.typed_clouds import ColoredPointCloud, unwrap
from .ops import features as _features
from .ops import filtering as _filtering
from .ops import gicp as _gicp_mod
from .ops import global_registration as _greg
from .ops import kiss_icp as _kiss
from .ops import mesh_smoothing as _smooth
from .ops import ndt as _ndt
from .ops import normals as _normals
from .ops import registration as _reg
from .ops import segmentation as _seg
from .io import compression as _compression
from .reconstruction import (alpha_shape, ball_pivoting, delaunay,
                             moving_least_squares, pipeline)
from . import simplification as _simpl

__all__ = [
    "IcpResult",
    "remove_statistical_outliers", "remove_radius_outliers",
    "extract_clusters",
    "smooth_mesh_laplacian", "smooth_mesh_taubin", "smooth_mesh_hc",
    "reconstruct", "ball_pivoting_reconstruct", "alpha_shape_reconstruct",
    "delaunay_triangulate", "moving_least_squares_reconstruct",
    "compress", "decompress",
    "icp", "icp_point_to_plane", "gicp", "kiss_icp", "ndt_registration",
    "global_registration", "global_registration_with_normals",
    "estimate_normals", "segment_plane", "extract_fpfh_features",
    "simplify_mesh", "colorize_point_cloud", "poisson_reconstruct",
]


# ---------------------------------------------------------------------------
# coercion helpers
# ---------------------------------------------------------------------------

def _pc(x, device="cuda") -> PointCloud:
    """PointCloud | typed view (where it lies) | (N,3) array (on
    ``device``) → PointCloud."""
    x = unwrap(x)
    if isinstance(x, PointCloud):
        return x
    return PointCloud.from_numpy(np.asarray(x), device=device)


def _looks_like_mat4(x) -> bool:
    try:
        return np.shape(x) == (4, 4)
    except Exception:
        return False


def _as_init(init_transform, init: Optional[Transform] = None
             ) -> Optional[Transform]:
    """Reference ``init_transform`` (4×4 numpy) or native ``init``."""
    if init is not None:
        return init
    if init_transform is None:
        return None
    if isinstance(init_transform, Transform):
        return init_transform
    m = np.asarray(init_transform, dtype=np.float32)
    if m.shape != (4, 4):
        raise InvalidDataError(
            f"init_transform must be a 4x4 matrix, got {m.shape}")
    return Transform.from_matrix(m)


class _Mat4(np.ndarray):
    """A 4×4 numpy matrix that is ALSO callable.

    The reference result classes expose ``transformation()`` as a
    method (lib.rs:536, :581, :622); the native NamedTuples expose it
    as a field. Storing a callable ndarray serves both call styles on
    one object.
    """

    def __call__(self) -> np.ndarray:
        return np.asarray(self)


def _callable_mat(m) -> _Mat4:
    if hasattr(m, "detach"):
        m = m.detach().cpu().numpy()
    return np.asarray(m, dtype=np.float32).view(_Mat4)


def _ref_result(res):
    """Re-wrap a registration-style NamedTuple so that
    ``transformation`` supports both field and method access."""
    return res._replace(transformation=_callable_mat(res.transformation))


# the reference's IcpResult class name; with _Mat4 the native NamedTuple
# already serves the reference surface (mse / iterations / converged
# attributes + transformation()), so the name is an alias
IcpResult = _reg.ICPResult


# ---------------------------------------------------------------------------
# filtering (lib.rs:789-822)
# ---------------------------------------------------------------------------

def remove_statistical_outliers(cloud, k_neighbors: int = 20,
                                std_ratio: float = 2.0, *,
                                device="cuda") -> PointCloud:
    """Reference name for statistical_outlier_removal (lib.rs:795-803).
    Returns the filtered cloud (outlier rows masked out)."""
    return _filtering.statistical_outlier_removal(
        _pc(cloud, device), k_neighbors, std_ratio).cloud


def remove_radius_outliers(cloud, radius: float, min_neighbors: int, *,
                           device="cuda") -> PointCloud:
    """Reference name for radius_outlier_removal (lib.rs:809-818).
    Returns the filtered cloud (outlier rows masked out)."""
    return _filtering.radius_outlier_removal(_pc(cloud, device), radius,
                                             min_neighbors).cloud


# ---------------------------------------------------------------------------
# normals (lib.rs:829-834)
# ---------------------------------------------------------------------------

def estimate_normals(cloud, k: int = 10, *, k_neighbors: Optional[int] = None,
                     device="cuda", **kw) -> PointCloud:
    """Native estimate_normals + the reference's ``k_neighbors`` kwarg."""
    if k_neighbors is not None:
        k = k_neighbors
    return _normals.estimate_normals(_pc(cloud, device), k, **kw)


# ---------------------------------------------------------------------------
# registration (lib.rs:852-1220)
# ---------------------------------------------------------------------------

def icp(source, target, max_iterations: int = 50, init_transform=None,
        *, init: Optional[Transform] = None, device="cuda",
        **kw) -> _reg.ICPResult:
    """Reference convention (lib.rs:851-866): positional max_iterations,
    optional 4×4 ``init_transform``. Extra native kwargs pass through."""
    res = _reg.icp_point_to_point(
        _pc(source, device), _pc(target, device), max_iterations,
        init=_as_init(init_transform, init), **kw)
    return _ref_result(res)


def icp_point_to_plane(source, target, max_iterations: int = 50,
                       convergence_threshold: float = 1e-6,
                       *args, init_transform=None,
                       init: Optional[Transform] = None, device="cuda",
                       **kw) -> _reg.ICPResult:
    """Reference convention (lib.rs:958-975). The reference's 4th
    positional is ``init_transform``; a 4×4 array in that slot is
    detected and treated as such."""
    if _looks_like_mat4(convergence_threshold):
        init_transform, convergence_threshold = convergence_threshold, 1e-6
    res = _reg.icp_point_to_plane(
        _pc(source, device), _pc(target, device), max_iterations,
        convergence_threshold, *args, init=_as_init(init_transform, init),
        **kw)
    return _ref_result(res)


def gicp(source, target, *args, **kw) -> _reg.ICPResult:
    """Dual-convention GICP.

    Reference (lib.rs:869-907): ``gicp(source, target,
    max_iterations=50, max_correspondence_distance=1.0,
    convergence_threshold=1e-6, k_correspondences=20,
    init_transform=None)``.
    Native: ``gicp(source, target, config=GicpConfig(), init=None)``.
    """
    device = kw.pop("device", "cuda")
    src, tgt = _pc(source, device), _pc(target, device)
    cfg = kw.pop("config", None)
    if cfg is None and args and isinstance(args[0], _gicp_mod.GicpConfig):
        cfg, args = args[0], args[1:]
    if cfg is not None:
        init = kw.pop("init", args[0] if args else None)
        return _ref_result(_gicp_mod.gicp(src, tgt, cfg, init, **kw))
    names = ("max_iterations", "max_correspondence_distance",
             "convergence_threshold", "k_correspondences")
    ref = dict(zip(names, args))
    for n in names:
        if n in kw:
            ref[n] = kw.pop(n)
    init = _as_init(kw.pop("init_transform", None), kw.pop("init", None))
    cfg = _gicp_mod.GicpConfig(**ref, **kw)
    return _ref_result(_gicp_mod.gicp(src, tgt, cfg, init))


def kiss_icp(source, target, *args, **kw) -> _reg.ICPResult:
    """Dual-convention KISS-ICP.

    Reference (lib.rs:913-951): ``kiss_icp(source, target,
    voxel_size=1.0, max_range=100.0, min_range=0.5, max_iterations=50,
    init_transform=None)``.
    Native: ``kiss_icp(source, target, config=KissIcpConfig(), init=None)``.
    """
    device = kw.pop("device", "cuda")
    src, tgt = _pc(source, device), _pc(target, device)
    cfg = kw.pop("config", None)
    if cfg is None and args and isinstance(args[0], _kiss.KissIcpConfig):
        cfg, args = args[0], args[1:]
    if cfg is not None:
        init = kw.pop("init", args[0] if args else None)
        return _ref_result(_kiss.kiss_icp(src, tgt, cfg, init, **kw))
    names = ("voxel_size", "max_range", "min_range", "max_iterations")
    ref = dict(zip(names, args))
    for n in names:
        if n in kw:
            ref[n] = kw.pop(n)
    init = _as_init(kw.pop("init_transform", None), kw.pop("init", None))
    cfg = _kiss.KissIcpConfig(**ref, **kw)
    return _ref_result(_kiss.kiss_icp(src, tgt, cfg, init))


def ndt_registration(source, target, *args, **kw) -> _ndt.NdtResult:
    """Dual-convention NDT.

    Reference (lib.rs:1160-1185): ``ndt_registration(source, target,
    init_transform=None, resolution=1.0, step_size=0.1,
    max_iterations=35, epsilon=1e-4, min_points_per_voxel=5)``.
    Native: ``ndt_registration(source, target, config=NdtConfig(),
    init=None)``.
    """
    device = kw.pop("device", "cuda")
    src, tgt = _pc(source, device), _pc(target, device)
    cfg = kw.pop("config", None)
    if cfg is None and args and isinstance(args[0], _ndt.NdtConfig):
        cfg, args = args[0], args[1:]
    if cfg is not None:
        init = kw.pop("init", args[0] if args else None)
        return _ref_result(_ndt.ndt_registration(src, tgt, cfg, init, **kw))
    # reference order leads with init_transform
    init_transform = args[0] if args else kw.pop("init_transform", None)
    args = args[1:]
    names = ("resolution", "step_size", "max_iterations", "epsilon",
             "min_points_per_voxel")
    ref = dict(zip(names, args))
    for n in names:
        if n in kw:
            ref[n] = kw.pop(n)
    init = _as_init(init_transform, kw.pop("init", None))
    cfg = _ndt.NdtConfig(**ref, **kw)
    return _ref_result(_ndt.ndt_registration(src, tgt, cfg, init))


_GREG_REF_NAMES = ("ransac_iterations", "distance_threshold",
                   "inlier_ratio", "fpfh_radius", "fpfh_k_neighbors",
                   "normal_k_neighbors", "refine_with_icp",
                   "icp_max_iterations")


def _greg_config(args, kw) -> _greg.GlobalRegistrationConfig:
    """Build a native config from reference-style global-registration
    arguments (lib.rs:1026-1060). ``fpfh_k_neighbors`` has no native
    analog (the fused FPFH is radius-limited with a fixed candidate
    cap) and is accepted for signature parity."""
    ref = dict(zip(_GREG_REF_NAMES, args))
    for n in _GREG_REF_NAMES:
        if n in kw:
            ref[n] = kw.pop(n)
    ref.pop("fpfh_k_neighbors", None)
    k_normals = ref.pop("normal_k_neighbors", None)
    if k_normals is not None:
        ref["k_normals"] = k_normals
    return _greg.GlobalRegistrationConfig(**ref, **kw)


def global_registration(source, target, *args,
                        **kw) -> _greg.GlobalRegistrationResult:
    """Dual-convention global registration (lib.rs:1026-1090)."""
    device = kw.pop("device", "cuda")
    src, tgt = _pc(source, device), _pc(target, device)
    cfg = kw.pop("config", None)
    if cfg is None and args and isinstance(
            args[0], _greg.GlobalRegistrationConfig):
        cfg, args = args[0], args[1:]
    if cfg is None:
        cfg = _greg_config(args, kw)
    return _ref_result(_greg.global_registration(src, tgt, cfg))


def global_registration_with_normals(source_normals, target_normals,
                                     source=None, target=None, *args,
                                     **kw) -> _greg.GlobalRegistrationResult:
    """Dual-convention (lib.rs:1095-1155). The reference takes the
    normal clouds first and the raw clouds after; the native path
    carries normals as attributes, so the raw clouds are optional and
    only their positions+normals matter."""
    device = kw.pop("device", "cuda")
    src = _pc(source_normals, device)
    tgt = _pc(target_normals, device)
    cfg = kw.pop("config", None)
    if cfg is None and args and isinstance(
            args[0], _greg.GlobalRegistrationConfig):
        cfg, args = args[0], args[1:]
    if cfg is None:
        # source/target may actually be the first reference scalars when
        # called with the native 2-cloud form + positionals
        if isinstance(source, (int, float)):
            args = (source, target) + args if target is not None \
                else (source,) + args
        cfg = _greg_config(args, kw)
    return _ref_result(_greg.global_registration_with_normals(src, tgt, cfg))


# ---------------------------------------------------------------------------
# features (lib.rs:1222-1246)
# ---------------------------------------------------------------------------

def extract_fpfh_features(cloud, *args, **kw):
    """Dual-convention FPFH.

    Reference (lib.rs:1222-1246): ``extract_fpfh_features(cloud,
    search_radius=0.1, k_neighbors=10)`` → ``(N, 33)`` float32 ndarray
    of the valid points' rows, on the host.
    Native: ``extract_fpfh_features(cloud, config=FpfhConfig(),
    k_normals=10)`` → FpfhResult.
    """
    src = _pc(cloud, kw.pop("device", "cuda"))
    cfg = kw.pop("config", None)
    if cfg is None and args and isinstance(args[0], _features.FpfhConfig):
        cfg, args = args[0], args[1:]
    if cfg is not None:
        return _features.extract_fpfh_features(src, cfg, *args, **kw)
    ref = dict(zip(("search_radius", "k_neighbors"), args))
    for n in ("search_radius", "k_neighbors"):
        if n in kw:
            ref[n] = kw.pop(n)
    if not ref and not kw:
        # bare native call: keep the native return type
        return _features.extract_fpfh_features(src)
    radius = ref.get("search_radius", 0.1)
    k = ref.get("k_neighbors", 10)
    res = _features.extract_fpfh_features(
        src, _features.FpfhConfig(radius=radius), k_normals=k, **kw)
    return res.descriptors[src.mask].cpu().numpy()


# ---------------------------------------------------------------------------
# segmentation (lib.rs:1256-1327)
# ---------------------------------------------------------------------------

def segment_plane(cloud, distance_threshold: float = 0.01,
                  max_iterations: int = 1000, *, threshold=None,
                  device="cuda", **kw) -> _seg.PlaneSegmentationResult:
    """Native segment_plane + the reference's ``threshold`` kwarg name
    (lib.rs:1256-1289)."""
    if threshold is not None:
        distance_threshold = threshold
    return _seg.segment_plane(_pc(cloud, device), distance_threshold,
                              max_iterations, **kw)


def extract_clusters(cloud, tolerance: float = 0.02,
                     min_cluster_size: int = 100,
                     max_cluster_size: int = 25000, *,
                     device="cuda") -> List[PointCloud]:
    """Euclidean clustering returning one compacted PointCloud per
    cluster, largest first (lib.rs:1281-1327), on the input's device."""
    src = _pc(cloud, device)
    cfg = _seg.EuclideanClusterConfig(
        tolerance=tolerance, min_cluster_size=min_cluster_size,
        max_cluster_size=max_cluster_size)
    res = _seg.extract_euclidean_clusters(src, cfg)
    labels = res.labels.cpu().numpy()
    mask = src.mask.cpu().numpy()
    pts = src.points.cpu().numpy()
    n_clusters = int(res.n_clusters)
    out = []
    for cid in range(n_clusters):  # labels are already size-ranked
        sel = mask & (labels == cid)
        if not sel.any():
            continue
        out.append(PointCloud.from_numpy(pts[sel], device=src.device))
    return out


# ---------------------------------------------------------------------------
# mesh smoothing (lib.rs:1400-1485)
# ---------------------------------------------------------------------------

def smooth_mesh_laplacian(mesh: TriangleMesh, iterations: int = 10,
                          lambda_: float = 0.5) -> TriangleMesh:
    """Reference name/convention for smooth_laplacian (lib.rs:1407-1426)."""
    return _smooth.smooth_laplacian(
        mesh, _smooth.LaplacianConfig(iterations=iterations,
                                      factor=lambda_))


def smooth_mesh_taubin(mesh: TriangleMesh, iterations: int = 10,
                       lambda_: float = 0.5,
                       mu: float = -0.53) -> TriangleMesh:
    """Reference name/convention for smooth_taubin (lib.rs:1434-1456)."""
    return _smooth.smooth_taubin(
        mesh, _smooth.TaubinConfig(iterations=iterations,
                                   lambda_factor=lambda_, mu_factor=mu))


def smooth_mesh_hc(mesh: TriangleMesh, iterations: int = 10,
                   alpha: float = 0.0, beta: float = 0.5) -> TriangleMesh:
    """Reference name/convention for smooth_hc (lib.rs:1462-1483)."""
    return _smooth.smooth_hc(
        mesh, _smooth.HcConfig(iterations=iterations, alpha=alpha,
                               beta=beta))


# ---------------------------------------------------------------------------
# simplification (lib.rs:1371-1389)
# ---------------------------------------------------------------------------

def simplify_mesh(mesh: TriangleMesh,
                  target: Union[int, float] = 0.5,
                  method: str = "quadric") -> TriangleMesh:
    """Dual-convention simplification.

    Reference (lib.rs:1381-1389): ``simplify_mesh(mesh,
    reduction_ratio=0.5)`` — a FLOAT in [0, 1] = fraction of faces to
    REMOVE. Native: an INT = target face count, plus ``method``.
    """
    if isinstance(target, float):
        if not 0.0 <= target <= 1.0:
            raise ValueError("reduction_ratio must be in [0, 1]")
        n_faces = int(mesh.face_mask.sum()) \
            if getattr(mesh, "face_mask", None) is not None \
            else len(mesh.faces)
        target = max(4, int(round(n_faces * (1.0 - target))))
    return _simpl.simplify_mesh(mesh, target, method)


# ---------------------------------------------------------------------------
# colorization (lib.rs:1588-1630)
# ---------------------------------------------------------------------------

def colorize_point_cloud(cloud, *args, **kw):
    """Dual-convention colorization.

    Reference (lib.rs:1588-1630): ``colorize_point_cloud(cloud,
    image_data, width, height, fx, fy, cx, cy, world_to_camera)`` with
    raw row-major RGB bytes → ColoredPointCloud.
    Native: ``colorize_point_cloud(cloud, view: RgbImageView, mode=...,
    default_color=...)`` → PointCloud with a colors attribute.
    """
    from .core.organized import CameraIntrinsics
    from .ops import colorization as _color
    src = _pc(cloud, kw.pop("device", "cuda"))
    if args and isinstance(args[0], _color.RgbImageView) \
            or "view" in kw:
        view = kw.pop("view", None)
        if view is None:
            view, args = args[0], args[1:]
        return _color.colorize_point_cloud(src, view, *args, **kw)
    names = ("image_data", "width", "height", "fx", "fy", "cx", "cy",
             "world_to_camera")
    ref = dict(zip(names, args))
    for n in names:
        if n in kw:
            ref[n] = kw.pop(n)
    w, h = int(ref["width"]), int(ref["height"])
    img = np.frombuffer(bytes(ref["image_data"]), np.uint8)
    if img.size != h * w * 3:
        raise InvalidDataError(
            f"image_data has {img.size} bytes, expected {h * w * 3} "
            f"for a {w}x{h} RGB image")
    view = _color.RgbImageView(
        image=img.reshape(h, w, 3),
        intrinsics=CameraIntrinsics(fx=float(ref["fx"]), fy=float(ref["fy"]),
                                    cx=float(ref["cx"]), cy=float(ref["cy"])),
        world_to_camera=np.asarray(ref["world_to_camera"], np.float32))
    # reference default: grey for points outside the image (lib.rs docs)
    out = _color.colorize_point_cloud(
        src, view, default_color=kw.pop("default_color", (0.5, 0.5, 0.5)),
        **kw)
    return ColoredPointCloud(out)


# ---------------------------------------------------------------------------
# reconstruction (lib.rs:1488-1580)
# ---------------------------------------------------------------------------

def poisson_reconstruct(cloud, *args, **kw) -> TriangleMesh:
    """Native poisson_reconstruct, accepting NormalPointCloud views
    (the reference takes a NormalPointCloud — lib.rs:1499-1511)."""
    from .reconstruction import poisson as _poisson
    return _poisson.poisson_reconstruct(_pc(cloud, kw.pop("device", "cuda")),
                                        *args, **kw)


def reconstruct(cloud, *, device="cuda") -> TriangleMesh:
    """Auto-select reconstruction (lib.rs:1488-1494)."""
    return pipeline.auto_reconstruct(_pc(cloud, device))


def ball_pivoting_reconstruct(cloud, radius: float = 0.1, *,
                              device="cuda") -> TriangleMesh:
    """Reference name for ball_pivoting_reconstruction (lib.rs:1516-1528)."""
    return ball_pivoting.ball_pivoting_reconstruction(
        _pc(cloud, device), ball_pivoting.BallPivotingConfig(radii=(radius,)))


def alpha_shape_reconstruct(cloud, alpha: float = 1.0, *,
                            device="cuda") -> TriangleMesh:
    """Reference name for alpha_shape_reconstruction (lib.rs:1533-1543)."""
    return alpha_shape.alpha_shape_reconstruction(
        _pc(cloud, device), alpha_shape.AlphaShapeConfig(alpha=alpha))


def delaunay_triangulate(cloud, *, device="cuda") -> TriangleMesh:
    """Reference name for delaunay_reconstruction (lib.rs:1548-1558)."""
    return delaunay.delaunay_reconstruction(_pc(cloud, device))


def moving_least_squares_reconstruct(cloud, *, device="cuda") -> TriangleMesh:
    """Reference name for mls_reconstruct (lib.rs:1563-1575)."""
    return moving_least_squares.mls_reconstruct(_pc(cloud, device))


# ---------------------------------------------------------------------------
# compression (lib.rs:1719-1765)
# ---------------------------------------------------------------------------

def compress(cloud, quantization_bits: int = 14, level: int = 7, *,
             device="cuda") -> bytes:
    """Reference name for the Draco-role encoder (lib.rs:1734-1755).
    ``level`` follows the reference scale (0 = fastest … 10 = best)."""
    cfg = _compression.CompressionConfig(
        position_bits=quantization_bits, level=min(int(level), 9))
    return _compression.compress_draco(_pc(cloud, device), cfg)


def decompress(data: bytes, *, device="cuda") -> PointCloud:
    """Reference name for the Draco-role decoder (lib.rs:1760-1765)."""
    return _compression.decompress_draco(data, device)
