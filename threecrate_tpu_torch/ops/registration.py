"""ICP: point-to-point, point-to-plane, batched and multiscale.

Counterpart of ``threecrate_tpu.ops.registration``: transform the
source, find correspondences, fit a step (a weighted Kabsch fit, or for
point-to-plane the damped 6x6 Chen-Medioni normal equations and the
se(3) exponential), compose, and stop when |ΔMSE| falls below the
threshold. Two correspondence paths, chosen by size as in the JAX
package:

* below ``CORRESPONDENCE_WINDOW_THRESHOLD`` source×target pairs, exact
  brute-force 1-NN (``ops.neighbors.knn``);
* above it, the static-sort search: both clouds are Morton-sorted once
  per call and every iteration matches each source tile against a
  window of ``w_tiles`` target tiles (``kernels.icp``), with a
  16x-median trimming gate; point-to-plane carries the target normals
  through the kernel as 3 payload rows.

The JAX loop is a ``lax.while_loop`` on the device. Here the loop runs
on the host: each iteration reduces its Kabsch moments (point-to-plane:
the 6x6 system and its right-hand side), MSE and match count on the
device and reads them back as ONE small tensor (one device→host sync
per iteration); the 3x3 SVD or the 6x6 solve, the pose composition and
the convergence test then run on the host in fp32, and the loop stops
at the same iteration with the same pose as the JAX one.
``multiscale_icp_point_to_point`` runs point-to-point ICP on a voxel
pyramid (``ops.filtering.voxel_grid_filter``), then at full resolution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud
from ..core.transform import Transform, se3_exp
from ..utils import padding, profiling
from . import filtering, linalg, morton, neighbors


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) on the clouds' device
    mse: torch.Tensor             # () mean squared correspondence distance
    iterations: int
    converged: bool
    correspondences: int          # valid pairs at the final iteration

    def as_transform(self) -> Transform:
        return Transform(self.transformation)


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    max_iterations: int = 50
    convergence_threshold: float = 1e-6
    max_correspondence_distance: Optional[float] = None


CORRESPONDENCE_WINDOW_THRESHOLD = 2 ** 32  # n_src · n_tgt above which the
# static-sort window search replaces brute-force 1-NN


def _prep(source: PointCloud, target: PointCloud):
    if source.capacity == 0 or target.capacity == 0:
        raise InvalidDataError("ICP requires non-empty clouds")
    if source.device != target.device:
        raise InvalidDataError("source and target must be on one device")
    return source.points, source.mask, target.points, target.mask


def auto_w_tiles(n_src: int, n_tgt: int, w_min: int = 3) -> int:
    """Static-sort window width in 128-point target tiles:
    ``ceil(n_tgt / n_src) + 2``, at least ``w_min``, at most 16."""
    ratio = n_tgt / max(n_src, 1)
    return max(w_min, min(int(math.ceil(ratio)) + 2, 16))


def auto_subsample(n_src: int) -> int:
    """Coarse-phase source tile stride ladder of the public entry."""
    if n_src >= 800_000:
        return 8
    if n_src >= 200_000:
        return 4
    if n_src >= 50_000:
        return 2
    return 1


def _use_window(source: PointCloud, target: PointCloud,
                correspondence: str) -> bool:
    if correspondence == "window":
        return True
    if correspondence == "exact":
        return False
    return source.capacity * target.capacity > CORRESPONDENCE_WINDOW_THRESHOLD


def _pad(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    out = x.new_zeros((n_pad,) + x.shape[1:])
    out[:x.shape[0]] = x
    return out


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear method) on a 1-D tensor.

    ``torch.quantile`` is not used: it interpolates with ``lerp``, which
    gives NaN where the upper neighbour is +inf (inf − inf), while jnp
    gives inf. Here the jnp formula low·(1−f) + high·f is evaluated as
    is, NaN included where it has one (f = 0 with an infinite median).
    """
    xs = torch.sort(x).values
    pos = q / 100.0 * (x.shape[0] - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    frac = pos - lo        # 0 or 0.5 for the median: exact in fp32
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def _static_corr_setup(src, src_mask, tgt, tgt_mask, init, max_d2,
                       w_tiles, tgt_extra=None, src_extra=None, tile=128,
                       tile_stride=1):
    """Static-sort correspondence: the sorts run once per call.

    ``tgt_extra`` (Nt, E): per-target payload (point-to-plane: normals)
    sorted with the target and matched through the kernel as E payload
    rows. ``src_extra`` (Ns, F): per-source payload put in source-sorted
    order once.

    Returns ``(match, src_extra_sorted)`` with ``match(t_mat) -> (moved,
    matched, ok, d2, extra)`` over the source-sorted rows (``extra`` the
    (E, Ns) matched payload, None without ``tgt_extra``); ``ok`` combines
    window validity, the trimming gate (16x the median d² of a strided
    sample, floored at (3e-6·extent)²) and the squared distance limit
    ``max_d2``. ``tile_stride > 1`` keeps every ``tile_stride``-th source
    tile (the coarse phase).
    """
    from ..kernels.icp import icp_match_tiles

    ns_pad = padding.round_up(src.shape[0], tile)
    nt_pad = max(padding.round_up(tgt.shape[0], tile), w_tiles * tile)
    src_p = _pad(src.to(torch.float32), ns_pad)
    sm_p = _pad(src_mask, ns_pad)
    tgt_p = _pad(tgt.to(torch.float32), nt_pad)
    tm_p = _pad(tgt_mask, nt_pad)

    mn_t, scale_t = morton.frame(tgt_p, tm_p)
    keys_t = morton.keys_in_frame(tgt_p, tm_p, mn_t, scale_t)
    keys_t_sorted, order_t = torch.sort(keys_t, stable=True)
    tsorted = tgt_p[order_t]
    tvf = tm_p[order_t].to(torch.float32)
    # invalid targets get SENTINEL coordinates whose d² overflows to +inf
    coords = torch.where(tvf[:, None] < 0.5, 2e19, tsorted)
    rows = [coords.T, tvf[None, :]]
    n_extra = 0 if tgt_extra is None else tgt_extra.shape[1]
    if n_extra:
        rows.append(_pad(tgt_extra.to(torch.float32), nt_pad)[order_t].T)
    tgt_packed = torch.cat(rows).contiguous()

    # the source is sorted once at its init pose, in the TARGET's lattice;
    # the rigid motion ICP applies keeps a sorted array spatially coherent
    src_init = linalg.transform_points(init, src_p)
    order_s = torch.sort(morton.keys_in_frame(src_init, sm_p, mn_t, scale_t),
                         stable=True).indices
    src_sorted = src_p[order_s]
    svf = sm_p[order_s].to(torch.float32)
    src_extra_sorted = (None if src_extra is None
                        else _pad(src_extra.to(torch.float32), ns_pad)[order_s])
    n_src_tiles = ns_pad // tile
    if tile_stride > 1:
        tile_stride = min(tile_stride, n_src_tiles)
        src_sorted = src_sorted.reshape(n_src_tiles, tile, 3)[
            ::tile_stride].reshape(-1, 3)
        svf = svf.reshape(n_src_tiles, tile)[::tile_stride].reshape(-1)
        if src_extra_sorted is not None:
            src_extra_sorted = src_extra_sorted.reshape(n_src_tiles, tile, -1)[
                ::tile_stride].reshape(-1, src_extra_sorted.shape[1])
        n_src_tiles = src_sorted.shape[0] // tile
    n_tgt_tiles = nt_pad // tile
    extent = torch.full_like(scale_t, morton.GRID) / scale_t
    noise_floor = (3e-6 * extent) ** 2

    svf_tiles = svf.reshape(n_src_tiles, tile)
    tile_w = torch.clamp_min(svf_tiles.sum(1), 1e-6)
    all_tiles = torch.ones(n_src_tiles, dtype=torch.bool, device=src.device)

    def match(t_mat):
        moved = linalg.transform_points(t_mat, src_sorted)
        # window placement: searchsorted of the tile-mean moved key
        reps = (moved.reshape(n_src_tiles, tile, 3)
                * svf_tiles[:, :, None]).sum(1) / tile_w[:, None]
        rep_keys = morton.keys_in_frame(reps, all_tiles, mn_t, scale_t)
        pos = torch.searchsorted(keys_t_sorted, rep_keys)
        blk = torch.clamp(pos // tile - (w_tiles - 1) // 2, 0,
                          max(n_tgt_tiles - w_tiles, 0)).to(torch.int32)
        src_packed = torch.cat([moved.T, svf[None, :]])
        out = icp_match_tiles(src_packed, tgt_packed, blk, tile=tile,
                              w_tiles=w_tiles)
        matched = out[0:3].T
        w_raw = out[3] > 0.5
        extra = out[4:4 + n_extra] if n_extra else None
        # exact d² from the matched coordinates
        diff = moved - matched
        d2 = torch.where(w_raw, (diff * diff).sum(1), torch.inf)
        # median over a strided ~64k sample
        stride = max(d2.shape[0] // 65536, 1)
        med = percentile(d2[::stride], 50.0)
        gate = torch.maximum(16.0 * med, noise_floor)
        ok = w_raw & (d2 <= gate) & (d2 <= max_d2)
        return moved, matched, ok, d2, extra

    return match, src_extra_sorted


@profiling.spanned("icp.setup")
def _static_matchers(src, src_mask, tgt, tgt_mask, t_host, max_d2, w_tiles,
                     subsample, tgt_extra=None, tile=128):
    """The static-sort ``match`` functions at the host pose ``t_host``:
    (every source tile, every ``subsample``-th tile or None)."""
    with profiling.host_sync("icp.setup.pose", src):
        init = t_host.to(src.device)
    full, _ = _static_corr_setup(src, src_mask, tgt, tgt_mask, init, max_d2, w_tiles,
                                 tgt_extra=tgt_extra, tile=tile)
    if subsample <= 1:
        return full, None
    coarse, _ = _static_corr_setup(src, src_mask, tgt, tgt_mask, init, max_d2, w_tiles,
                                   tgt_extra=tgt_extra, tile=tile, tile_stride=subsample)
    return full, coarse


def _icp_loop(step, t_host, max_iterations, conv_thresh, match=None,
              match_sub=None, full_iters=2):
    """The host-side loop shared by the ICP variants. ``step(t, match)
    -> (delta (4, 4), mse, n_corr)`` takes and gives host tensors; the
    loop composes ``delta @ t`` and stops after ``max_iterations`` or once
    |ΔMSE| < ``conv_thresh``. With ``match_sub``, a coarse phase runs on
    it for all but the last ``full_iters`` iterations, then ``match``
    polishes with the convergence test restarted. Returns ``(t, mse, it,
    conv, n_corr)``."""
    thresh = torch.tensor(conv_thresh, dtype=torch.float32)

    def run_loop(t_mat, it, match_fn, it_budget):
        mse = torch.tensor(torch.inf)
        conv, n_corr = False, 0
        while it < it_budget and not conv:
            with profiling.span("icp.iteration"):
                delta, new_mse, n_corr = step(t_mat, match_fn)
            profiling.count("icp.iterations")
            t_mat = linalg.fp32_matmul(delta, t_mat)
            conv = bool(torch.abs(new_mse - mse) < thresh)
            mse = new_mse
            it += 1
        return t_mat, mse, it, conv, n_corr

    if match_sub is not None and max_iterations > full_iters:
        t_host, _, it_a, _, _ = run_loop(t_host, 0, match_sub, max_iterations - full_iters)
        return run_loop(t_host, it_a, match, max_iterations)
    return run_loop(t_host, 0, match, max_iterations)


def _pose_to(t_host: torch.Tensor, device) -> torch.Tensor:
    """The host pose on ``device``. On the card the copy leaves from pinned
    memory without blocking, so an iteration's one device→host copy stays
    its only host sync."""
    if torch.device(device).type != "cuda":
        return t_host.to(device)
    return t_host.pin_memory().to(device, non_blocking=True)


def _pose_from(init: torch.Tensor) -> torch.Tensor:
    """The initial pose on the host, where the loop keeps it, in fp32."""
    with profiling.host_sync("icp.init", init):
        return init.to(dtype=torch.float32).cpu()


def _results_to(t_host: torch.Tensor, mse: torch.Tensor, device):
    """The loop's pose and mse copied to the clouds' device."""
    with profiling.host_sync("icp.result", device, 2):
        return t_host.to(device), mse.to(device)


def _limits(max_corr_dist):
    """(max distance, max d²) as Python floats holding fp32 values (the
    square an fp32 product, as the JAX package takes it): compared with
    fp32 tensors they are exact, and no host→device copy is needed."""
    mcd32 = torch.tensor(max_corr_dist, dtype=torch.float32)
    return mcd32.item(), (mcd32 * mcd32).item()


@profiling.spanned("icp")
def _icp_p2p(src, src_mask, tgt, tgt_mask, init, max_iterations,
             conv_thresh, max_corr_dist, window=False, w_tiles=3,
             tile=128, subsample=1, full_iters=2):
    """The point-to-point ICP loop. Returns ``(t_mat, mse, it, conv,
    n_corr)`` with ``t_mat`` (4, 4) and ``mse`` () on the clouds' device."""
    device = src.device
    t_host = _pose_from(init)    # the pose lives on the host
    max_corr_dist, max_d2 = _limits(max_corr_dist)
    matchers = (_static_matchers(src, src_mask, tgt, tgt_mask, t_host, max_d2, w_tiles,
                                 subsample, tile=tile) if window else (None, None))

    def step(t_mat, match_fn):
        """One iteration on the device; the Kabsch moments, mse and count
        come back in one device→host copy."""
        t_dev = _pose_to(t_mat, device)
        if window:
            moved, matched, ok, d2, _ = match_fn(t_dev)
            d2 = torch.where(ok, d2, 0.0)
        else:
            moved = linalg.transform_points(t_dev, src)
            res = neighbors.knn(tgt, tgt_mask, moved, src_mask, 1)
            dist = res.distances[:, 0]
            ok = res.mask[:, 0] & src_mask & (dist <= max_corr_dist)
            matched = tgt[res.indices[:, 0]]
            d2 = torch.where(ok, dist * dist, 0.0)
        w = ok.to(torch.float32)
        n_ok = w.sum()
        mse = d2.sum() / torch.clamp_min(n_ok, 1.0)
        host = torch.cat([linalg.kabsch_moments(moved, matched, w), mse[None], n_ok[None]])
        with profiling.host_sync("icp.moments", host):
            host = host.cpu()
        return linalg.kabsch_from_moments(host[:15]), host[15], int(host[16])

    t_host, mse, it, conv, n_corr = _icp_loop(step, t_host, max_iterations, conv_thresh,
                                              *matchers, full_iters)
    return (*_results_to(t_host, mse, device), it, conv, n_corr)


def icp_point_to_point(source: PointCloud, target: PointCloud,
                       max_iterations: int = 50,
                       convergence_threshold: float = 1e-6,
                       max_correspondence_distance: Optional[float] = None,
                       init: Optional[Transform] = None,
                       correspondence: str = "auto",
                       w_tiles: Optional[int] = None,
                       subsample: Optional[int] = None,
                       full_iters: int = 2) -> ICPResult:
    """Point-to-point ICP. ``correspondence``: "exact", "window" or
    "auto" (window above ``CORRESPONDENCE_WINDOW_THRESHOLD`` pairs);
    ``w_tiles`` None = ``auto_w_tiles``; ``subsample`` None =
    ``auto_subsample`` on the window path, the coarse-phase tile stride
    for all but the last ``full_iters`` iterations."""
    src, sm, tgt, tm = _prep(source, target)
    if w_tiles is None:
        w_tiles = auto_w_tiles(source.capacity, target.capacity)
    window = _use_window(source, target, correspondence)
    if subsample is None:
        subsample = auto_subsample(source.capacity) if window else 1
    init_m = init.matrix if init is not None else torch.eye(4)
    mcd = (max_correspondence_distance
           if max_correspondence_distance is not None else math.inf)
    t, mse, it, conv, n_corr = _icp_p2p(
        src, sm, tgt, tm, init_m, max_iterations, convergence_threshold, mcd,
        window, w_tiles=w_tiles, subsample=subsample, full_iters=full_iters)
    return ICPResult(t, mse, it, conv, n_corr)


def icp(source: PointCloud, target: PointCloud,
        max_iterations: int = 50, **kw) -> ICPResult:
    """Convenience entry: ``icp_point_to_point``."""
    return icp_point_to_point(source, target, max_iterations, **kw)


# ---------------------------------------------------------------------------
# point-to-plane
# ---------------------------------------------------------------------------

@profiling.spanned("icp")
def _icp_p2plane(src, src_mask, tgt, tgt_mask, tgt_normals, init,
                 max_iterations, conv_thresh, max_corr_dist, window=False,
                 w_tiles=3, subsample=1, full_iters=2):
    """The point-to-plane loop (Chen & Medioni): per pair the signed plane
    distance r = n·(s − q) and the row a = [s × n, n]; the 6x6 system
    Σ w aᵀa and Σ w aᵀr, the mse and the count reach the host in one copy,
    where ``solve_psd`` (damping 1e-6) and ``se3_exp`` give the step. On
    the static-sort path the target normals ride the target sort and the
    kernel's match as 3 payload rows. Returns ``(t_mat, mse, it, conv,
    n_corr)`` on the clouds' device."""
    device = src.device
    t_host = _pose_from(init)
    max_corr_dist, max_d2 = _limits(max_corr_dist)
    matchers = (_static_matchers(src, src_mask, tgt, tgt_mask, t_host, max_d2, w_tiles,
                                 subsample, tgt_extra=tgt_normals) if window else (None, None))

    def step(t_mat, match_fn):
        t_dev = _pose_to(t_mat, device)
        if window:
            moved, q, ok, _, extra = match_fn(t_dev)
            nrm = extra.T
        else:
            moved = linalg.transform_points(t_dev, src)
            res = neighbors.knn(tgt, tgt_mask, moved, src_mask, 1)
            idx = res.indices[:, 0]
            ok = res.mask[:, 0] & src_mask & (res.distances[:, 0] <= max_corr_dist)
            q, nrm = tgt[idx], tgt_normals[idx]
        w = ok.to(torch.float32)
        r = ((moved - q) * nrm).sum(1)
        a = torch.cat([torch.linalg.cross(moved, nrm), nrm], 1)
        aw = a * w[:, None]
        h = linalg.fp32_matmul(aw.T, a)
        g = -linalg.fp32_matmul(aw.T, r[:, None])[:, 0]
        n_ok = w.sum()
        mse = torch.where(ok, r * r, 0.0).sum() / torch.clamp_min(n_ok, 1.0)
        host = torch.cat([h.reshape(36), g, mse[None], n_ok[None]])
        with profiling.host_sync("icp.moments", host):
            host = host.cpu()
        xi = linalg.solve_psd(host[:36].reshape(6, 6), host[36:42], damping=1e-6)
        return se3_exp(xi), host[42], int(host[43])

    t_host, mse, it, conv, n_corr = _icp_loop(step, t_host, max_iterations, conv_thresh,
                                              *matchers, full_iters)
    return (*_results_to(t_host, mse, device), it, conv, n_corr)


def icp_point_to_plane(source: PointCloud, target: PointCloud,
                       max_iterations: int = 50,
                       convergence_threshold: float = 1e-6,
                       max_correspondence_distance: Optional[float] = None,
                       init: Optional[Transform] = None,
                       correspondence: str = "auto",
                       w_tiles: Optional[int] = None,
                       subsample: Optional[int] = None,
                       full_iters: int = 2) -> ICPResult:
    """Point-to-plane ICP; the target must carry normals
    (``estimate_normals`` first). Options as ``icp_point_to_point``."""
    if target.normals is None:
        raise InvalidDataError(
            "point-to-plane ICP requires target normals; run "
            "ops.normals.estimate_normals(target) first")
    src, sm, tgt, tm = _prep(source, target)
    if w_tiles is None:
        w_tiles = auto_w_tiles(source.capacity, target.capacity)
    window = _use_window(source, target, correspondence)
    if subsample is None:
        subsample = auto_subsample(source.capacity) if window else 1
    init_m = init.matrix if init is not None else torch.eye(4)
    mcd = (max_correspondence_distance
           if max_correspondence_distance is not None else math.inf)
    t, mse, it, conv, n_corr = _icp_p2plane(
        src, sm, tgt, tm, target.normals, init_m, max_iterations,
        convergence_threshold, mcd, window, w_tiles=w_tiles, subsample=subsample,
        full_iters=full_iters)
    return ICPResult(t, mse, it, conv, n_corr)


# ---------------------------------------------------------------------------
# batched and multiscale
# ---------------------------------------------------------------------------

def batch_icp(sources, source_masks, targets, target_masks,
              max_iterations: int = 30, convergence_threshold: float = 1e-6,
              max_correspondence_distance: Optional[float] = None,
              device=None) -> ICPResult:
    """Register B cloud pairs: sources (B, N, 3), source_masks (B, N),
    targets (B, M, 3), target_masks (B, M), tensors or numpy arrays
    (those go to ``device``, the card unless the caller asks for the
    CPU). Each pair runs the brute-force point-to-point loop from the
    identity; the results stack along a leading batch dimension
    (``iterations``, ``converged`` and ``correspondences`` as (B,)
    tensors)."""
    dev = device if device is not None else (
        sources.device if isinstance(sources, torch.Tensor) else "cuda")

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    srcs, sms = put(sources, torch.float32), put(source_masks, torch.bool)
    tgts, tms = put(targets, torch.float32), put(target_masks, torch.bool)
    mcd = (max_correspondence_distance
           if max_correspondence_distance is not None else math.inf)
    runs = [_icp_p2p(srcs[b], sms[b], tgts[b], tms[b], torch.eye(4), max_iterations,
                     convergence_threshold, mcd) for b in range(srcs.shape[0])]
    t, mse, it, conv, n_corr = zip(*runs)
    return ICPResult(torch.stack(t), torch.stack(mse),
                     torch.tensor(it, dtype=torch.int32),
                     torch.tensor(conv), torch.tensor(n_corr, dtype=torch.int32))


@dataclasses.dataclass(frozen=True)
class MultiscaleConfig:
    voxel_levels: Sequence[float] = (0.20, 0.10, 0.05)
    iterations_per_level: int = 20
    final_full_res_iterations: int = 15
    convergence_threshold: float = 1e-6


def multiscale_icp_point_to_point(source: PointCloud, target: PointCloud,
                                  config: MultiscaleConfig = MultiscaleConfig(),
                                  init: Optional[Transform] = None) -> ICPResult:
    """Point-to-point ICP on a voxel pyramid, coarse to fine (at most
    5 voxels of correspondence distance per level), then
    ``final_full_res_iterations`` at full resolution."""
    current = init
    for voxel in config.voxel_levels:
        result = icp_point_to_point(
            filtering.voxel_grid_filter(source, voxel),
            filtering.voxel_grid_filter(target, voxel),
            config.iterations_per_level, config.convergence_threshold,
            max_correspondence_distance=voxel * 5.0, init=current)
        current = result.as_transform()
    return icp_point_to_point(source, target, config.final_full_res_iterations,
                              config.convergence_threshold, init=current)
