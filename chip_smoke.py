#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``threecrate_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. print the card (``torch.cuda.get_device_name`` and nvidia-smi's name
   and power limit); exit non-zero without CUDA;
2. build the CUDA kernels from ``threecrate_tpu_torch/csrc``;
3. compare each kernel with its plain PyTorch version on the same inputs
   at the slice's real shapes: the two union-window passes on a
   1,000,192-point Morton-sorted scan, ``icp_match`` on 1M x 1M with
   w_tiles=3 at E=0 and E=3;
4. time each kernel and its plain version (CUDA-event medians);
5. run ``PerceptionStep()`` on a 1M-point scan pair (target = source +
   (0.05, -0.03, 0.02)) with every launch counter reset just before:
   the shift must come back within 1e-3, valid normals must be unit
   length, and every kernel must have launched;
6. time that step (median of 3 after one warm-up) and its peak memory;
7. run a 2,048-point ``PerceptionStep()``, the exact-kNN path.

The last two lines are one JSON object with each kernel's launches,
error and times, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_SCAN = 1_000_000
SHIFT = np.array([0.05, -0.03, 0.02], np.float32)
# Radius and counts of the union kernels must equal the plain version's
# bit for bit: both evaluate the same unfused fp32 operations. The sums
# differ only by summation order.
SUM_REL_TOL = 1e-4      # |Δ sum| / scale of the query's neighbourhood
ICP_ABS_TOL = 1e-4      # metres, on coordinates of magnitude <= ~150 m


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def scan(n: int, seed: int) -> np.ndarray:
    from bench import _kitti_like  # numpy-only generator of the repo's bench
    return _kitti_like(n, seed)


def sorted_scan(dev):
    """Phase-3 inputs: the 1M scan padded to a multiple of 256 and
    Morton-sorted (pass A), plus the pass-B order, on the card."""
    from threecrate_tpu_torch.ops import morton
    from threecrate_tpu_torch.utils.padding import round_up

    pts = torch.from_numpy(scan(N_SCAN, 0)).to(dev)
    n_pad = round_up(N_SCAN, 256)
    p = torch.zeros((n_pad, 3), device=dev)
    p[:N_SCAN] = pts
    m = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    m[:N_SCAN] = True
    perm = torch.sort(morton.morton_keys(p, m, 0), stable=True).indices
    pa, va = p[perm], m[perm]
    row_a = torch.sort(morton.morton_keys(pa, va, 1), stable=True).indices
    return pa, va.float(), row_a


def icp_inputs(dev, n_extra: int, w_tiles: int = 3, tile: int = 128):
    """Phase-3 icp_match inputs as the static-sort ICP builds them: the
    target Morton-sorted with 2e19 sentinels on its invalid tail, the
    shifted source sorted in the target's lattice, per-tile windows from
    the tile-mean key."""
    from threecrate_tpu_torch.ops import morton
    from threecrate_tpu_torch.utils.padding import round_up

    n_pad = round_up(N_SCAN, tile)
    tgt = torch.zeros((n_pad, 3), device=dev)
    tgt[:N_SCAN] = torch.from_numpy(scan(N_SCAN, 0) + SHIFT).to(dev)
    tm = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    tm[:N_SCAN] = True
    mn, scale = morton.frame(tgt, tm)
    keys, order = torch.sort(morton.keys_in_frame(tgt, tm, mn, scale), stable=True)
    tv = tm[order].float()
    coords = torch.where(tv[:, None] < 0.5, 2e19, tgt[order])
    g = torch.Generator(device="cpu").manual_seed(1)
    extra = torch.randn((n_extra, n_pad), generator=g).to(dev)
    tgt_packed = torch.cat([coords.T, tv[None], extra]).contiguous()
    src = tgt.clone()
    src[:N_SCAN] -= torch.from_numpy(SHIFT).to(dev)
    src_sorted = src[torch.sort(morton.keys_in_frame(src, tm, mn, scale),
                                stable=True).indices]
    reps = src_sorted.reshape(-1, tile, 3).mean(1)
    rep_keys = morton.keys_in_frame(reps, torch.ones(len(reps), dtype=torch.bool,
                                                     device=dev), mn, scale)
    blk = torch.clamp(torch.searchsorted(keys, rep_keys) // tile - (w_tiles - 1) // 2,
                      0, n_pad // tile - w_tiles).to(torch.int32)
    src_packed = torch.cat([src_sorted.T, torch.ones((1, n_pad), device=dev)])
    return src_packed.contiguous(), tgt_packed, blk


def union_error(got: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor):
    """(rows 0 and 10 bit-equal fraction, max relative sum error, max abs
    error) over valid queries."""
    g, r = got[:, valid], ref[:, valid]
    exact = ((g[0] == r[0]) & (g[10] == r[10])).float().mean().item()
    tr = (r[4] + r[5] + r[6]).clamp_min(1e-30)
    scale = torch.cat([(tr * r[0].clamp_min(1)).sqrt().expand(3, -1), tr.expand(6, -1)])
    rel = ((g[1:10] - r[1:10]).abs() / scale).max().item()
    return exact, rel, (g - r).abs().max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    from threecrate_tpu_torch import kernels
    from threecrate_tpu_torch.kernels import _build
    from threecrate_tpu_torch.kernels.icp import icp_match_plain, icp_match_tiles
    from threecrate_tpu_torch.kernels.knn import (window_union_a_plain,
                                                  window_union_a_tiles,
                                                  window_union_b_plain,
                                                  window_union_b_tiles)
    from threecrate_tpu_torch.models import PerceptionStep
    from threecrate_tpu_torch.utils.profiling import median_time

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: device {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")

    log("phase 3: kernel vs plain at full size")
    k, tile, band = 10, 256, 16
    pa, va, row_a = sorted_scan(dev)
    pts_a = pa.T.contiguous()
    valid_a = va[None].contiguous()
    out_a = window_union_a_tiles(pts_a, valid_a, k, tile, band)
    ref_a = window_union_a_plain(pts_a, valid_a, k, tile, band)
    torch.cuda.synchronize()
    ea = union_error(out_a, ref_a, va > 0.5)
    log(f"  union_window_a: N={pts_a.shape[1]} cnt+radius bit-equal {ea[0]:.6f} "
        f"(need 1), sums max rel err {ea[1]:.3e} (tol {SUM_REL_TOL}), "
        f"max abs err {ea[2]:.3e}")
    check(ea[0] == 1.0 and ea[1] <= SUM_REL_TOL, "union_window_a disagrees")

    pts_b = pa[row_a].T.contiguous()
    valid_b = va[row_a][None].contiguous()
    pos_b = row_a.to(torch.int32)[None].contiguous()
    hia_b = out_a[10][row_a][None].contiguous()
    args_b = (pts_b, valid_b, pos_b, hia_b, k, tile, band)
    out_b = window_union_b_tiles(*args_b)
    ref_b = window_union_b_plain(*args_b)
    torch.cuda.synchronize()
    vb = valid_b[0] > 0.5
    eb = union_error(out_b, ref_b, vb)
    use_b_share = out_b[10][vb].mean().item()
    log(f"  union_window_b: cnt+use_b bit-equal {eb[0]:.6f} (need 1), sums max rel "
        f"err {eb[1]:.3e} (tol {SUM_REL_TOL}), max abs err {eb[2]:.3e}, "
        f"use_b share {use_b_share:.4f}")
    check(eb[0] == 1.0 and eb[1] <= SUM_REL_TOL, "union_window_b disagrees")

    icp_err = 0.0
    icp_args = {}
    for n_extra in (0, 3):
        args = icp_inputs(dev, n_extra)
        got = icp_match_tiles(*args, tile=128, w_tiles=3)
        ref = icp_match_plain(*args, tile=128, w_tiles=3)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        match_share = got[3].mean().item()
        log(f"  icp_match E={n_extra}: Ns=Nt={args[0].shape[1]} max abs err {err:.3e} "
            f"(tol {ICP_ABS_TOL}), matched share {match_share:.4f}")
        check(err <= ICP_ABS_TOL and match_share > 0.99, f"icp_match E={n_extra} disagrees")
        icp_err = max(icp_err, err)
        icp_args[n_extra] = args

    log("phase 4: kernel and plain times (CUDA-event medians)")
    times = {
        "union_window_a": (lambda: window_union_a_tiles(pts_a, valid_a, k, tile, band),
                           lambda: window_union_a_plain(pts_a, valid_a, k, tile, band)),
        "union_window_b": (lambda: window_union_b_tiles(*args_b),
                           lambda: window_union_b_plain(*args_b)),
        "icp_match": (lambda: icp_match_tiles(*icp_args[0], tile=128, w_tiles=3),
                      lambda: icp_match_plain(*icp_args[0], tile=128, w_tiles=3)),
    }
    ms = {}
    for kname, (kern, plain) in times.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = median_time(plain, warmup=1, iters=5)
        k1 = median_time(kern, warmup=1, iters=10)
        k2 = median_time(kern, warmup=0, iters=10)
        p2 = median_time(plain, warmup=0, iters=5)
        ms[kname] = (1e3 * (k1 + k2) / 2, 1e3 * (p1 + p2) / 2)
        log(f"  {kname}: kernel {1e3 * k1:.4f} / {1e3 * k2:.4f} ms, plain "
            f"{1e3 * p1:.4f} / {1e3 * p2:.4f} ms")
    del out_a, ref_a, out_b, ref_b, icp_args, times

    log("phase 5: PerceptionStep() on the 1M scan pair")
    src = scan(N_SCAN, 0)
    tgt = src + SHIFT
    mask = np.ones(N_SCAN, bool)
    step = PerceptionStep()
    kernels.reset_launch_counts()
    res = step(src, mask, tgt, mask)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    t = res.transform.cpu().numpy()
    nrm = res.normals
    norms = torch.linalg.vector_norm(nrm, dim=1)
    valid_n = norms > 0
    log(f"  launches {launches}; translation {t[:3, 3].tolist()}; mse "
        f"{res.mse.item():.3e}; valid normals {valid_n.float().mean().item():.5f}")
    check(t.shape == (4, 4) and np.isfinite(t).all(), "transform not finite")
    check(np.abs(t[:3, 3] - SHIFT).max() <= 1e-3, "shift not recovered within 1e-3")
    check(np.abs(t[:3, :3] - np.eye(3)).max() <= 1e-3, "rotation not identity")
    check(tuple(nrm.shape) == (N_SCAN, 3) and bool(torch.isfinite(nrm).all()),
          "normals not finite")
    check(valid_n.float().mean().item() > 0.99, "fewer than 99% valid normals")
    check(bool(((norms[valid_n] - 1).abs() < 1e-3).all()), "normals not unit length")
    check(launches["union_window_a"] == 1 and launches["union_window_b"] == 1,
          "union kernels not launched once each")
    check(1 <= launches["icp_match"] <= step.max_iterations,
          "icp_match not launched once per iteration")

    log("phase 6: PerceptionStep() step time on the 1M scan pair")
    torch.cuda.reset_peak_memory_stats()
    step_s = median_time(lambda: step(src, mask, tgt, mask), warmup=1, iters=3)
    peak = torch.cuda.max_memory_allocated()
    log(f"  step {1e3 * step_s:.2f} ms median of 3, {1.0 / step_s:.3f} pairs/s, "
        f"peak allocated {peak / 2**30:.3f} GiB")

    log("phase 7: PerceptionStep() on 2,048 points (exact kNN path)")
    rng = np.random.default_rng(0)
    xy = rng.uniform(-2, 2, (2048, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    small = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    shift = np.array([0.03, -0.01, 0.02], np.float32)
    m = np.ones(2048, bool)
    kernels.reset_launch_counts()
    r2 = PerceptionStep()(small, m, small + shift, m)
    t2 = r2.transform.cpu().numpy()
    n2 = torch.linalg.vector_norm(r2.normals, dim=1).cpu().numpy()
    log(f"  translation {t2[:3, 3].tolist()}, mse {r2.mse.item():.3e}, "
        f"launches {kernels.launch_counts()}")
    check(np.abs(t2[:3, 3] - shift).max() <= 5e-3, "2,048-point shift not recovered")
    check(np.allclose(n2, 1.0, atol=1e-3), "2,048-point normals not unit length")
    check(r2.mse.item() < 1e-4, "2,048-point mse too large")
    check(sum(kernels.launch_counts().values()) == 0, "exact path launched a kernel")

    src_of = {"union_window_a": ("threecrate_tpu_torch/csrc/union_window.cu",
                                 "threecrate_tpu/kernels/knn_pallas.py:564"),
              "union_window_b": ("threecrate_tpu_torch/csrc/union_window.cu",
                                 "threecrate_tpu/kernels/knn_pallas.py:600"),
              "icp_match": ("threecrate_tpu_torch/csrc/icp_match.cu",
                            "threecrate_tpu/kernels/icp_pallas.py:113")}
    errs = {"union_window_a": ea[2], "union_window_b": eb[2], "icp_match": icp_err}
    report = {"kernels": [
        {"name": kname, "route": "cuda", "source": src_of[kname][0],
         "replaces": src_of[kname][1], "launches": launches[kname],
         "max_abs_err": errs[kname], "ms": ms[kname][0], "plain_ms": ms[kname][1]}
        for kname in src_of]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
