"""The plain reference against the port's CPU path at small sizes (the
port's kernels run their plain PyTorch versions on the CPU)."""

import math

import pytest
import torch

from portbench import scenes
from portbench.reference import plain

N = 70_000      # above the union normals' 65,536 and ICP's 2^32 window pairs


@pytest.fixture(scope="module")
def pair():
    motion = {"of": "points", "yaw_rad": [0.0, 0.0],
              "translation_m": [[0.05, 0.05], [-0.03, -0.03], [0.02, 0.02]]}
    return scenes.make_pairs({"kind": "ring", "points": N}, motion, 1, 2 ** 31 + 7, "cpu")[0]


def ones(p):
    return torch.ones(p.shape[0], dtype=torch.bool)


def test_union_normals_match_the_port(pair):
    from threecrate_tpu_torch.ops import normals

    pts = pair.target
    vp = plain.viewpoint(pts, ones(pts))
    got = normals._estimate_window_union(pts, ones(pts), 10, vp, True)
    ref = plain.union_normals(pts, ones(pts), 10)
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_window_icp_matches_the_port(pair):
    from threecrate_tpu_torch.ops import registration

    m = ones(pair.source)
    got, mse, it, _, _ = registration._icp_p2p(pair.source, m, pair.target, m, torch.eye(4), 20,
                                               1e-6, math.inf, window=True)
    ref, ref_mse, ref_it = plain.icp(pair.source, m, pair.target, m, torch.eye(4), 20, 1e-6)
    assert it == ref_it
    assert (got.cpu() - ref).abs().max() < 1e-6
    assert scenes.pose_error(ref, pair.truth)[0] < 1e-5


def test_coarse_then_full_icp_matches_the_port(pair):
    from threecrate_tpu_torch.ops import registration

    m = ones(pair.source)
    init = scenes.pose(0.01, [0.02, 0.0, 0.0]).float()
    got, _, it, _, _ = registration._icp_p2p(pair.source, m, pair.target, m, init, 10, 1e-6,
                                             math.inf, window=True, w_tiles=3, subsample=2)
    ref, _, ref_it = plain.icp(pair.source, m, pair.target, m, init, 10, 1e-6, subsample=2)
    assert it == ref_it
    assert (got.cpu() - ref).abs().max() < 1e-5


@pytest.mark.parametrize("n", [3000, 20000])
def test_fused_fpfh_matches_the_port(n):
    from threecrate_tpu_torch.ops import features

    pts = scenes.kind("ring").ring_scan(n, torch.Generator().manual_seed(n), "cpu") * 0.05
    nrm, _, _ = plain.union_normals(pts, ones(pts), 10)
    got = features._fpfh_fused(pts, ones(pts), nrm, 0.5)
    ref = plain.fpfh(pts, ones(pts), nrm, 0.5)
    assert torch.equal(got[1], ref[1])
    assert (got[0] - ref[0]).abs().max() < 1e-3


def test_matching_matches_the_port():
    from threecrate_tpu_torch.ops import features

    g = torch.Generator().manual_seed(11)
    a, b = torch.rand(2048, 33, generator=g) * 100, torch.rand(40000, 33, generator=g) * 100
    va, vb = torch.rand(2048, generator=g) > 0.05, torch.rand(40000, generator=g) > 0.05
    j, _, ok = features.match_descriptors(a, va, b, vb, mutual=True)
    rj, _, rok = plain.match(a, va, b, vb)
    assert bool(ok.any())
    assert ((ok != rok) | (ok & (j != rj))).float().mean() < 1e-3


def test_ransac_draws_and_fits_as_the_port():
    from threecrate_tpu_torch.ops import global_registration as greg

    g = torch.Generator().manual_seed(5)
    src = torch.rand(256, 3, generator=g) * 20
    truth = scenes.pose(0.3, [1.0, -2.0, 0.5])
    tgt = scenes.apply(truth, src)
    ok = torch.rand(256, generator=g) > 0.2
    cfg = {"seed": 9, "hypothesis_batch": 64, "ransac_iterations": 128,
           "distance_threshold": 0.05, "inlier_ratio": 2.0}
    pose, count = plain.ransac(src, tgt, ok, cfg)
    gen = torch.Generator().manual_seed(9)
    best, best_count = None, -1
    for _ in range(2):
        idx = greg.sample_hypotheses(gen, ok, 64)
        t, c = greg.score_hypotheses(idx, src, tgt, ok, 0.05)
        if int(c) > best_count:
            best, best_count = t, int(c)
    assert count == best_count == int(ok.sum())
    assert (pose - best).abs().max() < 1e-5


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 1.0 + 2 ** -12, -3.0001])
    r = plain.Precision("tf32").r(x)
    assert r.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0]
    assert abs(r[4] + 3.0) < 3 * 2 ** -10
    assert plain.FP32.r(x) is x
