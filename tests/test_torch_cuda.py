"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Stated tolerances: counts, radii and pass B's use_b flag bit-equal (the
kernel and the plain version evaluate the same unfused fp32 operations);
central sums within 1e-4 of the neighbourhood's scale (summation
order); icp_match outputs within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import kernels  # noqa: E402
from threecrate_tpu_torch.kernels.icp import icp_match_plain, icp_match_tiles  # noqa: E402
from threecrate_tpu_torch.kernels.knn import (  # noqa: E402
    window_union_a_plain, window_union_a_tiles, window_union_b_plain,
    window_union_b_tiles)
from threecrate_tpu_torch.ops import morton  # noqa: E402
from threecrate_tpu_torch.ops import normals as tn  # noqa: E402
from threecrate_tpu_torch.ops import registration as tr  # noqa: E402

K, TILE, BAND = 10, 256, 16

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _scan(n, seed):
    from bench import _kitti_like
    return _kitti_like(n, seed)


def _assert_sums(got, ref, valid):
    g, r = got[:, valid], ref[:, valid]
    tr_ = (r[4] + r[5] + r[6]).clamp_min(1e-30)
    s1 = (g[1:4] - r[1:4]).abs() / (tr_ * r[0].clamp_min(1)).sqrt()
    s2 = (g[4:10] - r[4:10]).abs() / tr_
    assert max(s1.max().item(), s2.max().item()) <= 1e-4


def test_union_kernels_match_plain(cuda):
    n = 16_640
    pts = torch.from_numpy(_scan(n, 0)).to(cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    mask[-100:] = False
    perm = torch.sort(morton.morton_keys(pts, mask, 0), stable=True).indices
    pa, va = pts[perm], mask[perm].float()
    a_in = (pa.T.contiguous(), va[None].contiguous(), K, TILE, BAND)
    a, ra = window_union_a_tiles(*a_in), window_union_a_plain(*a_in)
    assert torch.equal(a[0], ra[0]) and torch.equal(a[10], ra[10])
    _assert_sums(a, ra, va > 0.5)
    ob = torch.sort(morton.morton_keys(pa, va > 0.5, 1), stable=True).indices
    b_in = (pa[ob].T.contiguous(), va[ob][None].contiguous(),
            ob.to(torch.int32)[None].contiguous(), a[10][ob][None].contiguous(),
            K, TILE, BAND)
    b, rb = window_union_b_tiles(*b_in), window_union_b_plain(*b_in)
    assert torch.equal(b[0], rb[0]) and torch.equal(b[10], rb[10])
    _assert_sums(b, rb, va[ob] > 0.5)


@pytest.mark.parametrize("k", [3, 20, 40])
def test_union_kernel_other_k(cuda, k):
    """k selects another register-array size in the kernel (16/32/64)."""
    pts = torch.from_numpy(_scan(4096, 1)).to(cuda)
    mask = torch.ones(4096, dtype=torch.bool, device=cuda)
    perm = torch.sort(morton.morton_keys(pts, mask, 0), stable=True).indices
    args = (pts[perm].T.contiguous(), torch.ones(1, 4096, device=cuda), k, TILE, BAND)
    a, ra = window_union_a_tiles(*args), window_union_a_plain(*args)
    assert torch.equal(a[0], ra[0]) and torch.equal(a[10], ra[10])


@pytest.mark.parametrize("n_extra,w_tiles", [(0, 3), (3, 3), (6, 16)])
def test_icp_kernel_matches_plain(cuda, n_extra, w_tiles):
    rng = np.random.default_rng(n_extra)
    src = torch.from_numpy(np.concatenate(
        [rng.normal(0, 1, (3, 1024)), rng.uniform(0, 1, (1, 1024)) > 0.1])
        .astype(np.float32)).to(cuda)
    tgt = rng.normal(0, 1, (4 + n_extra, 4096)).astype(np.float32)
    invalid = rng.uniform(0, 1, 4096) < 0.2
    tgt[0:3, invalid] = 2e19
    tgt[3] = ~invalid
    tgt[0:3, 100] = tgt[0:3, 101]            # a duplicate target: a tie
    tgt = torch.from_numpy(tgt).to(cuda)
    ws = torch.from_numpy(rng.integers(0, 32 - w_tiles + 1, 8).astype(np.int32)).to(cuda)
    got = icp_match_tiles(src, tgt, ws, 128, w_tiles)
    ref = icp_match_plain(src, tgt, ws, 128, w_tiles)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_wrappers_count_launches(cuda):
    kernels.reset_launch_counts()
    x = torch.zeros(3, 512, device=cuda)
    v = torch.ones(1, 512, device=cuda)
    window_union_a_tiles(x, v, K, TILE, BAND)
    window_union_b_tiles(x, v, torch.zeros(1, 512, dtype=torch.int32, device=cuda),
                         torch.ones(1, 512, device=cuda), K, TILE, BAND)
    icp_match_tiles(torch.cat([x, v]), torch.cat([x, v]),
                    torch.zeros(4, dtype=torch.int32, device=cuda), 128, 3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"union_window_a": 1, "union_window_b": 1,
                                       "icp_match": 1}


def test_step_on_card_matches_cpu(cuda, monkeypatch):
    """A 16,640-point step on the kernel paths: the card's result agrees
    with the port's own CPU (plain-version) result."""
    monkeypatch.setattr(tn, "AUTO_WINDOW_THRESHOLD", 4096)
    monkeypatch.setattr(tr, "CORRESPONDENCE_WINDOW_THRESHOLD", 2 ** 20)
    src = _scan(16_640, 2)
    tgt = src + np.array([0.05, -0.03, 0.02], np.float32)
    m = np.ones(len(src), bool)
    kernels.reset_launch_counts()
    gpu = tt.PerceptionStep(max_iterations=10)(src, m, tgt, m)
    counts = kernels.launch_counts()
    assert counts["union_window_a"] == counts["union_window_b"] == 1
    assert counts["icp_match"] >= 1
    cpu = tt.PerceptionStep(max_iterations=10, device="cpu")(src, m, tgt, m)
    torch.testing.assert_close(gpu.transform.cpu(), cpu.transform, atol=1e-4, rtol=0)
    cos = (gpu.normals.cpu() * cpu.normals).sum(1)
    valid = cpu.normals.norm(dim=1) > 0
    assert (cos[valid] > np.cos(np.radians(1.0))).float().mean() >= 0.99
