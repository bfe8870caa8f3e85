"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Stated tolerances: counts, radii and pass B's use_b flag bit-equal (the
kernel and the plain version evaluate the same unfused fp32 operations);
central sums within 1e-4 of the neighbourhood's scale (summation
order); icp_match's match row bit-equal, every row bit-equal where the
nearest target is unique and within 1e-6 where ties average (the plain
version sums them in a matmul); FPFH vote and count rows
(full-window and banded, also at the edge cases of the compacted pair
voting) bit-equal, the stage-2 weighted sums within
1e-4 of each point's Σ|row| (the plain version's cuBLAS matmul sums in
another order); window kNN −d², ids and coordinates
bit-equal in every slot (the same unfused d², the same order); a small
``RegistrationModel`` recovers its pose within 1e-3 on the card and on
the CPU; the window normals, outlier removal and staged FPFH agree with
the port's own CPU results (window search ids equal, distances within
1e-6 relative: the card's sqrt may round the last bit differently);
SHOT/USC moments' count row bit-equal and sums within 1e-5 of their
scale Σw·R^k, USC histograms bit-equal, SHOT histograms' count row
bit-equal and votes within 1e-5 of each query's count, also placed at
random rows (pass B written, pass A added), and two calls bit-equal; the fused
SHOT/USC entries on the card against the port's own CPU run: valid flags
equal on >= 99%, descriptor cosine >= 0.999 on >= 97% (an LRF sign vote
at its tie threshold may flip under the card's last-bit differences);
GICP, NDT and an odometry frame on the card within 1e-4 of the port's
own CPU run, Patchwork++'s ground mask equal on >= 99.9% of points;
the depth-camera slice on the card against the port's CPU run (no
kernel): dense and sparse fusion with equal block keys and weights on
>= 99.95% of voxels, tsdf within 1e-6 where both pick the same pixel;
raycasts of one volume with masks equal on >= 99.9% of pixels and depth
within 1e-5 m where both hit; ``FrameToModelOdometry`` poses within
1e-4; a depth image back-projected into an ``OrganizedPointCloud``
within 1e-6; the file-to-segments slice: every reader lands its cloud
or mesh on the card with the bits of the file, the plane scorer on
the card picks the CPU's hypothesis from the same triples (normal
within 1e-6, every count within 2 of the CPU's: the point-plane
product may round differently at the threshold), cluster labels and
``knn_grid``'s validity and ids equal to the CPU's and its distances
within an ulp (the same d², the card's sqrt), and the memory helpers
read the card; the survey-tile slice: LAS, LAZ, LAS 1.4, E57 and
``.tcz`` reads land on the card with the bits of the host read, the
streaming voxel filter's state and rows on the card equal its CPU run's
bit for bit, and colorization picks the CPU's pixel for every point with
bit-equal colours (the same elementwise fused multiply-adds); the
multi-shard points axis on meshes of the card's device repeated: the
collectives (1-D and 2-D, ppermute's zero fill) bit-equal to their CPU
run, a 4-shard ring kNN with ``neighbors.knn``'s squared distances within
2e-6 and its ids where the distances are apart, one shard's kernel-4
launch with its halos bit-equal to the plain version (and 8 launches a
call), the distributed sort on tied keys a permutation equal to the
stable sort and to its CPU run; the last of ``parallel``: the slab
TSDF's union of blocks bit-equal to the single-device fusion on the card
and its raycast within JAX's gates of the single-device one, the sharded
odometry, NDT and MLS at the CPU tests' tolerances against the CPU
mesh's run, ground, clusters, SHOT and plane RANSAC likewise, colorize
bit-equal, the x-slab multigrid within 1e-6 of max|x| of the
single-device solve; the user-facing surface: the root
adapters build their clouds from NumPy arrays on the card, launch the
native path's kernels and return the native call's bits (the FPFH rows
as a host array), ``nan_checks``, ``median_time``'s ``sync_fn`` and
``trace`` on the card, and the point splat within 1e-6 of its CPU run on
>= 99.5% of pixels, the flat and PBR rasters within 1e-5 on >= 99%.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import kernels  # noqa: E402
from threecrate_tpu_torch.kernels import fpfh, shot  # noqa: E402
from threecrate_tpu_torch.kernels.icp import icp_match_plain, icp_match_tiles  # noqa: E402
from threecrate_tpu_torch.kernels.knn import (  # noqa: E402
    window_normals_plain, window_normals_tiles, window_union_a_plain,
    window_union_a_tiles, window_union_b_plain, window_union_b_tiles)
from threecrate_tpu_torch.kernels.knn_window import (  # noqa: E402
    knn_window_plain, knn_window_tiles)
from threecrate_tpu_torch.ops import features as tf  # noqa: E402
from threecrate_tpu_torch.ops import morton  # noqa: E402
from threecrate_tpu_torch.ops import normals as tn  # noqa: E402
from threecrate_tpu_torch.ops import registration as tr  # noqa: E402
from union_clouds import spfh_inputs, union_cloud, weight_inputs  # noqa: E402

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


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("tile", [64, 256, 1024])
@pytest.mark.parametrize("k", [3, 8, 10, 16, 17, 20, 33, 40, 64])
def test_union_kernel_edges(cuda, tile, k, lattice):
    """Both passes at each register-list size (12/16/32/64) and block
    shape: duplicate points, 10% invalid columns, the first tile (no
    prev) and a last tile whose window holds k - 1 valid points; on an
    integer lattice the window's k-th often equals a halving's midpoint
    exactly."""
    pts, valid = union_cloud(4 * tile, tile, k, seed=tile + k, lattice=lattice)
    pa, va = pts.T.contiguous().to(cuda), valid.to(cuda)
    a_in = (pa.T.contiguous(), va[None].contiguous(), k, tile, BAND)
    a, ra = window_union_a_tiles(*a_in), window_union_a_plain(*a_in)
    assert torch.equal(a[0], ra[0]) and torch.equal(a[10], ra[10])
    _assert_sums(a, ra, va > 0.5)
    ob = torch.sort(morton.morton_keys(pa, va > 0.5, 1), stable=True).indices
    b_in = (pa[ob].T.contiguous(), va[ob][None].contiguous(),
            ob.to(torch.int32)[None].contiguous(), a[10][ob][None].contiguous(),
            k, tile, BAND)
    b, rb = window_union_b_tiles(*b_in), window_union_b_plain(*b_in)
    assert torch.equal(b[0], rb[0]) and torch.equal(b[10], rb[10])
    _assert_sums(b, rb, va[ob] > 0.5)


def _icp_case(cuda, n_extra, w_tiles, tile=128, ns=1024, nt=4096, seed=None):
    """Random (4, Ns) sources, 10% invalid; (4+E, Nt) targets, 20% at the
    2e19 sentinels, with a duplicate (an exact tie); random windows."""
    rng = np.random.default_rng(n_extra if seed is None else seed)
    src = torch.from_numpy(np.concatenate(
        [rng.normal(0, 1, (3, ns)), rng.uniform(0, 1, (1, ns)) > 0.1])
        .astype(np.float32)).to(cuda)
    tgt = rng.normal(0, 1, (4 + n_extra, nt)).astype(np.float32)
    invalid = rng.uniform(0, 1, nt) < 0.2
    tgt[0:3, invalid] = 2e19
    tgt[3] = ~invalid
    tgt[0:3, 100] = tgt[0:3, 101]            # a duplicate target: a tie
    tgt = torch.from_numpy(tgt).to(cuda)
    ws = torch.from_numpy(rng.integers(0, nt // tile - w_tiles + 1, ns // tile)
                          .astype(np.int32)).to(cuda)
    return src, tgt, ws


def _icp_unique(src, tgt, ws, tile, w_tiles):
    """Points whose nearest window target is unique (no exact tie)."""
    nt = tgt.shape[1]
    cols = ws.long()[:, None] * tile + torch.arange(w_tiles * tile, device=src.device)
    inside = (cols >= 0) & (cols < nt)
    pay = torch.where(inside, tgt[0:3, cols.clamp(0, nt - 1)], 2e19)  # (3, T, wc)
    q = src[0:3].reshape(3, -1, tile)
    d = [pay[r][:, None, :] - q[r][:, :, None] for r in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return ((d2 == d2.amin(2, keepdim=True)).sum(2) == 1).reshape(-1)


def _assert_icp(got, ref, unique):
    """Match flags bit-equal, every row bit-equal where the nearest target
    is unique, within 1e-6 where ties average (summation order)."""
    assert torch.equal(got[3], ref[3])
    assert torch.equal(got[:, unique], ref[:, unique])
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_extra,w_tiles", [(0, 3), (3, 3), (6, 16), (6, 3), (0, 16), (3, 4)])
def test_icp_kernel_matches_plain(cuda, n_extra, w_tiles):
    args = _icp_case(cuda, n_extra, w_tiles)
    got = icp_match_tiles(*args, 128, w_tiles)
    ref = icp_match_plain(*args, 128, w_tiles)
    _assert_icp(got, ref, _icp_unique(*args, 128, w_tiles))


@pytest.mark.parametrize("n_extra,w_tiles", [(0, 16), (3, 8)])
def test_icp_rows_body_matches_plain(cuda, n_extra, w_tiles):
    """Windows of tile 1024 whose records and payload rows exceed a
    block's shared memory run the rows body; (0, 16) is the largest
    window the wrapper accepts at E = 0."""
    args = _icp_case(cuda, n_extra, w_tiles, tile=1024, ns=4096, nt=32768)
    got = icp_match_tiles(*args, 1024, w_tiles)
    ref = icp_match_plain(*args, 1024, w_tiles)
    _assert_icp(got, ref, _icp_unique(*args, 1024, w_tiles))


@pytest.mark.parametrize("case", ["duplicates", "equidistant", "far queries", "edges"])
def test_icp_kernel_special_inputs(cuda, case):
    """Exact ties (duplicate targets; targets on a lattice around lattice
    queries), a block holding a query at the sentinel magnitude (its
    culling off; its nearest a sentinel target), and windows reaching
    past either end of the target."""
    src, tgt, ws = _icp_case(cuda, 3, 3, seed=7)
    if case == "duplicates":
        tgt[:, 1::2] = tgt[:, 0::2]
    elif case == "equidistant":
        g = torch.arange(4096, device=cuda)
        tgt[0:3] = torch.stack([g % 16, (g // 16) % 16, g // 256]).float()
        tgt[3] = 1.0
        src[0:3] = torch.randint(0, 16, (3, 1024), device=cuda).float() + 0.5
    elif case == "far queries":
        src[0:3, 5] = 3e19
        tgt[0:3, 7] = 3e19
    else:
        ws[0], ws[1] = -1, 4096 // 128 - 2
    got = icp_match_tiles(src, tgt, ws, 128, 3)
    ref = icp_match_plain(src, tgt, ws, 128, 3)
    _assert_icp(got, ref, _icp_unique(src, tgt, ws, 128, 3))
    if case in ("duplicates", "equidistant"):
        assert not _icp_unique(src, tgt, ws, 128, 3).all()


def test_wrappers_count_launches(cuda):
    kernels.reset_launch_counts()
    x = torch.zeros(3, 512, device=cuda)
    v = torch.ones(1, 512, device=cuda)
    window_union_a_tiles(x, v, K, TILE, BAND)
    window_union_b_tiles(x, v, torch.zeros(1, 512, dtype=torch.int32, device=cuda),
                         torch.ones(1, 512, device=cuda), K, TILE, BAND)
    icp_match_tiles(torch.cat([x, v]), torch.cat([x, v]),
                    torch.zeros(4, dtype=torch.int32, device=cuda), 128, 3)
    p7, p37 = torch.zeros(7, 512, device=cuda), torch.zeros(37, 512, device=cuda)
    pos = torch.zeros(1, 512, dtype=torch.int32, device=cuda)
    fpfh.spfh_a_tiles(p7, 0.1, TILE)
    fpfh.spfh_b_tiles(p7, pos, 0.1, TILE)
    fpfh.fpfh_weight_a_tiles(p37, 0.1, TILE)
    fpfh.fpfh_weight_b_tiles(p37, pos, 0.1, TILE)
    fpfh.spfh_band_a_tiles(p7, 0.1, 16, TILE)
    fpfh.spfh_band_b_tiles(torch.zeros(8, 512, device=cuda), 0.1, 16, TILE)
    knn_window_tiles(x, v, pos, 4, 128)
    p4, lrf = torch.zeros(4, 512, device=cuda), torch.zeros(9, 512, device=cuda)
    shot.shot_moments_a_tiles(p4, 0.1, 16, TILE)
    shot.shot_moments_b_tiles(torch.zeros(5, 512, device=cuda), 0.1, 16, TILE)
    shot.shot_hist_a_tiles(p7, lrf, 0.1, 16, TILE, "usc")
    shot.shot_hist_b_tiles(torch.zeros(8, 512, device=cuda), lrf, 0.1, 16, TILE)
    window_normals_tiles(x, v, K, TILE, 16)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"union_window_a": 1, "union_window_b": 1,
                                       "icp_match": 1, "spfh_a": 1, "spfh_b": 1,
                                       "fpfh_weight_a": 1, "fpfh_weight_b": 1,
                                       "spfh_band_a": 1, "spfh_band_b": 1,
                                       "knn_window": 1, "shot_moments_a": 1,
                                       "shot_moments_b": 1, "shot_hist_a": 1,
                                       "shot_hist_b": 1, "window_normals": 1}
    assert knn_window_tiles.shape_launches == {(4, False, False): 1}


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


def _fpfh_inputs(cuda, n, seed, radius=0.5):
    """Stage-1 packed rows of a kitti-like scan with the port's normals."""
    pc = tt.PointCloud.from_numpy(_scan(n, seed), pad_multiple=TILE, device=cuda)
    nrm = tn.estimate_normals_detailed(pc).normals
    pa, pb, row_a, _ = tf.fused_stage1_inputs(pc.points, pc.mask, nrm, TILE)
    return pa, pb, row_a.to(torch.int32)[None].contiguous(), radius * radius


@pytest.mark.parametrize("n,radius", [(16_640, 1.5), (70_000, 0.5)])
def test_fpfh_kernels_match_plain(cuda, n, radius):
    pa, pb, pos, r2 = _fpfh_inputs(cuda, n, 4, radius)
    sa, ra = fpfh.spfh_a_tiles(pa, r2, TILE), fpfh.spfh_a_plain(pa, r2, TILE)
    sb, rb = fpfh.spfh_b_tiles(pb, pos, r2, TILE), fpfh.spfh_b_plain(pb, pos, r2, TILE)
    assert torch.equal(sa, ra) and torch.equal(sb, rb)
    assert ra[33][pa[3] > 0.5].mean() > 5
    inv_b = torch.argsort(pos[0].long())
    raw = sa.T + sb.T[inv_b]
    spfh = raw[:, :33] / raw[:, 33:].clamp_min(1)
    p2a = torch.cat([pa[0:4], spfh.T]).contiguous()
    p2b = torch.cat([pb[0:4], spfh[pos[0].long()].T]).contiguous()
    for got, ref in ((fpfh.fpfh_weight_a_tiles(p2a, r2, TILE),
                      fpfh.fpfh_weight_a_plain(p2a, r2, TILE)),
                     (fpfh.fpfh_weight_b_tiles(p2b, pos, r2, TILE),
                      fpfh.fpfh_weight_b_plain(p2b, pos, r2, TILE))):
        assert torch.equal(got[33], ref[33])
        scale = ref[:33].abs().sum(0).clamp_min(1e-30)
        assert ((got[:33] - ref[:33]).abs().amax(0) / scale).max().item() <= 1e-4


def test_fpfh_kernels_other_tiles(cuda):
    """tile 128 and 512 (512 needs more than 48 KB of shared memory)."""
    for tile in (128, 512):
        pc = tt.PointCloud.from_numpy(_scan(8192, 5), pad_multiple=tile, device=cuda)
        nrm = tn.estimate_normals_detailed(pc).normals
        pa, pb, row_a, _ = tf.fused_stage1_inputs(pc.points, pc.mask, nrm, tile)
        pos = row_a.to(torch.int32)[None].contiguous()
        assert torch.equal(fpfh.spfh_a_tiles(pa, 0.25, tile),
                           fpfh.spfh_a_plain(pa, 0.25, tile))
        assert torch.equal(fpfh.spfh_b_tiles(pb, pos, 0.25, tile),
                           fpfh.spfh_b_plain(pb, pos, 0.25, tile))
        p2 = torch.cat([pb[0:4], torch.rand(33, pb.shape[1], device=cuda)]).contiguous()
        got, ref = fpfh.fpfh_weight_b_tiles(p2, pos, 0.25, tile), \
            fpfh.fpfh_weight_b_plain(p2, pos, 0.25, tile)
        assert torch.equal(got[33], ref[33])
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("pass_b", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("lattice", [False, True], ids=["normal", "lattice"])
@pytest.mark.parametrize("radius", [1e-4, 1.5, 100.0], ids=["none", "typical", "whole"])
@pytest.mark.parametrize("tile", [64, 256, 1024])
def test_fpfh_weight_kernel_edges(cuda, tile, radius, lattice, pass_b):
    """The weighted-sum kernels at each block shape, with a radius that
    selects nothing, a typical one and one over the whole window:
    duplicate points, 10% invalid columns, the first tile (no prev) and
    the last (no next); on an integer lattice distances tie. The count row
    is bit-equal; the sums are not held bit-equal, because the plain
    version sums by a cuBLAS matmul in its own order, and are held within
    1e-4 of each query's Σ|row|."""
    packed, pos = weight_inputs(tile, 1.0, pass_b, lattice, cuda)
    r2 = radius * radius
    if pass_b:
        got, ref = (fpfh.fpfh_weight_b_tiles(packed, pos, r2, tile),
                    fpfh.fpfh_weight_b_plain(packed, pos, r2, tile))
    else:
        got, ref = (fpfh.fpfh_weight_a_tiles(packed, r2, tile),
                    fpfh.fpfh_weight_a_plain(packed, r2, tile))
    assert torch.equal(got[33], ref[33])
    assert (ref[33].sum() == 0) == (radius < 1e-3)
    scale = ref[:33].abs().sum(0).clamp_min(1e-30)
    assert ((got[:33] - ref[:33]).abs().amax(0) / scale).max().item() <= 1e-4


def _spfh_pair(packed, pos, r2, tile):
    """(kernel rows, plain rows) of stage-1 pass A (pos None) or B."""
    if pos is None:
        return fpfh.spfh_a_tiles(packed, r2, tile), fpfh.spfh_a_plain(packed, r2, tile)
    return (fpfh.spfh_b_tiles(packed, pos, r2, tile),
            fpfh.spfh_b_plain(packed, pos, r2, tile))


@pytest.mark.parametrize("pass_b", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("radius", [1e-4, 0.4, 100.0], ids=["none", "typical", "whole"])
@pytest.mark.parametrize("tile", [8, 16, 32, 64, 256, 1024])
def test_spfh_kernel_edges(cuda, tile, radius, pass_b):
    """The SPFH histogram kernels at each block shape (tiles 8 and 16 leave
    lanes of the warp idle; at 1024 shared memory is at its largest) with
    a radius that selects nothing, a typical one and one over the whole
    window, where every lane appends on every column and the vote atomics
    collide: duplicate points (d² = 0), 10% invalid columns, the first tile
    (no prev) and the last (no next). All 34 rows bit-equal."""
    packed, pos = spfh_inputs(tile, 1.0, pass_b, device=cuda)
    got, ref = _spfh_pair(packed, pos, radius * radius, tile)
    assert torch.equal(got, ref)
    assert (ref[33].sum() == 0) == (radius < 1e-3)


@pytest.mark.parametrize("case", ["invalid tiles", "duplicates", "random pos_a"])
@pytest.mark.parametrize("tile", [16, 256])
def test_spfh_kernel_special_inputs(cuda, tile, case):
    """All 34 rows bit-equal where whole tiles are invalid, where every
    point has copies at d² <= 1e-12 (exact duplicates and offsets of one
    ulp), and in pass B with pass-A positions in a random order."""
    packed, pos = spfh_inputs(tile, 1.0, True, device=cuda)
    n = packed.shape[1]
    if case == "invalid tiles":
        packed[3, :tile] = 0.0
        packed[3, 2 * tile:4 * tile] = 0.0
    elif case == "duplicates":
        base = packed[0:3, 0:n:4]
        packed[0:3, 1:n:4] = base
        packed[0:3, 2:n:4] = torch.nextafter(base, torch.full_like(base, np.inf))
        packed[0:3, 3:n:4] = base + 2e-7
    else:
        g = torch.Generator().manual_seed(tile)
        pos = torch.randperm(n, generator=g).to(torch.int32)[None].to(cuda).contiguous()
    for r2 in (0.16, 1e4):
        for p in (None, pos):
            got, ref = _spfh_pair(packed, p, r2, tile)
            assert torch.equal(got, ref)
            assert ref[33].sum() > 0


def _band_pair(kname, packed, r2, band, tile):
    """(kernel rows, plain rows) of a banded SPFH kernel; a second call
    must give the kernel's rows bit for bit."""
    got = getattr(fpfh, kname + "_tiles")(packed, r2, band, tile)
    assert torch.equal(getattr(fpfh, kname + "_tiles")(packed, r2, band, tile), got)
    return got, getattr(fpfh, kname + "_plain")(packed, r2, band, tile)


@pytest.mark.parametrize("band,tile", [(16, 64), (64, 64), (48, 256), (256, 256), (0, 64),
                                       (1024, 1024), (1, 8), (8, 8), (16, 16), (32, 32)])
def test_band_kernels_edges(cuda, band, tile):
    """The banded SPFH kernels, which share the pair arithmetic and the
    pair queue of the full-window ones, on the edge-case clouds: all 34
    rows bit-equal and two calls bit-equal, as drawn (10% of the columns
    invalid at random), with one tile holding no valid column, and with
    every third column invalid among valid neighbours (invalid queries
    are served as any other). Tiles 8 and 16 leave lanes idle; band =
    tile = 1024 stages the widest span; band 0 selects nothing."""
    pa, _ = spfh_inputs(tile, 1.0, False, device=cuda)
    pb, pos = spfh_inputs(tile, 1.0, True, device=cuda)
    p8 = torch.cat([pb, pos.to(torch.float32)]).contiguous()
    for case in ("as drawn", "invalid tile", "invalid queries"):
        rows = {"spfh_band_a": pa.clone(), "spfh_band_b": p8.clone()}
        for packed in rows.values():
            if case == "invalid tile":
                packed[3, tile:2 * tile] = 0.0
            elif case == "invalid queries":
                packed[3] = 1.0
                packed[3, ::3] = 0.0
        for r2 in (0.16, 1e4):
            for kname, packed in rows.items():
                got, ref = _band_pair(kname, packed, r2, band, tile)
                assert torch.equal(got, ref), (case, r2, kname)
                valid = packed[3] > 0.5
                if band == 0:
                    assert ref[33].sum() == 0
                elif case == "invalid queries" and band >= 8 and r2 > 1 and "_a" in kname:
                    assert ref[33][~valid].min() > 0      # served, with valid neighbours


def test_registration_model_on_card(cuda, monkeypatch):
    """A 16,640-point RegistrationModel with every size threshold lowered,
    so all four FPFH kernels run (once per cloud), then the same on the
    CPU's plain versions: both recover the pose."""
    monkeypatch.setattr(tn, "AUTO_WINDOW_THRESHOLD", 4096)
    monkeypatch.setattr(tf, "FUSED_FPFH_THRESHOLD", 4096)
    monkeypatch.setattr(tr, "CORRESPONDENCE_WINDOW_THRESHOLD", 2 ** 20)
    tgt = _scan(16_640, 6)
    rot = tt.Transform.from_axis_angle([0, 0, 1.0], 0.35).matrix.numpy()
    shift = np.array([2.0, -1.5, 0.3], np.float32)
    src = (tgt @ rot[:3, :3].T + shift).astype(np.float32)
    cfg = dict(ransac_iterations=4096, fpfh_radius=0.5, distance_threshold=0.3,
               refine_with_icp=False, hypothesis_batch=2048)
    for dev in (cuda, torch.device("cpu")):
        kernels.reset_launch_counts()
        res = tt.RegistrationModel(max_iterations=30, **cfg)(
            tt.PointCloud.from_numpy(src, device=dev), tt.PointCloud.from_numpy(tgt, device=dev))
        counts = kernels.launch_counts()
        t = res.transformation.cpu().numpy()
        assert np.abs(t[:3, :3] @ rot[:3, :3] - np.eye(3)).max() <= 1e-3
        assert np.abs(t[:3, :3] @ shift + t[:3, 3]).max() <= 1e-2
        if dev.type == "cuda":
            assert all(counts[k] == 2 for k in ("spfh_a", "spfh_b", "fpfh_weight_a",
                                                "fpfh_weight_b", "union_window_a",
                                                "union_window_b"))
            assert counts["icp_match"] >= 1
        else:
            assert not any(counts.values())


@pytest.mark.parametrize("band,tile", [(16, 128), (48, 256), (64, 512), (0, 256), (8, 8),
                                       (16, 16), (32, 32), (1024, 1024)])
def test_band_kernels_match_plain(cuda, band, tile):
    """The banded SPFH kernels on a 20,000-point scan with its normals at
    the FPFH rungs, band 0, tiles narrower than a warp and the widest
    span: all 34 rows bit-equal, two calls bit-equal."""
    pc = tt.PointCloud.from_numpy(_scan(20_000, 7), pad_multiple=tile, device=cuda)
    nrm = tn.estimate_normals_detailed(pc).normals
    pa, pb, row_a, _ = tf.fused_stage1_inputs(pc.points, pc.mask, nrm, tile)
    p8 = torch.cat([pb, row_a.to(torch.float32)[None]]).contiguous()
    for r2 in (0.0625, 1.0):
        a, ref_a = _band_pair("spfh_band_a", pa, r2, band, tile)
        b, ref_b = _band_pair("spfh_band_b", p8, r2, band, tile)
        assert torch.equal(a, ref_a) and torch.equal(b, ref_b)
        if band >= 16:
            assert a[33].max() > 3 and b[33].max() > 0       # real neighbourhoods
        elif band == 0:
            assert a[33].max() == 0 and b[33].max() == 0


def _window_case(cuda, n, seed, tile, n_valid=None):
    """A Morton-sorted scan on the card with original ids, a duplicated
    run of points (ties), an invalid tail and, with ``n_valid``, only that
    many valid points in tiles 2-4 (queries with fewer than k candidates)."""
    n_pad = -(-n // tile) * tile
    pts = torch.zeros((n_pad, 3), device=cuda)
    pts[:n] = torch.from_numpy(_scan(n, seed)).to(cuda)
    pts[40:48] = pts[40]
    mask = torch.zeros(n_pad, dtype=torch.bool, device=cuda)
    mask[:n - 50] = True
    perm = torch.sort(morton.morton_keys(pts, mask, 0), stable=True).indices
    valid = mask[perm].float()
    if n_valid is not None:
        valid[2 * tile:5 * tile] = 0
        valid[2 * tile + torch.arange(n_valid, device=cuda) * 37] = 1
    return (pts[perm].T.contiguous(), valid[None].contiguous(),
            perm.to(torch.int32)[None].contiguous())


@pytest.mark.parametrize("k,tile,with_coords,exclude_self",
                         [(1, 128, False, False), (9, 128, False, False),
                          (10, 128, True, False), (64, 128, False, True),
                          (20, 256, True, True), (100, 64, False, False),
                          (128, 128, True, True), (40, 1024, True, False)])
def test_knn_window_kernel_matches_plain(cuda, k, tile, with_coords, exclude_self):
    for n_valid in (None, 5):
        args = _window_case(cuda, 30_000, 8, tile, n_valid)
        got = knn_window_tiles(*args, k, tile, with_coords=with_coords,
                               exclude_self=exclude_self)
        ref = knn_window_plain(*args, k, tile, with_coords=with_coords,
                               exclude_self=exclude_self)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        if n_valid is not None and k > n_valid:
            assert torch.isinf(got[0][:, 3 * tile:4 * tile]).any()


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("k,tile", [(k, tile) for tile in (8, 128, 1024)
                                    for k in (1, 9, 10, 12, 13, 16, 17, 33, 64, 128)
                                    if k <= 3 * tile])
def test_knn_window_kernel_edges(cuda, k, tile, exclude_self):
    """Each k on either side of the cut between the list and warp bodies
    (and of the list sizes) at tiles 8, 128 and 1024: tiles with fewer
    than k valid candidates, and tile 0 with -inf slots, which report
    column 0 of the clamped window (tile 0's own first column)."""
    for n_valid in (None, 5):
        pts, valid, ids = _window_case(cuda, max(12 * tile, 400) + 37, 11, tile, n_valid)
        valid[0, 3:2 * tile] = 0               # tile 0's window: 3 valid columns
        got = knn_window_tiles(pts, valid, ids, k, tile, with_coords=True,
                               exclude_self=exclude_self)
        ref = knn_window_plain(pts, valid, ids, k, tile, with_coords=True,
                               exclude_self=exclude_self)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        empty = torch.isinf(got[0][:, :tile])
        assert empty.any() == (k > 3)
        assert (got[1][:, :tile][empty] == ids[0, 0]).all()
        assert (got[2][0::3, :tile][empty] == pts[0, 0]).all()


def test_window_paths_on_card_match_cpu(cuda):
    """The window search, method="window" normals, statistical outlier
    removal and the staged window FPFH on 20,000 points, on the card and
    on the CPU (plain versions). The kernel equals its plain version and
    the rest is deterministic, so the searches agree exactly; the FPFH
    runs on one set of normals on both devices."""
    from threecrate_tpu_torch.ops import filtering as tflt
    from threecrate_tpu_torch.ops import neighbors as tnb
    pts = _scan(20_000, 9)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        kernels.reset_launch_counts()
        pc = tt.PointCloud.from_numpy(pts, device=dev)
        rnw = tnb.radius_neighbors_window(pc.points, pc.mask, 1.0, 64, exclude_self=True)
        nres = tt.estimate_normals_detailed(pc, tt.NormalEstimationConfig(method="window"))
        sor = tflt.statistical_outlier_removal(pc, method="window")
        out[dev.type] = (pc, rnw, nres, sor, kernels.launch_counts())
    (gpc, grn, gn, gs, counts), (cpc, crn, cn, cs, cpu_counts) = out["cuda"], out["cpu"]
    assert counts["knn_window"] == 6 and not any(cpu_counts.values())
    assert torch.equal(grn.indices.cpu(), crn.indices) and torch.equal(grn.mask.cpu(),
                                                                       crn.mask)
    # the same d^2; the card's sqrt may round the last bit differently
    torch.testing.assert_close(grn.distances.cpu(), crn.distances, rtol=1e-6, atol=0)
    assert torch.equal(gn.valid.cpu(), cn.valid)
    cos = (gn.normals.cpu() * cn.normals).sum(1).abs()[cn.valid]
    assert (cos >= 0.9999).float().mean() >= 0.999
    assert (gs.inlier_mask.cpu() == cs.inlier_mask).float().mean() >= 0.999
    feats = [tf._fpfh(pc.points, pc.mask, cn.normals.to(pc.device), 1.0, 64, 11, True, True)
             for pc in (gpc, cpc)]
    (gd, gv), (cd, cv) = [(d.cpu(), v.cpu()) for d, v in feats]
    assert torch.equal(gv, cv)
    # the staged FPFH is discontinuous in its inputs (the PCL frame swap
    # and the theta wrap): on this scan a one-ulp change of every normal
    # moves 6.0% of descriptors past L1 = 1 (port on the CPU), and the
    # card's atan2/sqrt/cross round differently from the CPU's
    l1 = (gd - cd).abs().sum(1)[cv]
    assert (l1 < 1.0).float().mean() >= 0.9, l1.quantile(0.9).item()
    assert l1.median() < 0.01, l1.median().item()


def _shot_inputs(cuda, n, seed, tile):
    """SHOT kernel inputs on a kitti-like scan: pass-A rows (7, N) with the
    port's normals, the pass-B rows with posA (8, N), random orthonormal
    frames in both orders, as ``_shot_fused`` packs them."""
    pc = tt.PointCloud.from_numpy(_scan(n, seed), pad_multiple=tile, device=cuda)
    nrm = tn.estimate_normals_detailed(pc).normals
    pa, pb, row_a, _ = tf.fused_stage1_inputs(pc.points, pc.mask, nrm, tile)
    p8 = torch.cat([pb, row_a.to(torch.float32)[None]]).contiguous()
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(pa.shape[1], 3, 3)))
    x, y = q[:, :, 0], q[:, :, 1]
    lrf = torch.from_numpy(np.concatenate([x, y, np.cross(x, y)], 1).T
                           .astype(np.float32)).to(cuda).contiguous()
    return pa, p8, lrf, lrf[:, row_a].contiguous()


@pytest.mark.parametrize("band,tile", [(32, 256), (16, 128), (64, 64)])
def test_shot_kernels_match_plain(cuda, band, tile):
    pa, p8, lrf, lrf_b = _shot_inputs(cuda, 20_000, 10, tile)
    for r in (0.25, 1.0):
        r2, radius = r * r, float(np.float32(r))
        for got, ref in ((shot.shot_moments_a_tiles(pa[0:4], r2, band, tile),
                          shot.shot_moments_a_plain(pa[0:4], r2, band, tile)),
                         (shot.shot_moments_b_tiles(p8[[0, 1, 2, 3, 7]].contiguous(), r2,
                                                    band, tile),
                          shot.shot_moments_b_plain(p8[[0, 1, 2, 3, 7]].contiguous(), r2,
                                                    band, tile))):
            assert torch.equal(got[10], ref[10]) and ref[10].max() > 3
            power = torch.tensor([0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 0, 3, 3, 3], device=cuda)
            scale = ref[0].clamp_min(1e-30)[None] * radius ** power[:, None]
            assert ((got - ref).abs() / scale).max().item() <= 1e-5
        for variant, dim in (("usc", 128), ("shot", 352)):
            for got, ref in ((shot.shot_hist_a_tiles(pa, lrf, r2, band, tile, variant),
                              shot.shot_hist_a_plain(pa, lrf, r2, band, tile, variant)),
                             (shot.shot_hist_b_tiles(p8, lrf_b, r2, band, tile, variant),
                              shot.shot_hist_b_plain(p8, lrf_b, r2, band, tile, variant))):
                assert torch.equal(got[dim], ref[dim])
                if variant == "usc":
                    assert torch.equal(got, ref)
                else:
                    err = (got[:dim] - ref[:dim]).abs().amax(0)
                    assert (err <= 1e-5 * ref[dim].clamp_min(1)).all()


def _assert_moments(got, ref, r2):
    """(14, N) moment rows: the count row bit-equal, sums within 1e-5 of
    Σw·R^k."""
    radius = float(np.float32(np.sqrt(np.float32(r2))))
    power = torch.tensor([0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 0, 3, 3, 3], device=ref.device)
    scale = ref[0].clamp_min(1e-30)[None] * radius ** power[:, None]
    assert torch.equal(got[10], ref[10])
    assert ((got - ref).abs() / scale).max().item() <= 1e-5


def _merged_moments(mom_a, mom_b, pa4, pb5, r2, band, tile, rows):
    """Pass B written at ``rows`` into a NaN-filled (N, 16) buffer, then
    pass A adding it: (the buffer, the merged (14, N) rows)."""
    buf = torch.full((pa4.shape[1], shot.MOMENT_ROW), float("nan"), device=pa4.device)
    assert mom_b(pb5, r2, band, tile, out=buf, rows=rows) is buf
    return buf, mom_a(pa4, r2, band, tile, plus=buf)


@pytest.mark.parametrize("case", ["default", "one tile band 0", "one tile band = tile",
                                  "band 64 tile 64", "band = tile = 1024", "wide band"])
def test_shot_moments_placed_match_plain(cuda, case):
    """Pass B placed at a random permutation of rows, then pass A adding
    them, at r = 0.25 and 1.0 (20 on the sparse one-tile and wide-band
    clouds), against the plain versions' placed modes and against the
    standalone passes gathered and summed; every row written with two
    zero pads; two calls give the same bits. "wide band" stages more than
    the kernels' shared memory allows, so the candidates are read through
    L1."""
    band, tile, n = {"default": (32, 256, 20_000), "one tile band 0": (0, 256, 200),
                     "one tile band = tile": (256, 256, 200),
                     "band 64 tile 64": (64, 64, 20_000),
                     "band = tile = 1024": (1024, 1024, 20_000),
                     "wide band": (7000, 8192, 16_000)}[case]
    pa, p8, _, _ = _shot_inputs(cuda, n, 14, tile)
    pa4, pb5 = pa[0:4].contiguous(), p8[[0, 1, 2, 3, 7]].contiguous()
    m = pa.shape[1]
    rows = torch.from_numpy(np.random.default_rng(band).permutation(m).astype(np.int32)).to(cuda)
    for r in ((0.25, 1.0) if n == 20_000 else (20.0,)):
        r2 = r * r
        got_b, got = _merged_moments(shot.shot_moments_a_tiles, shot.shot_moments_b_tiles,
                                     pa4, pb5, r2, band, tile, rows)
        again_b, again = _merged_moments(shot.shot_moments_a_tiles,
                                         shot.shot_moments_b_tiles, pa4, pb5, r2, band, tile,
                                         rows)
        ref_b, ref = _merged_moments(shot.shot_moments_a_plain, shot.shot_moments_b_plain,
                                     pa4, pb5, r2, band, tile, rows)
        assert torch.equal(got_b, again_b) and torch.equal(got, again)
        assert torch.isfinite(got_b).all() and (got_b[:, 14:] == 0).all()
        _assert_moments(got_b[:, :14].T, ref_b[:, :14].T, r2)
        _assert_moments(got, ref, r2)
        alone_a = shot.shot_moments_a_tiles(pa4, r2, band, tile)
        alone_b = shot.shot_moments_b_tiles(pb5, r2, band, tile)
        _assert_moments(got, (alone_a.T + alone_b.T[torch.argsort(rows.long())]).T, r2)
        if band == 0:
            assert (got == 0).all()
        else:
            assert ref[10].max() > 3


def _bad_moment_placements(cuda, n):
    """{case: (error, pass, keywords)} of placements the wrappers refuse on
    the card."""
    ok = torch.zeros((n, shot.MOMENT_ROW), device=cuda)
    rows = torch.arange(n, dtype=torch.int32, device=cuda)
    return {
        "out width": (ValueError, "b", dict(out=torch.zeros((n, 14), device=cuda), rows=rows)),
        "out dtype": (TypeError, "b", dict(out=ok.double(), rows=rows)),
        "out device": (ValueError, "b", dict(out=ok.cpu(), rows=rows)),
        "rows dtype": (TypeError, "b", dict(out=ok, rows=rows.long())),
        "rows length": (ValueError, "b", dict(out=ok, rows=rows[:-1])),
        "rows device": (ValueError, "b", dict(out=ok, rows=rows.cpu())),
        "rows range": (ValueError, "b", dict(out=ok, rows=rows + 1)),
        "rows negative": (ValueError, "b", dict(out=ok, rows=rows - 1)),
        "out alone": (ValueError, "b", dict(out=ok)),
        "plus width": (ValueError, "a", dict(plus=torch.zeros((n, 14), device=cuda))),
        "plus dtype": (TypeError, "a", dict(plus=ok.double())),
        "plus length": (ValueError, "a", dict(plus=ok[:-1])),
        "plus device": (ValueError, "a", dict(plus=ok.cpu())),
    }


@pytest.mark.parametrize("case", ["out width", "out dtype", "out device", "rows dtype",
                                  "rows length", "rows device", "rows range",
                                  "rows negative", "out alone", "plus width", "plus dtype",
                                  "plus length", "plus device"])
def test_shot_moments_refuse_bad_placement(cuda, case):
    n, tile = 512, 256
    err, pass_, kwargs = _bad_moment_placements(cuda, n)[case]
    fn = shot.shot_moments_a_tiles if pass_ == "a" else shot.shot_moments_b_tiles
    kernels.reset_launch_counts()
    with pytest.raises(err):
        fn(torch.zeros(4 if pass_ == "a" else 5, n, device=cuda), 0.01, 16, tile, **kwargs)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("band,tile,n", [(32, 256, 20_000), (3300, 4096, 8000)])
def test_pass_b_odd_positions_match_plain(cuda, band, tile, n):
    """Valid pass-B candidates whose pass-A position (the moments' row 4,
    the histograms' row 7) is −1, fractional, negated or NaN, queries
    included: the kernels apply the Pallas test |posA_c − posA_q| > band
    to every fp32 value, as the plain versions do (USC rows and moment and
    histogram count rows bit-equal, SHOT votes within 1e-5 of each
    query's count, moment sums within 1e-5 of Σw·R^k); at tile 4096 and
    band 3300 the SHOT histograms read through L1."""
    _, p8, _, lrf_b = _shot_inputs(cuda, n, 15, tile)
    kind = torch.from_numpy(np.random.default_rng(16).integers(0, 8, p8.shape[1])).to(cuda)
    pos = p8[7].clone()
    pos = torch.where(kind == 0, -1.0, pos)
    pos = torch.where(kind == 1, float("nan"), pos)
    pos = torch.where(kind == 2, pos + 0.5, pos)
    p8[7] = torch.where(kind == 3, -pos, pos)
    r2 = 400.0 if tile > 1024 else 0.0625
    pb5 = p8[[0, 1, 2, 3, 7]].contiguous()
    mom = shot.shot_moments_b_tiles(pb5, r2, band, tile)
    ref = shot.shot_moments_b_plain(pb5, r2, band, tile)
    _assert_moments(mom, ref, r2)
    # the repaired selection takes candidates of posA -1 that the earlier
    # test (a tag of -1 meant invalid) dropped
    p_ok = p8.clone()
    p_ok[7] = torch.where(kind == 0, float("nan"), p8[7])
    assert (ref[10] > shot.shot_moments_b_plain(
        p_ok[[0, 1, 2, 3, 7]].contiguous(), r2, band, tile)[10]).any()
    for variant, dim in (("usc", 128), ("shot", 352)):
        got = shot.shot_hist_b_tiles(p8, lrf_b, r2, band, tile, variant)
        ref = shot.shot_hist_b_plain(p8, lrf_b, r2, band, tile, variant)
        _assert_hist_rows(got.T, ref.T, dim)
        assert ref[dim].max() > 3


def _placed(hist_a, hist_b, inputs, r2, band, tile, variant, rows_a, rows_b):
    """Pass B written at ``rows_b`` into a NaN-filled query-major buffer,
    then pass A added at ``rows_a``: (after B, after A)."""
    pa, p8, lrf, lrf_b = inputs
    dim = 352 if variant == "shot" else 128
    out = torch.full((pa.shape[1], dim + 1), float("nan"), device=pa.device)
    hist_b(p8, lrf_b, r2, band, tile, variant, out=out, rows=rows_b)
    after_b = out.clone()
    hist_a(pa, lrf, r2, band, tile, variant, out=out, rows=rows_a, accumulate=True)
    return after_b, out


def _assert_hist_rows(got, ref, dim):
    """Query-major rows: the count column bit-equal, USC every row
    bit-equal, SHOT votes within 1e-5 of each query's count."""
    assert torch.equal(got[:, dim], ref[:, dim])
    if dim == 128:
        assert torch.equal(got, ref)
    else:
        err = (got[:, :dim] - ref[:, :dim]).abs().amax(1)
        assert (err <= 1e-5 * ref[:, dim].clamp_min(1)).all()


def _check_placed(inputs, r2, band, tile, seed):
    """Both placed modes at random permutations against the plain
    versions, for both variants; two kernel calls give the same bits."""
    n = inputs[0].shape[1]
    gen = np.random.default_rng(seed)
    rows_a, rows_b = (torch.from_numpy(gen.permutation(n).astype(np.int32))
                      .to(inputs[0].device) for _ in range(2))
    for variant, dim in (("usc", 128), ("shot", 352)):
        geom = (r2, band, tile, variant, rows_a, rows_b)
        got = _placed(shot.shot_hist_a_tiles, shot.shot_hist_b_tiles, inputs, *geom)
        again = _placed(shot.shot_hist_a_tiles, shot.shot_hist_b_tiles, inputs, *geom)
        ref = _placed(shot.shot_hist_a_plain, shot.shot_hist_b_plain, inputs, *geom)
        for g, a, r in zip(got, again, ref):
            assert torch.equal(g, a)
            _assert_hist_rows(g, r, dim)
    return ref


@pytest.mark.parametrize("band,tile", [(32, 256), (16, 128), (64, 64)])
def test_shot_hist_placed_match_plain(cuda, band, tile):
    """Pass B written at a random permutation of rows, pass A added at
    another, at r = 0.25 and 1.0: against the plain versions' placed
    modes; a second call gives the same bits (the SHOT votes sum in a
    fixed order)."""
    inputs = _shot_inputs(cuda, 20_000, 10, tile)
    for r in (0.25, 1.0):
        ref = _check_placed(inputs, r * r, band, tile, band)
        assert ref[1][:, -1].max() > 3                 # the SHOT count column


@pytest.mark.parametrize("case", ["one tile", "band 0", "isolated", "all invalid",
                                  "wide band"])
def test_shot_hist_edge_cases(cuda, case):
    """A cloud of one tile (a partly filled last block), band 0 (the
    query alone, never selected), queries with no candidate in radius
    (every other sorted point moved kilometres from all others),
    all-invalid rows, and a band too wide to stage for SHOT (candidates
    read through L1; USC stages above 48 KB), in both modes and
    variants, against the plain versions."""
    tile, band, r2 = 256, 32, 0.0625
    n = {"one tile": 200, "wide band": 8000}.get(case, 20_000)
    if case == "wide band":
        tile, band = 4096, 3300
    pa, p8, lrf, lrf_b = _shot_inputs(cuda, n, 13, tile)
    if case in ("one tile", "wide band"):
        r2 = 400.0         # a few thousand scan points are metres apart
    if case == "band 0":
        band = 0
    elif case == "isolated":
        col = torch.arange(pa.shape[1], device=cuda)
        shift = torch.where(col % 2 == 1, 1000.0 * col.float(), 0.0)
        pa[0:3] += shift
        p8[0:3] += shift[p8[7].long()]
    elif case == "all invalid":
        pa[3] = 0.0
        p8[3] = 0.0
    ref = _check_placed((pa, p8, lrf, lrf_b), r2, band, tile, 1)
    counts = ref[1][:, -1]
    if case in ("band 0", "all invalid"):
        assert (ref[1] == 0).all()
    elif case == "isolated":
        assert (counts == 0).sum() >= pa.shape[1] // 2 and counts.max() > 3
    else:
        assert pa.shape[1] == {"one tile": tile}.get(case, 2 * tile) and counts.max() > 3


def test_shot_entries_on_card_launch_their_kernels(cuda):
    """method="window" SHOT and USC on 20,000 points (exact normals below
    65,536 points): the four SHOT kernels once each, no other kernel; the
    card's descriptors agree with the port's CPU run."""
    pts = _scan(20_000, 11)
    cfg = tt.ShotConfig(method="window")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pc = tt.PointCloud.from_numpy(pts, device=dev)
        pc = pc.with_normals(tn.estimate_normals_detailed(pc).normals)
        for name, fn in (("shot", tt.extract_shot_features), ("usc", tt.extract_usc_features)):
            kernels.reset_launch_counts()
            res = fn(pc, cfg)
            out[dev.type, name] = (res.descriptors.cpu(), res.valid.cpu(),
                                   kernels.launch_counts())
    for name in ("shot", "usc"):
        gd, gv, counts = out["cuda", name]
        cd, cv, cpu_counts = out["cpu", name]
        assert {k: v for k, v in counts.items() if v} == {
            "shot_moments_a": 1, "shot_moments_b": 1, "shot_hist_a": 1, "shot_hist_b": 1}
        assert not any(cpu_counts.values())
        assert (gv == cv).float().mean() >= 0.99
        both = gv & cv
        cos = (gd[both] * cd[both]).sum(1)
        assert (cos >= 0.999).float().mean() >= 0.97, cos.quantile(0.03).item()


@pytest.mark.parametrize("k,band,tile", [(10, 16, 256), (10, 0, 256), (20, 0, 128),
                                         (40, 48, 64)])
def test_window_normals_kernel_matches_plain(cuda, k, band, tile):
    """Both selection bodies, at each register-list size (k 10/20/40 →
    16/32/64), on a sorted 20,000-point scan with an invalid tail and
    queries with fewer than k valid candidates."""
    args = _window_case(cuda, 20_000, 12, tile, n_valid=5)[:2]
    got = window_normals_tiles(*args, k, tile, band)
    ref = window_normals_plain(*args, k, tile, band)
    assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
    assert ref[4].max() >= k and (ref[4][3 * tile:4 * tile] < k).any()
    same = (got == ref).all(0)
    assert same.float().mean() >= 0.9999
    assert ((got[:4] - ref[:4]).abs().amax(0) <= 1e-5).float().mean() >= 0.9999


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("band", [16, 0])
@pytest.mark.parametrize("tile", [64, 1024])
@pytest.mark.parametrize("k", [3, 10, 17, 40, 64])
def test_window_normals_kernel_edges(cuda, k, tile, band, lattice):
    """Both selection bodies at each register-list size (12/16/32/64)
    and block shape on the union edge clouds: duplicate points, 10%
    invalid columns, the first tile (no prev) and a last tile whose
    window holds k - 1 valid points; on the integer lattice distances tie
    (the exact body's ties go to the lowest column)."""
    pts, valid = union_cloud(4 * tile, tile, k, seed=tile + k, lattice=lattice)
    args = (pts.to(cuda), valid[None].to(cuda))
    got = window_normals_tiles(*args, k, tile, band)
    ref = window_normals_plain(*args, k, tile, band)
    assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
    v = args[1][0] > 0.5
    assert (got[:, v] == ref[:, v]).all(0).float().mean() >= 0.9999
    assert ((got[:4, v] - ref[:4, v]).abs().amax(0) <= 1e-5).float().mean() >= 0.9999


def test_window_fast_on_card_matches_cpu(cuda):
    """method="window_fast" (two passes, pick-tighter) on 20,000 points:
    two kernel launches, the card's normals against the CPU run's."""
    pts = _scan(20_000, 13)
    cfg = tt.NormalEstimationConfig(method="window_fast")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        kernels.reset_launch_counts()
        res = tt.estimate_normals_detailed(tt.PointCloud.from_numpy(pts, device=dev), cfg)
        out[dev.type] = (res, kernels.launch_counts())
    (g, counts), (c, cpu_counts) = out["cuda"], out["cpu"]
    assert {k: v for k, v in counts.items() if v} == {"window_normals": 2}
    assert not any(cpu_counts.values())
    assert torch.equal(g.valid.cpu(), c.valid) and c.valid[:20_000].float().mean() > 0.99
    norms = g.normals[g.valid].norm(dim=1)
    assert ((norms - 1).abs() < 1e-5).all()
    cos = (g.normals.cpu() * c.normals).sum(1).abs()[c.valid]
    assert (cos >= 0.9999).float().mean() >= 0.999


def test_voxel_grid_on_card(cuda):
    """The voxel count equals a float64 numpy oracle's on the same fp32
    keys; the centroids agree with it within 1e-4 m (fp32 sums of
    coordinates up to ~200 m from the cloud minimum)."""
    pts = _scan(20_000, 14)
    pc = tt.PointCloud.from_numpy(pts, device=cuda)
    res = tt.voxel_grid_filter_detailed(pc, 0.2)
    mn = pts.min(0)
    keys = np.floor((pts - mn) / np.float32(0.2)).astype(np.int64)
    uniq, inv = np.unique(keys[:, ::-1], axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    cent = np.zeros((len(uniq), 3))
    np.add.at(cent, inv, pts.astype(np.float64))
    cent /= np.bincount(inv)[:, None]
    assert int(res.num_voxels) == len(uniq)
    got = res.cloud.points[:len(uniq)].cpu().numpy()
    assert np.abs(got - cent).max() <= 1e-4
    assert np.array_equal(res.voxel_index[:20_000].cpu().numpy(), inv)


def test_point_to_plane_on_card_matches_cpu(cuda):
    """Point-to-plane ICP on a 20,000-point pair, the static-sort path
    forced: icp_match carries the 3 normal rows; the card's pose against
    the CPU run's."""
    src = _scan(20_000, 15)
    tgt = src + np.array([0.05, -0.03, 0.02], np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t_pc = tt.PointCloud.from_numpy(tgt, device=dev)
        t_pc = t_pc.with_normals(tt.estimate_normals_detailed(t_pc).normals)
        kernels.reset_launch_counts()
        res = tt.ops.registration.icp_point_to_plane(
            tt.PointCloud.from_numpy(src, device=dev), t_pc, max_iterations=15,
            correspondence="window")
        out[dev.type] = (res.transformation.cpu(), kernels.launch_counts())
    (g, counts), (c, _) = out["cuda"], out["cpu"]
    assert 1 <= counts["icp_match"] <= 15
    torch.testing.assert_close(g, c, atol=1e-4, rtol=0)
    assert np.abs(g[:3, 3].numpy() - [0.05, -0.03, 0.02]).max() <= 1e-3


def test_union_kernels_k20_match_plain(cuda):
    """GICP's shape: both union passes at k = 20 (band 16 widened to 20,
    the KMAX = 32 instantiation) on 65,536 sorted scan points."""
    n = 65_536
    pts = torch.from_numpy(_scan(n, 21)).to(cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    mask[-300:] = False
    perm = torch.sort(morton.morton_keys(pts, mask, 0), stable=True).indices
    pa, va = pts[perm], mask[perm].float()
    a_in = (pa.T.contiguous(), va[None].contiguous(), 20, TILE, BAND)
    a, ra = window_union_a_tiles(*a_in), window_union_a_plain(*a_in)
    assert torch.equal(a[0], ra[0]) and torch.equal(a[10], ra[10])
    _assert_sums(a, ra, va > 0.5)
    ob = torch.sort(morton.morton_keys(pa, va > 0.5, 1), stable=True).indices
    b_in = (pa[ob].T.contiguous(), va[ob][None].contiguous(),
            ob.to(torch.int32)[None].contiguous(), a[10][ob][None].contiguous(), 20, TILE, BAND)
    b, rb = window_union_b_tiles(*b_in), window_union_b_plain(*b_in)
    assert torch.equal(b[0], rb[0]) and torch.equal(b[10], rb[10])
    _assert_sums(b, rb, va[ob] > 0.5)


def _pair_on(dev, n, seed):
    src = _scan(n, seed)
    return (tt.PointCloud.from_numpy(src, device=dev),
            tt.PointCloud.from_numpy(src + np.array([0.05, -0.03, 0.02], np.float32), device=dev))


def test_gicp_on_card_matches_cpu(cuda):
    """GICP on a 20,000-point scan pair, the window paths forced: the union
    kernels at k = 20 twice, icp_match with six payload rows once an
    iteration; the card's pose within 1e-4 of the CPU run's."""
    cfg = tt.GicpConfig(max_iterations=10, method="window", subsample=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        kernels.reset_launch_counts()
        res = tt.ops.gicp.gicp(*_pair_on(dev, 20_000, 22), cfg)
        out[dev.type] = (res, kernels.launch_counts())
    (g, counts), (c, _) = out["cuda"], out["cpu"]
    assert counts["union_window_a"] == counts["union_window_b"] == 2
    assert counts["icp_match"] == g.iterations
    torch.testing.assert_close(g.transformation.cpu(), c.transformation, atol=1e-4, rtol=0)
    assert np.abs(g.transformation[:3, 3].cpu().numpy() - [0.05, -0.03, 0.02]).max() <= 1e-3


def test_ndt_on_card_matches_cpu(cuda):
    """NDT (2 m cells) on a 20,000-point scan pair: no kernel; the card's
    pose within 1e-4 of the CPU run's, the same iteration count."""
    cfg = tt.NdtConfig(resolution=2.0, max_iterations=20)
    g = tt.ops.ndt.ndt_registration(*_pair_on(cuda, 20_000, 23), cfg)
    c = tt.ops.ndt.ndt_registration(*_pair_on(torch.device("cpu"), 20_000, 23), cfg)
    torch.testing.assert_close(g.transformation.cpu(), c.transformation, atol=1e-4, rtol=0)
    assert g.iterations == c.iterations
    assert abs(g.score.item() - c.score.item()) <= 1e-4 * abs(c.score.item())


def test_ground_on_card_matches_cpu(cuda):
    """Patchwork++ on a 100,000-point scan lowered by the sensor height:
    ground masks equal on >= 99.9% of points, patch_valid on >= 99%."""
    pts = _scan(100_000, 24)
    pts[:, 2] -= 1.723
    g = tt.patchwork_plus_plus(tt.PointCloud.from_numpy(pts, device=cuda))
    c = tt.patchwork_plus_plus(tt.PointCloud.from_numpy(pts, device="cpu"))
    assert (g.ground_mask.cpu() == c.ground_mask).float().mean().item() >= 0.999
    assert (g.patch_valid.cpu() == c.patch_valid).float().mean().item() >= 0.99
    assert c.patch_valid.sum().item() > 100


def test_odometry_frame_on_card_matches_cpu(cuda):
    """Two OdometryModel frames of a 100,000-point scan, the sensor moved
    0.3 m: the static-sort path (1e10 pairs), icp_match on the card; the
    second pose within 1e-4 of the CPU run's."""
    pts = _scan(100_000, 25)
    poses, launches = {}, 0
    for dev in (cuda, torch.device("cpu")):
        model = tt.OdometryModel()
        for f in range(2):
            kernels.reset_launch_counts()
            pose = model.step(tt.PointCloud.from_numpy(pts - np.float32([0.3 * f, 0, 0]),
                                                       device=dev))
            if dev.type == "cuda":
                launches += kernels.launch_counts()["icp_match"]
        poses[dev.type] = pose.matrix.cpu()
    assert launches >= 1
    torch.testing.assert_close(poses["cuda"], poses["cpu"], atol=1e-4, rtol=0)


def _wavy(h=120, w=160, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (2.0 + 0.3 * np.sin(xx / 20.0) * np.cos(yy / 15.0)
            + 0.005 * rng.normal(0, 1, (h, w))).astype(np.float32)


def _tilted(i):
    return tt.Transform.from_euler_xyz(torch.tensor([0.01 * i, -0.02 * i, 0.015 * i]),
                                       torch.tensor([0.02 * i, -0.01 * i, 0.03 * i])).matrix


def _same_pixels(g, c):
    """Share of voxels with equal weights, and the tsdf on them."""
    same = g.weight.cpu() == c.weight
    torch.testing.assert_close(g.tsdf.cpu()[same], c.tsdf[same], atol=1e-6, rtol=0)
    return same.float().mean().item()


def test_tsdf_on_card_matches_cpu(cuda):
    """Three tilted frames fused into a 64³ volume, then the banded
    extraction of the CPU's volume on both devices."""
    intr = np.array([130.0, 130.0, 80.0, 60.0], np.float32)
    vols = []
    for dev in (cuda, torch.device("cpu")):
        v = tt.create_tsdf_volume((64, 64, 64), 4.0 / 64, origin=(-2.0, -2.0, 0.5), device=dev)
        for i in range(3):
            v = tt.tsdf_integrate(v, _wavy(), intr, _tilted(i))
        vols.append(v)
    assert vols[0].tsdf.device.type == cuda.type
    assert _same_pixels(*vols) >= 0.9995
    c = vols[1]
    g = tt.TsdfVolume(*(x.to(cuda) for x in c[:2]), None, *(x.to(cuda) for x in c[3:]))
    sc, sg = tt.tsdf_extract_surface_banded(c), tt.tsdf_extract_surface_banded(g)
    assert int(sc.count) == int(sg.count) > 1000
    torch.testing.assert_close(sg.cloud.points.cpu(), sc.cloud.points, atol=1e-6, rtol=0)


def test_sparse_tsdf_on_card_matches_cpu(cuda):
    """The same frames into an 8³-block sparse grid (512 blocks), with
    colour: keys and n_blocks equal, weights on >= 99.95% of voxels."""
    intr = np.array([130.0, 130.0, 80.0, 60.0], np.float32)
    rgb = np.random.default_rng(3).uniform(0, 1, (120, 160, 3)).astype(np.float32)
    vols = []
    for dev in (cuda, torch.device("cpu")):
        v = tt.create_sparse_tsdf_volume(4.0 / 64, origin=(-2.0, -2.0, 0.5), grid_blocks=(8, 8, 8),
                                         max_blocks=512, with_color=True, device=dev)
        for i in range(3):
            v = tt.sparse_tsdf_integrate(v, _wavy(), intr, _tilted(i), grid_blocks=(8, 8, 8),
                                         rgb=rgb)
        vols.append(v)
    g, c = vols
    assert int(g.n_blocks) == int(c.n_blocks) > 50
    assert torch.equal(g.block_keys.cpu(), c.block_keys)
    assert _same_pixels(g, c) >= 0.9995
    same = (g.weight.cpu() == c.weight)[..., None].expand_as(c.color)
    torch.testing.assert_close(g.color.cpu()[same], c.color[same], atol=1e-6, rtol=0)


@pytest.mark.parametrize("materialize", [True, False])
def test_raycast_on_card_matches_cpu(cuda, materialize):
    """One sparse volume (fused on the CPU) raycast from a tilted pose on
    both devices, and the dense raycast of its dense copy."""
    intr = np.array([130.0, 130.0, 80.0, 60.0], np.float32)
    c = tt.create_sparse_tsdf_volume(4.0 / 64, origin=(-2.0, -2.0, 0.5), grid_blocks=(8, 8, 8),
                                     max_blocks=512, device="cpu")
    c = tt.sparse_tsdf_integrate(c, _wavy(), intr, np.eye(4, dtype=np.float32),
                                 grid_blocks=(8, 8, 8))
    g = tt.SparseTsdfVolume(*(x.to(cuda) for x in c[:7]), None)
    kw = dict(grid_blocks=(8, 8, 8), near=0.6, far=4.0, materialize=materialize)
    pose = _tilted(1)
    out = [tt.sparse_tsdf_raycast(v, intr, pose, 120, 160, **kw) for v in (g, c)]
    d = tt.sparse_tsdf_to_dense(c, (8, 8, 8))
    out += [tt.tsdf_raycast(v, intr, pose, 120, 160, near=0.6, far=4.0)
            for v in (tt.TsdfVolume(*(x.to(cuda) if x is not None else None for x in d)), d)]
    for rg, rc in (out[:2], out[2:]):
        both = rg.mask.cpu() & rc.mask
        assert (rg.mask.cpu() == rc.mask).float().mean().item() >= 0.999
        assert both.float().mean().item() > 0.5
        torch.testing.assert_close(rg.depth.cpu()[both], rc.depth[both], atol=1e-5, rtol=0)


def test_frame_to_model_on_card_matches_cpu(cuda):
    """FrameToModelOdometry (16³ blocks of 8 at 1/32 m) over four 60×80
    frames of the JAX test's wavy scene rendered from a moving pose: the
    card's poses within 1e-4 of the CPU run's, volume and pose on the
    device asked for."""
    h, w = 60, 80
    intr = np.array([70.0, 70.0, w / 2 - 0.5, h / 2 - 0.5], np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    d0 = (2.0 + 0.3 * np.sin(xx / 10.0) * np.cos(yy / 7.0) + 0.1 * np.sin(yy / 5.0)
          ).astype(np.float32)
    kw = dict(voxel_size=4.0 / 128, origin=(-2.0, -2.0, 0.5), grid_blocks=(16, 16, 16),
              max_blocks=4096, config=tt.FrameToModelConfig(near=0.6, far=4.0))
    master = tt.FrameToModelOdometry(intr, h, w, device="cpu", **kw)
    master.register_frame(d0)
    frames = [d0] + [master.render(tt.Transform.from_euler_xyz(
        torch.tensor([0.008 * i, -0.005 * i, 0.0]),
        torch.tensor([0.012 * i, -0.008 * i, 0.015 * i])).matrix).depth.numpy()
        for i in range(1, 4)]
    poses = []
    for dev in (cuda, torch.device("cpu")):
        odo = tt.FrameToModelOdometry(intr, h, w, device=dev, **kw)
        poses.append([odo.register_frame(f).matrix.cpu() for f in frames])
        assert odo.volume.tsdf.device.type == odo.pose.device.type == dev.type
    for g, c in zip(*poses):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=0)


def test_organized_and_transform_on_card_match_cpu(cuda):
    """A u16 depth image back-projected on the card and on the CPU (points
    within 1e-6); an euler-angle Transform (built on the host, as every
    constructor is) applied to points and vectors on the card."""
    depth = np.random.default_rng(5).integers(0, 4000, (48, 64)).astype(np.uint16)
    cam = tt.CameraIntrinsics(525.0, 520.0, 31.5, 23.5)
    g = tt.OrganizedPointCloud.from_depth_image(depth, cam)
    c = tt.OrganizedPointCloud.from_depth_image(depth, cam, device="cpu")
    assert g.points.device.type == cuda.type
    torch.testing.assert_close(g.points.cpu(), c.points, atol=1e-6, rtol=0)
    assert torch.equal(g.mask.cpu(), c.mask) and int(g.size()) == int(c.size())
    tc_ = tt.Transform.from_euler_xyz([0.3, -0.2, 0.1], [1.0, 2.0, 3.0])
    tg = tt.Transform(tc_.matrix.to(cuda))
    v = torch.tensor([[0.5, -1.0, 2.0]])
    torch.testing.assert_close(tg.apply_vector(v.to(cuda)).cpu(), tc_.apply_vector(v),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(tg.apply_point(v[0].to(cuda)).cpu(), tc_.apply_point(v[0]),
                               atol=1e-6, rtol=0)


def _mc():
    import importlib
    return importlib.import_module("threecrate_tpu_torch.reconstruction.marching_cubes")


def _soup_set(soup):
    tri = soup.vertices.reshape(-1, 9)[soup.mask].cpu().numpy()
    return np.sort(np.ascontiguousarray(tri.round(5)).view([("", np.float32)] * 9), axis=None)


def test_marching_cubes_soups_on_card_match_cpu(cuda):
    """The 48³ sphere SDF built on the card (within 1e-6 of the CPU's:
    the card's norm sums in another order): dense, banded and tetrahedra
    soups of that grid bit-equal to the CPU run's on its copy, and the
    dense and banded soups the same triangle multiset."""
    mc = _mc()
    g = mc.create_sphere_volume(48, device=cuda)
    torch.testing.assert_close(g.values.cpu(), mc.create_sphere_volume(48, device="cpu").values,
                               atol=1e-6, rtol=0)
    c = mc.VolumetricGrid(g.values.cpu(), g.origin.cpu(), g.spacing.cpu())
    for fn in (lambda v: mc.extract_soup_cubes(v, 0.0),
               lambda v: mc.extract_soup_cubes_banded(v, 0.0, block=8, max_blocks=512),
               lambda v: mc.extract_soup(v, 0.0)):
        sg, sc = fn(g), fn(c)
        assert sg.vertices.device.type == "cuda"
        assert torch.equal(sg.mask.cpu(), sc.mask)
        assert torch.equal(sg.vertices.cpu(), sc.vertices)
    dense = _soup_set(mc.extract_soup_cubes(g, 0.0))
    banded = _soup_set(mc.extract_soup_cubes_auto(g))
    assert dense.shape == banded.shape and (dense == banded).all()


def test_welds_on_card_match_host_and_cpu(cuda):
    mc = _mc()
    soup = mc.extract_soup_cubes(mc.create_sphere_volume(48, device=cuda), 0.0)
    dev_mesh = mc.soup_to_mesh(soup, method="device")
    host_mesh = mc.soup_to_mesh(soup, method="host")
    cpu_mesh = mc.soup_to_mesh(mc.TriangleSoup(soup.vertices.cpu(), soup.mask.cpu()),
                               method="device")
    assert dev_mesh.vertices.device.type == host_mesh.vertices.device.type == "cuda"
    for a, b in zip(dev_mesh.to_numpy(), cpu_mesh.to_numpy()):
        np.testing.assert_array_equal(a, b)
    sets = []
    for m in (dev_mesh, host_mesh):
        v, f = m.to_numpy()
        sets.append(np.sort(np.ascontiguousarray(v[f].round(5).reshape(-1, 9)).view(
            [("", np.float32)] * 9), axis=None))
    assert int(dev_mesh.face_count()) == int(host_mesh.face_count()) > 1000
    assert int(dev_mesh.vertex_count()) == int(host_mesh.vertex_count())
    assert (sets[0] == sets[1]).all()


def test_sparse_marching_cubes_on_card_matches_cpu(cuda):
    depth = (2.0 + 0.3 * np.sin(np.mgrid[0:120, 0:160][1] / 20.0)
             * np.cos(np.mgrid[0:120, 0:160][0] / 15.0)).astype(np.float32)
    intr = np.array([130.0, 130.0, 80.0, 60.0], np.float32)
    soups = []
    for dev in (cuda, torch.device("cpu")):
        vol = tt.sparse_tsdf_integrate(
            tt.create_sparse_tsdf_volume(4.0 / 64, origin=(-2.0, -2.0, 0.5),
                                         grid_blocks=(8, 8, 8), max_blocks=512, device=dev),
            depth, intr, np.eye(4, dtype=np.float32), grid_blocks=(8, 8, 8))
        soups.append(tt.sparse_tsdf_marching_cubes_soup(vol, (8, 8, 8)))
    g, c = soups
    assert int(c.mask.sum()) > 1000
    same = g.mask.cpu() == c.mask
    assert same.float().mean().item() >= 0.999
    both = (g.mask.cpu() & c.mask).repeat_interleave(3)
    torch.testing.assert_close(g.vertices.cpu()[both], c.vertices[both], atol=1e-5, rtol=0)


@pytest.mark.parametrize("res", [16, 32, 64])
def test_mg_solve_on_card_converges(cuda, res):
    from threecrate_tpu_torch.reconstruction import multigrid
    b = torch.from_numpy(np.random.default_rng(0).normal(size=(res,) * 3).astype(np.float32))
    x = multigrid.mg_solve(b.to(cuda), 1e-4, cycles=8)
    rel = multigrid.mg_residual_norm(b.to(cuda), x, 1e-4)
    assert x.device.type == "cuda" and rel.item() < 1e-4, (res, rel.item())
    xc = multigrid.mg_solve(b, 1e-4, cycles=8)
    assert (x.cpu() - xc).abs().max().item() <= 1e-3 * xc.abs().max().item()


def test_poisson_on_card_matches_cpu(cuda):
    from threecrate_tpu_torch.reconstruction import poisson
    rng = np.random.default_rng(1)
    p = rng.normal(size=(4000, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    out = []
    for dev in (cuda, torch.device("cpu")):
        pts = torch.from_numpy(p).to(dev)
        args = (pts, pts, torch.ones(4000, dtype=torch.bool, device=dev),
                torch.full((3,), -1.2, device=dev), torch.tensor(2.4 / 63, device=dev), 64, 200,
                1e-4)
        out.append([poisson._solve(*args, solver=s) for s in ("cg", "multigrid")])
    for (gchi, giso, gsup), (cchi, ciso, csup) in zip(*out):
        scale = cchi.abs().max().item()
        assert (gchi.cpu() - cchi).abs().max().item() <= 1e-4 * scale
        assert abs(giso.item() - ciso.item()) <= 1e-4 * scale
        torch.testing.assert_close(gsup.cpu(), csup, atol=1e-5 * csup.max().item(), rtol=0)
    cloud = tt.PointCloud.from_numpy(p, normals=p, device=cuda)
    mesh = tt.poisson_reconstruct(cloud, tt.PoissonConfig(depth=6))
    v, f = mesh.to_numpy()
    r = np.linalg.norm(v, axis=1)
    assert mesh.vertices.device.type == "cuda" and len(f) > 1000
    assert abs(np.median(r) - 1.0) < 0.05 and r.std() < 0.05


def test_triangle_mesh_round_trip_on_card(cuda):
    rng = np.random.default_rng(2)
    v = rng.normal(size=(300, 3)).astype(np.float32)
    f = rng.integers(0, 300, (500, 3)).astype(np.int32)
    mesh = tt.TriangleMesh.from_numpy(v, f, normals=v, colors=np.abs(v))
    assert mesh.vertices.device.type == "cuda" and mesh.faces.dtype == torch.int32
    v2, f2 = mesh.to_numpy()
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_array_equal(mesh.attr_to_numpy("colors"), np.abs(v))
    cpu = tt.TriangleMesh.from_numpy(v, f, device="cpu")
    torch.testing.assert_close(mesh.compute_vertex_normals().normals.cpu(),
                               cpu.compute_vertex_normals().normals, atol=1e-5, rtol=0)
    torch.testing.assert_close(mesh.face_areas().cpu(), cpu.face_areas(), atol=1e-6, rtol=0)
    assert int(mesh.face_count()) == 500 and not bool(mesh.is_empty())


def _bumpy_sphere(n, sigma, seed):
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(0, 2 * np.pi, n), np.arccos(rng.uniform(-1, 1, n))
    sphere = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)], -1)
    return (sphere * (1 + 0.05 * np.sin(3 * u)[:, None])
            + rng.normal(0, sigma, (n, 3))).astype(np.float32)


def test_mls_on_card_matches_cpu(cuda):
    pts = _bumpy_sphere(20_000, 0.006, 11)
    cfg = tt.MlsConfig(search_radius=0.08)
    out = [tt.mls_smooth(tt.PointCloud.from_numpy(pts, device=d), cfg) for d in (cuda, "cpu")]
    assert out[0].points.device.type == "cuda"
    gp, cp = out[0].to_numpy(), out[1].to_numpy()
    gn, cn = out[0].attr_to_numpy("normals"), out[1].attr_to_numpy("normals")
    ok = (np.abs(gp - cp).max(1) <= 1e-5 * cfg.search_radius) & (np.abs((gn * cn).sum(1))
                                                                  >= 0.9999)
    assert ok.mean() >= 0.999, ok.mean()
    np.testing.assert_array_equal(np.linalg.norm(gn, axis=1) > 0, np.linalg.norm(cn, axis=1) > 0)
    mesh = tt.mls_reconstruct(tt.PointCloud.from_numpy(pts, device=cuda), cfg, 32)
    assert mesh.vertices.device.type == "cuda" and int(mesh.face_count()) > 1000


def test_mesh_smoothing_spread_on_card(cuda):
    grid = tt.VolumetricGrid.from_function(lambda p: (p * p).sum(-1).sqrt() - 0.8, (48,) * 3,
                                           (-1.0, -1.0, -1.0), 2.0 / 47, device="cpu")
    v, f = tt.marching_cubes(grid, 0.0).to_numpy()
    v = v + np.random.default_rng(3).normal(0, 0.01, v.shape).astype(np.float32)
    for name in ("smooth_laplacian", "smooth_taubin", "smooth_hc"):
        fn = getattr(tt, name)
        on_card = [fn(tt.TriangleMesh.from_numpy(v, f, device=cuda)).to_numpy()[0]
                   for _ in range(2)]
        cpu = fn(tt.TriangleMesh.from_numpy(v, f, device="cpu")).to_numpy()[0]
        assert np.abs(on_card[0] - on_card[1]).max() <= 1e-5, name
        assert np.abs(on_card[0] - cpu).max() <= 1e-5, name


def test_auto_reconstruct_reraises_a_kernel_failure(cuda, monkeypatch):
    """The analysis runs the union kernels; then the library is made to
    fail, and the Poisson branch's normals (the union kernels again, the
    cloud has 65,536+ points and no normals) must raise ``DeviceError``
    out of the fallback chain instead of trying the next algorithm."""
    from threecrate_tpu_torch.core.errors import DeviceError
    from threecrate_tpu_torch.kernels import _build
    from threecrate_tpu_torch.reconstruction import pipeline

    cloud = tt.PointCloud.from_numpy(_bumpy_sphere(70_000, 0.003, 11), device=cuda)
    ch = pipeline.analyze_data(cloud)
    calls = []
    real_execute = pipeline._execute

    def counted(c, algo, characteristics):
        calls.append(algo)
        return real_execute(c, algo, characteristics)

    def broken():
        raise DeviceError("forced kernel failure")

    monkeypatch.setattr(pipeline, "analyze_data", lambda c, samples=2000: ch)
    monkeypatch.setattr(pipeline, "_execute", counted)
    monkeypatch.setattr(_build, "lib", broken)
    with pytest.raises(DeviceError, match="forced kernel failure"):
        pipeline.auto_reconstruct_detailed(
            cloud, pipeline.PipelineConfig(preferred=pipeline.Algorithm.POISSON))
    assert calls == [pipeline.Algorithm.POISSON]


# ---------------------------------------------------------------------------
# the file-to-segments slice
# ---------------------------------------------------------------------------

def _io_cloud(n=5000, seed=21):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, {"normals": nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
                 "intensity": rng.uniform(0, 255, n).astype(np.float32)}


@pytest.mark.parametrize("ext,kw", [("ply", {}), ("ply", {"binary": False}), ("pcd", {}),
                                    ("pcd", {"compressed": True}), ("bin", {}), ("xyz", {})])
def test_readers_land_on_the_card_with_the_file_bits(cuda, tmp_path, ext, kw):
    pts, attrs = _io_cloud()
    path = tmp_path / f"c.{ext}"
    tt.write_point_cloud(path, tt.PointCloud.from_numpy(pts, device="cpu", **attrs), **kw)
    card = tt.read_point_cloud(path)
    host = tt.read_point_cloud(path, device="cpu")
    assert card.points.device.type == "cuda" and card.mask.device.type == "cuda"
    assert sorted(card.attrs) == sorted(host.attrs)
    np.testing.assert_array_equal(card.to_numpy(), host.to_numpy())
    for k in host.attrs:
        assert card.attrs[k].device.type == "cuda"
        np.testing.assert_array_equal(card.attr_to_numpy(k), host.attr_to_numpy(k))
    if ext != "xyz" and kw.get("binary", True):
        np.testing.assert_array_equal(card.to_numpy(), pts)
        np.testing.assert_array_equal(card.attr_to_numpy("intensity"), attrs["intensity"])


@pytest.mark.parametrize("ext", ["ply", "obj", "stl"])
def test_mesh_readers_land_on_the_card(cuda, tmp_path, ext):
    rng = np.random.default_rng(22)
    v = rng.normal(size=(400, 3)).astype(np.float32)
    f = rng.integers(0, 400, (700, 3)).astype(np.int32)
    path = tmp_path / f"m.{ext}"
    tt.write_mesh(path, tt.TriangleMesh.from_numpy(v, f, device="cpu"))
    card, host = tt.read_mesh(path), tt.read_mesh(path, device="cpu")
    assert card.vertices.device.type == card.faces.device.type == "cuda"
    for a, b in zip(card.to_numpy(), host.to_numpy()):
        np.testing.assert_array_equal(a, b)


def test_plane_scorer_on_card_matches_cpu(cuda):
    from threecrate_tpu_torch.ops import segmentation as seg
    rng = np.random.default_rng(23)
    floor = np.c_[rng.uniform(-20, 20, (20000, 2)), 0.03 * rng.normal(size=20000)]
    clutter = rng.uniform(-20, 20, (5000, 3)) + [0, 0, 5]
    pts = np.concatenate([floor, clutter]).astype(np.float32)
    host = tt.PointCloud.from_numpy(pts, device="cpu")
    card = tt.PointCloud.from_numpy(pts, device=cuda)
    idx = seg._sample_triples(host.mask, 512, 0)
    c_out = seg._plane_ransac(card.points, card.mask, idx.to(cuda), 0.1)
    h_out = seg._plane_ransac(host.points, host.mask, idx, 0.1)
    torch.testing.assert_close(c_out[0].cpu(), h_out[0], atol=1e-6, rtol=0)
    assert (c_out[3].cpu() - h_out[3]).abs().max() <= 2
    a, b = tt.segment_plane(card, 0.1, 512), tt.segment_plane(host, 0.1, 512)
    assert a.inlier_mask.device.type == "cuda"
    torch.testing.assert_close(a.model.normal.cpu(), b.model.normal, atol=1e-5, rtol=0)
    assert abs(int(a.inlier_count) - int(b.inlier_count)) <= 1e-3 * int(b.inlier_count)


def test_clusters_on_card_match_cpu(cuda):
    rng = np.random.default_rng(24)
    centres = rng.uniform(-1, 1, (15, 3)) * [1, 1, 0] + [0, 0, 0.5]
    sizes = rng.integers(5, 400, 15)
    pts = np.concatenate([c + rng.normal(0, 0.01, (s, 3)) for c, s in zip(centres, sizes)]
                         + [rng.uniform(-1.2, 1.2, (200, 3))]).astype(np.float32)
    cfg = tt.EuclideanClusterConfig(tolerance=0.03, min_cluster_size=10)
    a = tt.extract_euclidean_clusters(tt.PointCloud.from_numpy(pts, device=cuda), cfg)
    b = tt.extract_euclidean_clusters(tt.PointCloud.from_numpy(pts, device="cpu"), cfg)
    assert a.labels.device.type == "cuda" and int(a.n_clusters) == int(b.n_clusters) > 3
    assert torch.equal(a.labels.cpu(), b.labels) and torch.equal(a.sizes.cpu(), b.sizes)


def test_knn_grid_on_card_matches_cpu(cuda):
    pts = np.random.default_rng(25).uniform(-3, 3, (30000, 3)).astype(np.float32)
    out = []
    for d in (cuda, "cpu"):
        c = tt.PointCloud.from_numpy(pts, device=d)
        cell = tt.ops.neighbors.estimate_cell_size(c.points, c.mask, 10)
        out.append(tt.knn_grid(c.points, c.mask, c.points, c.mask, 10, cell))
    assert out[0].indices.device.type == "cuda"
    assert torch.equal(out[0].mask.cpu(), out[1].mask)
    # the same d² on both; the card's sqrt may round the last bit differently
    ulp = torch.from_numpy(np.spacing(out[1].distances.numpy()))
    assert bool(((out[0].distances.cpu() - out[1].distances).abs() <= ulp)[out[1].mask].all())
    d = torch.where(out[1].mask, out[1].distances, torch.inf)
    inf = torch.full((d.shape[0], 1), torch.inf)
    apart = out[1].mask & (torch.minimum(torch.diff(d, dim=1, prepend=-inf),
                                         torch.diff(d, dim=1, append=inf)) > 0)
    assert torch.equal(out[0].indices.cpu()[apart], out[1].indices[apart])


def test_profiling_memory_helpers_on_card(cuda):
    from threecrate_tpu_torch.utils import profiling
    stats = profiling.device_memory_stats()
    assert stats["bytes_in_use"] >= 0 and "peak_bytes_in_use" in stats
    out, peak = profiling.measure_peak_memory(lambda: torch.ones(2 ** 20, device=cuda) * 2)
    assert peak >= 4 * 2 ** 20 and float(out[0]) == 2.0
    mem = profiling.program_memory(lambda x: x.repeat(4), torch.ones(2 ** 20, device=cuda))
    assert mem["peak_bytes"] >= 16 * 2 ** 20 and set(mem) == {"argument_bytes", "peak_bytes",
                                                              "output_bytes"}
    assert profiling.sync(torch.ones(5, device=cuda)) == 5.0


# ---------------------------------------------------------------------------
# the survey-tile slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,kw", [("las", {}), ("laz", {}), ("las", {"point_format": 7}),
                                    ("e57", {}), ("tcz", {})])
def test_survey_readers_land_on_the_card_with_the_file_bits(cuda, tmp_path, ext, kw):
    rng = np.random.default_rng(26)
    n = 70_000                                  # two LAZ chunks
    pts = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0).astype(np.float32)
    attrs = {"intensity": rng.uniform(0, 1, n).astype(np.float32),
             "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    if ext != "e57":
        attrs["gps_time"] = 3e5 + np.cumsum(rng.uniform(1e-6, 2e-4, n))
    path = tmp_path / f"c.{ext}"
    tt.write_point_cloud(path, tt.PointCloud.from_numpy(pts, device="cpu", **attrs), **kw)
    card, host = tt.read_point_cloud(path), tt.read_point_cloud(path, device="cpu")
    assert card.points.device.type == "cuda" and sorted(card.attrs) == sorted(host.attrs)
    np.testing.assert_array_equal(card.to_numpy(), host.to_numpy())
    for k in host.attrs:
        assert card.attrs[k].device.type == "cuda"
        np.testing.assert_array_equal(card.attr_to_numpy(k), host.attr_to_numpy(k))


def test_voxel_accumulator_on_card_matches_cpu(cuda):
    """The streaming voxel filter's state on the card: rows bit-equal to
    its CPU run in value and order (the same sorted keys, the same
    sequential segment sums)."""
    from threecrate_tpu_torch.parallel import streaming
    rng = np.random.default_rng(27)
    pts = (rng.uniform(-40, 40, (200_000, 3)) * [1, 1, 0.1]).astype(np.float32)
    chunks = [pts[i:i + 16384] for i in range(0, len(pts), 16384)]
    card, host = streaming.StreamingVoxelFilter(0.5), \
        streaming.StreamingVoxelFilter(0.5, device="cpu")
    a, _ = streaming.run_pipeline(chunks, card)
    b, _ = streaming.run_pipeline(chunks, host)
    assert a.points.device.type == "cuda" and card._keys.device.type == "cuda"
    assert torch.equal(card._keys.cpu(), host._keys) and torch.equal(card._rows.cpu(), host._rows)
    assert torch.equal(card._sums.cpu(), host._sums)
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    assert card.memory_bytes() == host.memory_bytes()


@pytest.mark.parametrize("mode", ["NEAREST", "BILINEAR"])
def test_colorization_on_card_matches_cpu(cuda, mode):
    """The same pixel for every point on the card as on the CPU, and the
    colours bit-equal: the projection is the same elementwise fused
    multiply-adds on both."""
    rng = np.random.default_rng(28)
    pts = rng.uniform(-5, 5, (100_000, 3)).astype(np.float32) + [0, 0, 8]
    views = []
    for i in range(3):
        w2c = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.2 * i), np.sin(0.2 * i)
        w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        w2c[:3, 3] = [0.3 * i, -0.1, 0.5]
        img = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
        views.append(tt.RgbImageView(img, tt.CameraIntrinsics(1400.5, 1399.25, 959.7, 539.3),
                                     w2c))
    m = getattr(tt.InterpolationMode, mode)
    out = [tt.colorize_from_images(tt.PointCloud.from_numpy(pts, device=d), views, m)
           for d in (cuda, "cpu")]
    assert out[0].colors.device.type == "cuda"
    assert torch.equal(out[0].colors.cpu(), out[1].colors)
    one = [tt.colorize_point_cloud(tt.PointCloud.from_numpy(pts, device=d), views[1], m)
           for d in (cuda, "cpu")]
    assert torch.equal(one[0].colors.cpu(), one[1].colors)


# ---------------------------------------------------------------------------
# the multi-shard points axis: meshes of the card's device repeated
# ---------------------------------------------------------------------------

def _card_mesh(cuda, n=8):
    from threecrate_tpu_torch import parallel as tp
    return tp.make_mesh(n, devices=[cuda] * n)


def test_make_mesh_defaults_to_the_cards(cuda):
    from threecrate_tpu_torch import parallel as tp
    mesh = tp.make_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in mesh.device_list)
    with pytest.raises(ValueError, match="requested"):
        tp.make_mesh(torch.cuda.device_count() + 1)


@pytest.mark.parametrize("name", ["ppermute", "psum", "pmin", "pmax", "all_gather",
                                  "all_gather tiled"])
@pytest.mark.parametrize("two_d", [False, True])
def test_collectives_on_card_match_cpu(cuda, name, two_d):
    """The collectives on eight shards of the card equal the same on eight
    CPU shards, bit for bit; ppermute zero-fills the shards nobody sends
    to, and on a 2-D mesh each acts along the points axis alone."""
    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.parallel import collectives as col
    perm = [(0, 1), (1, 2), (3, 0)]
    ops = {"ppermute": lambda xs, m: col.ppermute(xs, m, "points", perm),
           "psum": lambda xs, m: col.psum(xs, m, "points"),
           "pmin": lambda xs, m: col.pmin(xs, m, "points"),
           "pmax": lambda xs, m: col.pmax(xs, m, "points"),
           "all_gather": lambda xs, m: col.all_gather(xs, m, "points"),
           "all_gather tiled": lambda xs, m: col.all_gather(xs, m, "points", tiled=True)}
    x = np.random.default_rng(9).normal(size=(2, 8, 5)).astype(np.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        if two_d:
            mesh = tp.Mesh(np.array([dev] * 8, dtype=object).reshape(2, 4), ("batch", "points"))
            spec = tp.P("batch", "points")
            arg = x
        else:
            mesh = tp.make_mesh(8, devices=[dev] * 8)
            spec = tp.P("points")
            arg = x[0]
        out = col.shard_map(lambda xs: ops[name](xs, mesh), mesh, (spec,), spec)(arg)
        outs.append([s.cpu() for s in out.shards])
        if dev.type == "cuda":
            assert all(s.device.type == "cuda" for s in out.shards)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if name == "ppermute":
        senders = {d for _, d in perm}
        width = 4 if two_d else 8
        for i, s in enumerate(outs[0]):
            assert bool(s.any()) == (i % width in senders)


def test_ring_knn_on_card_matches_knn(cuda):
    """A 4-shard ring kNN on the card: the exact ``knn``'s ids (where the
    distances are apart) and its squared distances within 2e-6."""
    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.ops import neighbors
    rng = np.random.default_rng(31)
    db = torch.from_numpy(rng.uniform(-2, 2, (8192, 3)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.uniform(-2, 2, (4096, 3)).astype(np.float32)).to(cuda)
    mask = torch.ones(8192, dtype=torch.bool, device=cuda)
    d, idx = tp.make_sharded_knn(_card_mesh(cuda, 4), 8)(q, db, mask)
    d, idx = d.gather(), idx.gather()
    ref = neighbors.knn(db, mask, q, None, 8)
    np.testing.assert_allclose((d ** 2).cpu().numpy(), (ref.distances ** 2).cpu().numpy(),
                               atol=2e-6, rtol=0)
    apart = torch.ones_like(ref.distances, dtype=torch.bool)
    gap = ref.distances.diff(dim=1) > 1e-5
    apart[:, :-1] &= gap
    apart[:, 1:] &= gap
    assert torch.equal(idx.long()[apart], ref.indices[apart])


def test_window_normals_shard_launch_matches_plain(cuda):
    """One shard's kernel-4 launch on its slice with a one-tile halo from
    each neighbour equals the plain version on the same extended slice,
    and the 8-shard call launches the kernel once a shard."""
    from threecrate_tpu_torch import parallel as tp
    pts = _scan(8 * 4096, 3)
    spts, smask, _ = tp.morton_presort(pts, np.ones(len(pts), bool), 8, tile=TILE)
    p = torch.from_numpy(spts).to(cuda)
    m = torch.from_numpy(smask).to(cuda)
    s = p.shape[0] // 8
    ext = p[3 * s - TILE:4 * s + TILE].T.contiguous()      # shard 3 with its halos
    ext_m = m[3 * s - TILE:4 * s + TILE].to(torch.float32)[None].contiguous()
    got = window_normals_tiles(ext, ext_m, K, TILE, BAND)
    ref = window_normals_plain(ext, ext_m, K, TILE, BAND)
    assert torch.equal(got, ref)
    kernels.reset_launch_counts()
    nrm, valid = tp.make_sharded_normals_window(_card_mesh(cuda), k=K, tile=TILE, band=BAND,
                                                presorted=True)(p, m)
    assert kernels.launch_counts()["window_normals"] == 8
    rows = ref[:, TILE:TILE + s]
    v3 = valid.shards[3]
    assert torch.equal(v3, m[3 * s:4 * s] & (rows[4] >= 3))


def test_distributed_sort_on_card_with_tied_keys(cuda):
    """4,096 points drawn from 64: the card's sort is a permutation, equal
    to the stable sort of the keys and to its CPU run."""
    from threecrate_tpu_torch import parallel as tp
    rng = np.random.default_rng(7)
    base = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    pts = base[rng.integers(0, 64, 4096)]
    mask = np.ones(4096, bool)
    out = [tuple(x.gather().cpu() for x in tp.make_distributed_morton_sort(
        tp.make_mesh(8, devices=[d] * 8))(pts, mask)) for d in (cuda, torch.device("cpu"))]
    for a, b in zip(*out):
        assert torch.equal(a, b)
    gid = out[0][2].numpy()
    np.testing.assert_array_equal(np.sort(gid), np.arange(4096))
    keys = morton.morton_keys(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(gid, np.argsort(keys, kind="stable"))


def _both_meshes(cuda):
    from threecrate_tpu_torch import parallel as tp
    return _card_mesh(cuda), tp.make_mesh(8, devices=[torch.device("cpu")] * 8)


def _wavy_frames(n=3, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.03 * i
        out.append(((2.0 + 0.3 * np.sin((xx + 2.0 * i) / 10.0) * np.cos(yy / 8.0))
                    .astype(np.float32), pose))
    return out


def test_sharded_tsdf_on_card(cuda):
    """The slab TSDF on eight shards of the card: the union of the shards'
    blocks bit-equal to the single-device ``sparse_integrate`` on the card
    (keys, tsdf and weights), the counts summing to its count; the
    sharded raycast against the single-device one on the card with JAX's
    gates, and its mask equal to the CPU mesh's on >= 99.9%."""
    from threecrate_tpu_torch.ops import tsdf_raycast as trc
    from threecrate_tpu_torch.ops import tsdf_sparse as tsp
    from threecrate_tpu_torch.parallel import sharded as tsh
    grid, vox, intr = (16, 16, 16), 4.0 / 128, np.array([52.0, 52.0, 31.5, 23.5], np.float32)
    kw = dict(origin=(-2.0, -2.0, 0.5), block=8, max_blocks_per_shard=512,
              update_fraction=1.0)
    outs = []
    for mesh in _both_meshes(cuda):
        fac = tsh.make_sharded_tsdf(mesh, grid, vox, **kw)
        st = fac.init()
        for d, p in _wavy_frames():
            st = fac.integrate(st, d, intr, p)
        outs.append((fac, st))
    (fac, st), (cfac, cst) = outs
    assert st.tsdf.shards[0].device.type == cuda.type
    ref = tsp.create_sparse_volume(vox, origin=(-2.0, -2.0, 0.5), grid_blocks=grid, block=8,
                                   max_blocks=4096, device=cuda)
    for d, p in _wavy_frames():
        ref = tsp.sparse_integrate(ref, d, intr, p, grid_blocks=grid, block=8,
                                   update_fraction=1.0)
    n = int(ref.n_blocks)
    keys = st.block_keys.gather()
    live = keys != 2 ** 31 - 1
    order = torch.argsort(keys[live])
    assert torch.equal(keys[live][order], ref.block_keys[:n])
    assert torch.equal(st.tsdf.gather()[live][order], ref.tsdf[:n])
    assert torch.equal(st.weight.gather()[live][order], ref.weight[:n])
    assert int(st.n_blocks.gather().sum()) == n
    eye = np.eye(4, dtype=np.float32)
    ray = dict(far=6.0, max_steps=48)
    d, v, nrm, m, c = fac.raycast(st, intr, eye, 48, 64, **ray)
    want = trc.sparse_raycast(ref, intr, eye, 48, 64, grid_blocks=grid, block=8,
                              materialize=False, **ray)
    assert (m != want.mask).float().mean().item() < 0.01
    both = m & want.mask
    assert both.float().mean().item() > 0.5
    assert (d[both] - want.depth[both]).abs().max().item() <= vox
    assert (nrm[both] * want.normals[both]).sum(-1).abs().median().item() > 0.999
    cm = cfac.raycast(cst, intr, eye, 48, 64, **ray)[3]
    assert (m.cpu() == cm).float().mean().item() >= 0.999


def test_sharded_odometry_on_card_matches_cpu(cuda):
    """``ShardedFrameToModelOdometry`` over three wavy-wall frames on the
    card's mesh: poses within 1e-4 of the CPU mesh's run."""
    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.ops.frame_to_model import FrameToModelConfig
    intr = np.array([52.0, 52.0, 31.5, 23.5], np.float32)
    yy, xx = np.mgrid[0:48, 0:64]
    frames = [(2.0 + 0.25 * np.sin((xx + 0.02 * i * 26.0) / 9.0) * np.cos(yy / 7.0))
              .astype(np.float32) for i in range(3)]
    poses = []
    for mesh in _both_meshes(cuda):
        odo = tp.ShardedFrameToModelOdometry(
            mesh, intr, 48, 64, voxel_size=4.0 / 128, origin=(-2.0, -2.0, 0.5),
            grid_blocks=(16, 16, 16), block=8, max_blocks_per_shard=512,
            config=FrameToModelConfig(model_render_scale=1, max_steps=48, far=6.0))
        poses.append([odo.register_frame(f).cpu().numpy() for f in frames])
    np.testing.assert_allclose(np.stack(poses[0]), np.stack(poses[1]), rtol=0, atol=1e-4)


def test_sharded_entries_on_card_match_cpu(cuda):
    """NDT (pose within 1e-4), ground (mask equal on >= 99.9%), clusters
    (labels and sizes equal), SHOT (valid equal, median cosine > 0.99999),
    plane RANSAC (the same CPU draws: the same inliers on >= 99.9%, normal
    within 1e-5), MLS (>= 98% of projections within 1e-4) and colorize
    (bit-equal) on the card's mesh against the CPU mesh's run."""
    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.ops.features import ShotConfig
    from threecrate_tpu_torch.ops.segmentation import EuclideanClusterConfig
    from threecrate_tpu_torch.reconstruction.moving_least_squares import MlsConfig
    rng = np.random.default_rng(21)
    xy = rng.uniform(-4, 4, (4096, 2)).astype(np.float32)
    src = (np.column_stack([xy, 0.5 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])]) * 2.0).astype(
        np.float32)
    tgt = src + np.array([0.08, -0.05, 0.02], np.float32)
    ones = np.ones(4096, bool)
    scan = _scan(16384, 5)
    surf = src[:2048] * np.float32(0.5)
    nrm = np.zeros_like(surf)
    nrm[:, 2] = 1.0
    imgs = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    intrs = np.array([[40.0, 40.0, 32.0, 24.0], [40.0, 40.0, 36.0, 24.0]], np.float32)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * 2)
    w2cs[:, 2, 3] = 3.0
    res = []
    for mesh in _both_meshes(cuda):
        out = {"ndt": tp.make_sharded_ndt(mesh, 1.0, max_iterations=40, step_size=0.2)(
            src, ones, tgt, ones, torch.eye(4))[0].cpu()}
        out["ground"] = tp.make_sharded_ground(mesh)(scan, np.ones(16384, bool))[0].numpy()
        lab, n_c, sizes = tp.make_sharded_clusters(mesh, EuclideanClusterConfig(
            tolerance=0.5, max_neighbors=16, min_cluster_size=5))(src, ones)
        out["clusters"] = (lab.numpy(), int(n_c), sizes.cpu().numpy())
        out["shot"] = [x.numpy() for x in tp.make_sharded_shot(mesh, ShotConfig(
            radius=0.4, max_neighbors=32, method="exact"))(surf, ones[:2048], nrm)]
        pl = tp.make_sharded_plane_ransac(mesh, 0.05, 256)(scan, np.ones(16384, bool), seed=3)
        out["ransac"] = (pl.model.normal.cpu().numpy(), pl.inlier_mask.numpy())
        out["mls"] = tp.make_sharded_mls(mesh, MlsConfig(search_radius=0.5, max_neighbors=24))(
            src, ones)[0].numpy()
        out["color"] = [x.numpy() for x in tp.make_sharded_colorize(mesh, 48, 64, True)(
            src * np.float32(0.1), ones, imgs, intrs, w2cs)]
        res.append(out)
    card, cpu = res
    np.testing.assert_allclose(card["ndt"].numpy(), cpu["ndt"].numpy(), rtol=0, atol=1e-4)
    assert (card["ground"] == cpu["ground"]).mean() >= 0.999
    for a, b in zip(card["clusters"], cpu["clusters"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(card["shot"][1], cpu["shot"][1])
    v = cpu["shot"][1]
    assert v.sum() > 1000
    assert np.median((card["shot"][0][v] * cpu["shot"][0][v]).sum(-1)) > 0.99999
    na, nb = card["ransac"][0], cpu["ransac"][0]
    np.testing.assert_allclose(na * np.sign(na @ nb), nb, rtol=0, atol=1e-5)
    assert (card["ransac"][1] == cpu["ransac"][1]).mean() >= 0.999
    assert (np.abs(card["mls"] - cpu["mls"]).max(1) < 1e-4).mean() >= 0.98
    for a, b in zip(card["color"], cpu["color"]):
        np.testing.assert_array_equal(a, b)
    assert cpu["color"][1].sum() > 1000


def test_sharded_poisson_on_card(cuda):
    """The x-slab multigrid on the card's mesh within 1e-6 of max|x| of
    the single-device ``mg_solve`` on the card, and within 1e-4 of the
    CPU mesh's (the card's and the CPU's solves differ as much on one
    device: phase 35's ``POISSON_CHI_TOL``), at 32³ with gather_res 8; ``make_sharded_poisson`` of a
    4,096-point sphere at depth 5 with a median radius within 0.03 of 1."""
    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.reconstruction import multigrid as tmg
    from threecrate_tpu_torch.reconstruction.poisson import PoissonConfig
    b = np.random.default_rng(11).normal(size=(32, 32, 32)).astype(np.float32)
    got = [tp.make_sharded_mg_solver(mesh, 32, cycles=4, gather_res=8)(b, np.float32(1e-4))
           .gather().cpu() for mesh in _both_meshes(cuda)]
    ref = tmg.mg_solve(torch.from_numpy(b).to(cuda), torch.tensor(1e-4, device=cuda),
                       cycles=4).cpu()
    scale = ref.abs().max().item()
    assert (got[0] - ref).abs().max().item() <= 1e-6 * scale
    assert (got[0] - got[1]).abs().max().item() <= 1e-4 * scale
    v = np.random.default_rng(9).normal(size=(4096, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    cloud = tt.PointCloud.from_numpy(v, device=cuda).with_normals(torch.from_numpy(v).to(cuda))
    verts, faces = tp.make_sharded_poisson(_card_mesh(cuda), PoissonConfig(depth=5))(
        cloud).to_numpy()
    assert len(faces) > 500
    assert abs(np.median(np.linalg.norm(verts, axis=1)) - 1.0) < 0.03


# ---------------------------------------------------------------------------
# the user-facing surface: root adapters from arrays, debug hooks, viz
# ---------------------------------------------------------------------------

def test_root_adapters_take_arrays_onto_the_card(cuda):
    """The root names build their clouds from NumPy arrays on the card and
    launch the native path's kernels: ``estimate_normals`` the union
    passes once each (k = 10 and ``k_neighbors=8``), ``icp`` with a 4×4
    ``init_transform`` ``icp_match`` once an iteration, the reference
    FPFH convention the union, banded SPFH and weight kernels once each
    (300,000 points: above the fused threshold) and
    ``remove_statistical_outliers`` the window kNN kernel; each output
    bit-equal to the native call on a cloud built on the card."""
    p = _scan(300_000, 31)
    for kw, k in (({}, 10), ({"k_neighbors": 8}, 8)):
        kernels.reset_launch_counts()
        got = tt.estimate_normals(p, **kw)
        counts = kernels.launch_counts()
        assert got.device.type == "cuda"
        assert counts["union_window_a"] == counts["union_window_b"] == 1
        ref = tt.ops.normals.estimate_normals(tt.PointCloud.from_numpy(p), k)
        assert torch.equal(got.normals, ref.normals)
    m4 = np.eye(4, dtype=np.float32)
    m4[:3, 3] = [0.02, -0.01, 0.01]
    shift = np.array([0.05, -0.03, 0.02], np.float32)
    kernels.reset_launch_counts()
    res = tt.icp(p, p + shift, 30, init_transform=m4)
    assert kernels.launch_counts()["icp_match"] == res.iterations >= 1
    assert isinstance(res.transformation, np.ndarray)
    ref = tt.ops.registration.icp_point_to_point(
        tt.PointCloud.from_numpy(p), tt.PointCloud.from_numpy(p + shift), 30,
        init=tt.Transform.from_matrix(m4))
    np.testing.assert_array_equal(res.transformation(), ref.transformation.cpu().numpy())
    assert np.abs(res.transformation[:3, 3] - shift).max() <= 1e-3
    cloud = tt.PointCloud.from_numpy(p)
    kernels.reset_launch_counts()
    feats = tt.extract_fpfh_features(cloud, 0.25, 10)
    counts = kernels.launch_counts()
    assert all(counts[k] == 1 for k in ("union_window_a", "union_window_b", "spfh_band_a",
                                        "spfh_band_b", "fpfh_weight_a", "fpfh_weight_b"))
    nat = tt.ops.features.extract_fpfh_features(cloud, tt.FpfhConfig(radius=0.25), k_normals=10)
    np.testing.assert_array_equal(feats, nat.descriptors[cloud.mask].cpu().numpy())
    kernels.reset_launch_counts()
    kept = tt.remove_statistical_outliers(p)
    assert kernels.launch_counts()["knn_window"] >= 1 and kept.device.type == "cuda"
    assert torch.equal(kept.mask, tt.ops.filtering.statistical_outlier_removal(cloud, 20, 2.0)
                       .cloud.mask)


def test_debug_and_profiling_on_card(cuda, tmp_path):
    """``nan_checks`` raises on a NaN on the card and not on a clean op;
    ``median_time`` applies ``sync_fn`` to each result; ``trace`` writes
    a trace whose kernel events include the card's."""
    import json
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from threecrate_tpu_torch.utils import debug, profiling
    with debug.nan_checks():
        torch.ones(4, device=cuda).sum()
        with pytest.raises(FloatingPointError):
            torch.zeros(1, device=cuda) / torch.zeros(1, device=cuda)
    assert _get_current_dispatch_mode() is None
    seen = []
    t = profiling.median_time(lambda: torch.ones(1 << 20, device=cuda) * 2, warmup=2, iters=3,
                              sync_fn=seen.append)
    assert t > 0 and len(seen) == 5 and all(x.is_cuda for x in seen)
    with profiling.trace(log_dir=str(tmp_path)) as d:
        (torch.ones(1 << 20, device=cuda) * 2).sum().item()
    (f,) = [f for f in tmp_path.iterdir() if f.name.endswith(".pt.trace.json")]
    assert d == str(tmp_path)
    assert any(e.get("cat") == "kernel" for e in json.loads(f.read_text())["traceEvents"])


def test_renderers_on_card_match_cpu(cuda):
    """The point splat of 20,000 points at 160x120 within 1e-6 of the CPU
    run on >= 99.5% of pixels; the flat and PBR rasters of a 5,000-face
    sphere within 1e-5 on >= 99%; the images on the host, finite."""
    from threecrate_tpu_torch.viz import renderer as tr
    pts = _scan(20_000, 32) * np.float32(0.05)
    imgs = [tr.render_point_cloud(tt.PointCloud.from_numpy(pts, device=d), width=160,
                                  height=120) for d in (cuda, "cpu")]
    assert (np.abs(imgs[0] - imgs[1]).max(-1) <= 1e-6).mean() >= 0.995
    n = 36
    th, ph = np.linspace(0.2, np.pi - 0.2, n), np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    v = np.stack([np.outer(np.sin(th), np.cos(ph)).ravel(),
                  np.outer(np.sin(th), np.sin(ph)).ravel(),
                  np.repeat(np.cos(th), 2 * n)], -1).astype(np.float32)
    w = 2 * n
    f = np.array([[i * w + j, i * w + (j + 1) % w, (i + 1) * w + j] for i in range(n - 1)
                  for j in range(w)] + [[i * w + (j + 1) % w, (i + 1) * w + (j + 1) % w,
                                         (i + 1) * w + j] for i in range(n - 1)
                                        for j in range(w)], np.int32)
    for fn in (tr.render_mesh, tr.render_mesh_pbr):
        out = [fn(tt.TriangleMesh.from_numpy(v, f, device=d), width=160, height=120)
               for d in (cuda, "cpu")]
        assert np.isfinite(out[0]).all()
        assert (np.abs(out[0] - out[1]).max(-1) <= 1e-5).mean() >= 0.99
