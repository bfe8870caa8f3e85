"""Descriptor matching's kernel (``kernels.match``, ``csrc/match.cu``).

On the CPU: ``match_descriptors`` through the wrapper's plain version
gives the bits of the port's matching before the kernel (a frozen copy
below), on both sides of the 2^26 switch, with and without the mutual
check, and launches nothing; the packed words order by d² and then by
row, store −0 as +0, and the sentinel reads back as (+inf, row 0).

On the card (marker ``cuda``; skipped without one): the kernel against
the plain version on the same CUDA tensors, whose d² is the same
expansion ‖q‖² + ‖p‖² − 2·q·p with the same norms and a cuBLAS product.
Stated tolerances, in ulps of ‖q‖² + ‖p‖² (2^-23 of that sum; the
expansion's rounding is relative to its terms, not to d²): rows equal
except where the plain version's d² of the two rows lie within 4 ulps
(the kernel's FMA chain and cuBLAS sum q·p in other orders, so only
near-ties may flip); the kernel's d² within 4 ulps of the plain
version's for the same row, for the same reason. Ties between equal
rows go to the lowest row, exactly. The file imports no JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_match_kernel.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import kernels  # noqa: E402
from threecrate_tpu_torch.kernels import match  # noqa: E402
from threecrate_tpu_torch.ops import neighbors  # noqa: E402
from threecrate_tpu_torch.ops.linalg import fp32_matmul  # noqa: E402

ULPS = 4


def _old_match_descriptors(desc_a, valid_a, desc_b, valid_b, mutual=False,
                           one_matmul=2 ** 26):
    """``ops.features.match_descriptors`` as it was before the kernel."""
    na, nb = desc_a.shape[0], desc_b.shape[0]
    rows_a = torch.arange(na, device=desc_a.device)
    if na * nb > one_matmul:
        res = neighbors.knn(desc_b, valid_b, desc_a, valid_a, 1)
        j = res.indices[:, 0]
        dist = res.distances[:, 0]
        ok = valid_a & res.mask[:, 0] & torch.isfinite(dist)
        if mutual:
            back = neighbors.knn(desc_a, valid_a, desc_b, valid_b, 1)
            ok = ok & (back.indices[:, 0][j] == rows_a)
        return j, torch.where(ok, dist, torch.inf), ok
    an = (desc_a * desc_a).sum(1)
    bn = (desc_b * desc_b).sum(1)
    d2 = an[:, None] + bn[None, :] - 2.0 * fp32_matmul(desc_a, desc_b.T)
    d2 = torch.where(valid_b[None, :], d2, torch.inf)
    j = torch.argmin(d2, dim=1)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, 1, j[:, None])[:, 0], 0.0))
    ok = valid_a & torch.isfinite(dist)
    if mutual:
        back = torch.argmin(torch.where(valid_a[:, None], d2, torch.inf), dim=0)
        ok = ok & (back[j] == rows_a)
    return j, torch.where(ok, dist, torch.inf), ok


def _descriptors(n, d, seed, invalid_every=9, device="cpu"):
    """FPFH-like rows (non-negative), every ``invalid_every``-th invalid."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.gamma(0.6, 4.0, (n, d)).astype(np.float32)).to(device)
    v = torch.ones(n, dtype=torch.bool, device=device)
    v[::invalid_every] = False
    return x, v


def _pair(na, nb, d, seed, device="cpu"):
    a, va = _descriptors(na, d, seed, 9, device)
    b, vb = _descriptors(nb, d, seed + 1, 7, device)
    m = min(na, nb) // 2
    b[:m] = a[:m] + 0.01        # half of a has a clear partner
    return a, va, b, vb


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("one_matmul", [2 ** 26, 2 ** 16], ids=["one-matmul", "tiled-knn"])
def test_match_descriptors_bit_equal_to_plain_path(one_matmul, mutual, monkeypatch):
    """On the CPU the wrapper runs the plain version: the same bits as
    matching before the kernel, on both sides of the switch at 2^26 pair
    products (lowered here to reach the tiled knn at 300 x 400;
    test_torch_global_registration.py holds both paths against JAX's at
    the real switch)."""
    assert match._ONE_MATMUL == 2 ** 26
    monkeypatch.setattr(match, "_ONE_MATMUL", one_matmul)
    a, va, b, vb = _pair(300, 400, 33, 3)
    kernels.reset_launch_counts()
    got = tt.match_descriptors(a, va, b, vb, mutual=mutual)
    assert not any(kernels.launch_counts().values())
    ref = _old_match_descriptors(a, va, b, vb, mutual=mutual, one_matmul=one_matmul)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert got[2].float().mean() > (0.3 if mutual else 0.8)


@pytest.mark.parametrize("mutual", [False, True])
def test_match_nearest_plain_directions(mutual):
    """The plain version's rows and distances are each direction's
    argmin over the valid rows; ``back`` only with ``mutual``."""
    a, va, b, vb = _pair(200, 300, 33, 5)
    j, dist, back = match.match_nearest_plain(a, va, b, vb, mutual)
    d2 = torch.cdist(a.double(), b.double()) ** 2
    exact = torch.where(vb[None], d2, torch.inf).min(1)
    assert torch.equal(j, torch.where(vb[None], d2, torch.inf).argmin(1))
    torch.testing.assert_close(dist.double() ** 2, exact.values, rtol=0, atol=1e-2)
    if mutual:
        # (the one-matmul path masks invalid b columns before this argmin)
        assert torch.equal(back[vb], torch.where(va[:, None], d2, torch.inf).argmin(0)[vb])
    else:
        assert back is None


def test_pack_orders_by_d2_then_row():
    d2 = torch.tensor([0.0, -0.0, 1e-30, 1.0, 1.0, 3e38, torch.inf])
    rows = torch.tensor([5, 2, 0, 9, 3, 1, 0])
    words = match.pack(d2, rows)
    # −0 is stored as +0, so it ties with 0.0 and the lower row wins
    assert words[1] == match.pack(torch.tensor([0.0]), torch.tensor([2]))[0]
    order = torch.argsort(words).tolist()
    assert order == [1, 0, 2, 4, 3, 5, 6]
    back_d2, back_rows = match.unpack(words)
    assert torch.equal(back_rows, rows.to(torch.int64))
    assert torch.equal(back_d2.view(torch.int32), (d2 + 0.0).view(torch.int32))
    assert not torch.signbit(back_d2).any()


def test_sentinel_reads_back_as_no_row():
    d2, row = match.unpack(torch.tensor([match.SENTINEL], dtype=torch.int64))
    assert d2.item() == float("inf") and row.item() == 0
    assert match.pack(torch.tensor([torch.inf]), torch.tensor([0]))[0] == match.SENTINEL
    # every finite d² of any row sorts below it
    assert match.pack(torch.tensor([3.4e38]), torch.tensor([2 ** 31 - 1]))[0] < match.SENTINEL


@pytest.mark.parametrize("case", ["dtype", "validity dtype", "shape", "dimension",
                                  "validity shape", "empty"])
def test_kernel_input_checks(case):
    """The card path's checks (run here on CPU tensors)."""
    a, va, b, vb = _pair(40, 50, 33, 1)
    args = {"dtype": (a.double(), va, b, vb), "validity dtype": (a, va.float(), b, vb),
            "shape": (a[None], va, b, vb), "dimension": (a, va, b[:, :5], vb),
            "validity shape": (a, va[:-1], b, vb), "empty": (a[:0], va[:0], b, vb)}[case]
    with pytest.raises((TypeError, ValueError)):
        match._check(*args)


def test_kernel_layout_and_norms():
    """The kernel's inputs: descriptors transposed, the rows zero padded
    to a multiple of 128; the database's norms +inf where invalid and in
    the padding, the queries' 0 there."""
    a, va, _, _ = _pair(130, 10, 33, 2)
    lay = match._layout(a, 256)
    assert lay.shape == (33, 256) and torch.equal(lay[:, :130], a.T)
    assert not lay[:, 130:].any()
    db = match._norms(a, va, 256)
    assert torch.equal(db[:130][va], (a * a).sum(-1)[va])
    assert torch.isinf(db[:130][~va]).all() and torch.isinf(db[130:]).all()
    qn = match._norms(a, None, 256)
    assert torch.equal(qn[:130], (a * a).sum(-1)) and not qn[130:].any()


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ulp(a, b, j):
    return 2.0 ** -23 * ((a * a).sum(1) + (b[j] * b[j]).sum(1))


def _plain_d2(a, b, vb):
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * fp32_matmul(a, b.T)).clamp_min(0.0)
    return torch.where(vb[None], d2, torch.inf)


def _assert_direction(a, b, vb):
    """One launch, a direction: the kernel's rows equal the plain
    expansion's but for near-ties, its d² within ULPS of the plain's for
    the same row. Returns (rows, the share equal to the plain's)."""
    d2k, j = match.unpack(match._nearest(a, b, vb))
    if not vb.any():
        assert torch.isinf(d2k).all() and not j.any()
        return j, 1.0
    d2 = _plain_d2(a, b, vb)
    jp = d2.argmin(1)
    rows = torch.arange(a.shape[0], device=a.device)
    assert bool(vb[j].all())
    assert bool(((j == jp) | ((d2[rows, j] - d2[rows, jp]).abs() <= ULPS * _ulp(a, b, jp))).all())
    assert bool(((d2k - d2[rows, j]).abs() <= ULPS * _ulp(a, b, j)).all())
    return j, (j == jp).float().mean().item()


SHAPES = {"ragged": (1000, 3001), "split": (200, 50_000), "many queries": (5000, 700)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 33, 352])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_plain(cuda, d, shape):
    """Ragged Q and N, a database split over many blocks, and more query
    blocks than the card runs at once, at D = 3, 33 (FPFH) and 352 (SHOT);
    invalid rows on both sides, both directions, and the wrapper's two
    launches with ``mutual``."""
    na, nb = SHAPES[shape]
    a, va, b, vb = _pair(na, nb, d, 11, cuda)
    j, share = _assert_direction(a, b, vb)
    back, share_b = _assert_direction(b, a, va)
    assert share > 0.99 and share_b > 0.99
    kernels.reset_launch_counts()
    jw, dist, backw = match.match_nearest_tiles(a, va, b, vb, mutual=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["match_nearest"] == 2
    assert torch.equal(jw, j) and torch.equal(backw, back)
    d2k, _ = match.unpack(match._nearest(a, b, vb))
    assert torch.equal(dist, torch.sqrt(d2k))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 33])
def test_kernel_ties_go_to_lowest_row(cuda, d):
    """Duplicated database rows give bit-equal d²: the lowest row wins,
    also across tiles and database splits; queries equal to a database
    row (d² clamped to 0) likewise."""
    base, _ = _descriptors(300, d, 21, device=cuda)
    b = torch.cat([base, base, base[:100]])            # rows r, r + 300, r + 600
    vb = torch.ones(b.shape[0], dtype=torch.bool, device=cuda)
    vb[5] = False                                       # its copies stand in
    a = torch.cat([base[:200] + 0.003, base[200:]])
    va = torch.ones(a.shape[0], dtype=torch.bool, device=cuda)
    j, _, _ = match.match_nearest_tiles(a, va, b, vb)
    # whichever row is nearest, of its copies the lowest valid one wins
    lowest = j % 300
    lowest[lowest == 5] = 305
    assert torch.equal(j, lowest)
    assert (j % 300 == torch.arange(300, device=cuda)).float().mean() > 0.95
    # a database of copies of one row, wider than a split: row 0 wins
    many = base[7:8].expand(40_000, d).contiguous()
    jm, dm, _ = match.match_nearest_tiles(a[:64], va[:64], many,
                                          torch.ones(40_000, dtype=torch.bool, device=cuda))
    assert not jm.any() and torch.isfinite(dm).all()


@pytest.mark.cuda
def test_kernel_invalid_rows(cuda):
    """Invalid database rows are never chosen, whatever they hold (NaN,
    inf, a copy of the query); an all-invalid database gives the
    sentinel (+inf, row 0); invalid queries are still answered."""
    a, va, b, vb = _pair(500, 2000, 33, 31, cuda)
    b[1::7] = a[0]
    vb[1::7] = False
    b[3::7] = torch.nan
    vb[3::7] = False
    b[4::7] = torch.inf
    vb[4::7] = False
    j, dist, back = match.match_nearest_tiles(a, va, b, vb, mutual=True)
    assert bool(vb[j].all()) and torch.isfinite(dist).all()
    assert bool(va[back[vb]].all())     # NaN and inf queries find no row
    _assert_direction(a, b, vb)
    none = torch.zeros_like(vb)
    jn, dn, _ = match.match_nearest_tiles(a, va, b, none)
    assert not jn.any() and torch.isinf(dn).all()
    _, _, ok = tt.match_descriptors(a, va, b, none, mutual=True)
    assert not ok.any()


@pytest.mark.cuda
@pytest.mark.parametrize("mutual", [False, True])
def test_match_descriptors_on_card(cuda, mutual):
    """``match_descriptors`` launches the kernel once a direction and
    agrees with the plain version's matches but for near-ties."""
    a, va, b, vb = _pair(3000, 20_000, 33, 41, cuda)
    kernels.reset_launch_counts()
    j, dist, ok = tt.match_descriptors(a, va, b, vb, mutual=mutual)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["match_nearest"] == (2 if mutual else 1)
    jr, _, okr = _old_match_descriptors(a, va, b, vb, mutual=mutual)
    assert (ok == okr).float().mean() > 0.99 and (j == jr)[ok & okr].float().mean() > 0.99
    assert torch.isinf(dist[~ok]).all() and torch.isfinite(dist[ok]).all()


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(cuda):
    a, va, b, vb = _pair(40, 50, 33, 1, cuda)
    with pytest.raises(TypeError):
        match.match_nearest_tiles(a.half(), va, b, vb)
    with pytest.raises(ValueError):
        match.match_nearest_tiles(a, va, b.cpu(), vb)
    with pytest.raises(ValueError):
        match.match_nearest_tiles(a, va, b[:0], vb[:0])
