"""The SHOT/USC kernels of the PyTorch port against the Pallas kernels.

On the CPU the wrappers of ``threecrate_tpu_torch.kernels.shot`` run
their plain PyTorch versions; the Pallas kernels run in interpret mode,
as the JAX package's own tests run them. Both sides get the same packed
arrays from one stable sort (2,048 points of a smooth surface with an
invalid tail, tile 128, band 16, r = 0.25 × scale) and, for the
histograms, the same query frames (random orthonormal frames from a
numpy seed). Each reference is computed once per module and shape: the
interpret-mode histogram sweep costs tens of seconds to compile.

Stated tolerances:
* moments: the count row equal; each sum within 1e-5 of its scale in the
  query's neighbourhood, Σw·R^k with k = 1 for Σw·d, 2 for Σw·dᵢ·dⱼ,
  3 for Σw·|d|²·d and 0 for Σw (|d| <= R; the sums differ only by
  summation order);
* USC histograms: the count row equal; every row equal on >= 99.9% of
  queries (XLA:CPU may contract the Pallas body's products into FMAs,
  which can move a vote across a bin edge; on these fixtures it moved
  none);
* SHOT histograms: the count row equal; every vote within 1e-5 of the
  query's total weight (its count: each candidate's two soft votes sum to
  1) on >= 99.9% of queries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.kernels import shot_pallas as jsp  # noqa: E402
from threecrate_tpu.ops import morton as jmo  # noqa: E402

from threecrate_tpu_torch.kernels import shot as tk  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

N, TILE, BAND = 2048, 128, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _surface(n, seed, scale=1.0):
    """A smooth height field with its analytic unit normals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    nrm = np.stack([-0.8 * np.cos(xy[:, 0] * 2.0), 0.51 * np.sin(xy[:, 1] * 1.7),
                    np.ones(n)], -1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pts = np.stack([xy[:, 0], xy[:, 1], z], -1) * scale
    return pts.astype(np.float32), nrm.astype(np.float32)


def _packed(scale, n=N, seed=0):
    """Pass-A rows (7, N) [x, y, z, valid, nx, ny, nz], their pass-B copy
    with each column's pass-A position as an 8th row, and r², from one
    stable sort per pass."""
    pts, nrm = _surface(n, seed, scale)
    mask = np.ones(n, bool)
    mask[-60:] = False
    o = np.argsort(np.asarray(jmo.morton_keys(jnp.asarray(pts), jnp.asarray(mask), 0)),
                   kind="stable")
    packed = np.concatenate([pts[o].T, mask[o][None].astype(np.float32),
                             nrm[o].T]).astype(np.float32)
    ob = np.argsort(np.asarray(jmo.morton_keys(jnp.asarray(pts[o]), jnp.asarray(mask[o]),
                                               1)), kind="stable")
    p8 = np.concatenate([packed[:, ob], ob.astype(np.float32)[None]]).astype(np.float32)
    return packed, p8, ob, float(0.25 * scale) ** 2


def _frames(n, seed):
    """(9, n) random orthonormal frames [x, y, z] with z = x × y."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, 3, 3)))
    x, y = q[:, :, 0], q[:, :, 1]
    return np.concatenate([x, y, np.cross(x, y)], 1).T.astype(np.float32)


@pytest.fixture(scope="module", params=[1e-2, 1.0, 1e2], ids=["1e-2", "1", "1e2"])
def moments_case(request):
    scale = request.param
    packed, p8, _, r2 = _packed(scale)
    p4, p5 = packed[0:4], p8[[0, 1, 2, 3, 7]]
    out = {"a": (np.asarray(jsp.shot_moments_a_tiles(jnp.asarray(p4), r2, BAND, TILE,
                                                      interpret=True)),
                 tk.shot_moments_a_tiles(_t(p4), r2, BAND, TILE).numpy(), p4[3] > 0.5),
           "b": (np.asarray(jsp.shot_moments_b_tiles(jnp.asarray(p5), r2, BAND, TILE,
                                                      interpret=True)),
                 tk.shot_moments_b_tiles(_t(p5), r2, BAND, TILE).numpy(), p5[3] > 0.5)}
    return out, float(np.sqrt(np.float32(r2)))


@pytest.mark.parametrize("pass_", ["a", "b"])
def test_shot_moments_match_pallas(moments_case, pass_):
    out, radius = moments_case
    ref, got, valid = out[pass_]
    assert got.shape == ref.shape == (14, N)
    np.testing.assert_array_equal(got[10], ref[10])
    assert ref[10][valid].mean() > (10 if pass_ == "a" else 2)    # real neighbourhoods
    power = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 0, 3, 3, 3])
    scale = np.maximum(ref[0], 1e-30)[None] * radius ** power[:, None]
    err = np.abs(got - ref) / scale
    err[10] = 0
    assert err.max() <= 1e-5, err.max()


@pytest.fixture(scope="module", params=["shot", "usc"])
def hist_case(request):
    variant = request.param
    packed, p8, ob, r2 = _packed(1.0)
    lrf = _frames(N, 1)
    lrf_b = np.ascontiguousarray(lrf[:, ob])
    ja = np.asarray(jsp.shot_hist_a_tiles(jnp.asarray(packed), jnp.asarray(lrf), r2, BAND,
                                          TILE, interpret=True, variant=variant))
    jb = np.asarray(jsp.shot_hist_b_tiles(jnp.asarray(p8), jnp.asarray(lrf_b), r2, BAND,
                                          TILE, interpret=True, variant=variant))
    ta = tk.shot_hist_a_tiles(_t(packed), _t(lrf), r2, BAND, TILE, variant).numpy()
    tb = tk.shot_hist_b_tiles(_t(p8), _t(lrf_b), r2, BAND, TILE, variant).numpy()
    return variant, {"a": (ja, ta), "b": (jb, tb)}


@pytest.mark.parametrize("pass_", ["a", "b"])
def test_shot_hist_matches_pallas(hist_case, pass_):
    variant, out = hist_case
    ref, got = out[pass_]
    dim = tk.SHOT_DIM if variant == "shot" else tk.USC_DIM
    assert got.shape == ref.shape == (dim + 1, N)
    np.testing.assert_array_equal(got[dim], ref[dim])
    assert ref[dim].mean() > (10 if pass_ == "a" else 2)          # real neighbourhoods
    # every selected candidate votes a total weight of 1
    np.testing.assert_allclose(got[:dim].sum(0), got[dim], rtol=1e-5, atol=1e-5)
    if variant == "usc":
        assert (got == ref).all(0).mean() >= 0.999
    else:
        err = np.abs(got[:dim] - ref[:dim]).max(0)
        assert np.mean(err <= 1e-5 * np.maximum(ref[dim], 1)) >= 0.999, err.max()


def test_radius_constants_match_xla():
    """R = sqrt(r2) and 1/sqrt(r2) as the Pallas bodies get them:
    ``jnp.sqrt`` and ``lax.rsqrt`` of the fp32 constant r2, folded by XLA."""
    for r in (0.0025, 0.1, 0.25, 0.35, 0.6, 2.5, 25.0):
        r2 = r * r
        rs = np.asarray(jax.jit(lambda: jax.lax.rsqrt(jnp.float32(r2)))())
        sq = np.asarray(jax.jit(lambda: jnp.sqrt(jnp.float32(r2)))())
        assert np.float32(tk._inv_radius_f32(r2)) == rs
        assert np.float32(tk._radius_f32(r2)) == sq


def test_pass_b_excludes_the_pass_a_band():
    """Pass B with far-apart pass-A positions equals pass A; with equal
    positions it selects nothing."""
    packed, _, _, r2 = _packed(1.0, n=512)
    lrf = _t(_frames(512, 2))
    far = np.concatenate([packed, (np.arange(512) * 1000.0)[None]]).astype(np.float32)
    same = np.concatenate([packed, np.zeros((1, 512))]).astype(np.float32)
    for variant in ("shot", "usc"):
        a = tk.shot_hist_a_plain(_t(packed), lrf, r2, BAND, TILE, variant).numpy()
        np.testing.assert_array_equal(
            tk.shot_hist_b_plain(_t(far), lrf, r2, BAND, TILE, variant).numpy(), a)
        assert (tk.shot_hist_b_plain(_t(same), lrf, r2, BAND, TILE, variant).numpy()
                == 0).all()
    m4 = np.concatenate([packed[0:4], far[7:8]])
    np.testing.assert_array_equal(tk.shot_moments_b_plain(_t(m4), r2, BAND, TILE).numpy(),
                                  tk.shot_moments_a_plain(_t(packed[0:4]), r2, BAND,
                                                          TILE).numpy())


def test_shot_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError, match="band"):
        tk.shot_moments_a_tiles(torch.zeros(4, 256), 0.1, 200, 128)
    with pytest.raises(ValueError):
        tk.shot_moments_b_tiles(torch.zeros(4, 256), 0.1, 16, 128)    # pass B: 5 rows
    with pytest.raises(ValueError):
        tk.shot_hist_a_tiles(torch.zeros(7, 300), torch.zeros(9, 300), 0.1, 16, 128)
    with pytest.raises(TypeError):
        tk.shot_hist_a_tiles(torch.zeros(7, 256), torch.zeros(3, 256), 0.1, 16, 128)
    with pytest.raises(ValueError, match="variant"):
        tk.shot_hist_b_tiles(torch.zeros(8, 256), torch.zeros(9, 256), 0.1, 16, 128,
                             "fpfh")
