"""Point-to-plane, batched and multiscale ICP: the PyTorch port against
the JAX package.

Both packages get the same padded clouds, and point-to-plane the same
target normals (the JAX package's, carried over as an attribute). The
target is the source moved by a small rigid motion plus noise on a ±2 m
surface, as tests/test_torch_registration.py does, so the MSE is well
above fp32 rounding. Stated tolerances: transforms within 1e-4, MSE
within 1e-2 relative, the same iteration count, convergence flag and
correspondence count (``batch_icp``'s noise-free pairs end at an MSE
that is fp32 rounding of ‖q‖² + ‖p‖² − 2q·p, held within 2e-6 m², the
9u·(‖q‖² + ‖p‖²) bound at this surface's size); ``solve_psd`` within
1e-5 relative of the JAX solve (both an fp32 Cholesky) and NaN where the
factorisation fails.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.core.errors import InvalidDataError as JaxInvalidDataError  # noqa: E402
from threecrate_tpu.core.transform import se3_exp  # noqa: E402
from threecrate_tpu.ops import linalg as jl  # noqa: E402
from threecrate_tpu.ops import normals as jn  # noqa: E402
from threecrate_tpu.ops import registration as jr  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.core.errors import InvalidDataError  # noqa: E402
from threecrate_tpu_torch.ops import linalg as tl  # noqa: E402
from threecrate_tpu_torch.ops import registration as tr  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _surface(n, rng):
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def _pair(n, seed, xi=(0.004, -0.003, 0.006, 0.05, -0.03, 0.02), noise=0.005):
    rng = np.random.default_rng(seed)
    src = _surface(n, rng)
    m = np.asarray(se3_exp(jnp.asarray(xi, jnp.float32)))
    tgt = (src @ m[:3, :3].T + m[:3, 3] + rng.normal(0, noise, src.shape)).astype(np.float32)
    return src, tgt, m


def _clouds(src, tgt, with_normals=True):
    js, jt = tc.PointCloud.from_numpy(src), tc.PointCloud.from_numpy(tgt)
    attrs = {}
    if with_normals:
        nrm = jn.estimate_normals_detailed(jt).normals
        jt = jt.with_normals(nrm)
        attrs["normals"] = np.asarray(nrm)
    ts = interop.cloud_from_numpy(np.asarray(js.points), np.asarray(js.mask), device="cpu")
    tt_ = interop.cloud_from_numpy(np.asarray(jt.points), np.asarray(jt.mask), attrs,
                                   device="cpu")
    return js, jt, ts, tt_


def _assert_same(jres, tres):
    np.testing.assert_allclose(tres.transformation.numpy(),
                               np.asarray(jres.transformation), atol=1e-4)
    np.testing.assert_allclose(float(tres.mse), float(jres.mse), rtol=1e-2)
    assert tres.iterations == int(jres.iterations)
    assert tres.converged == bool(jres.converged)
    assert tres.correspondences == int(jres.correspondences)


@pytest.mark.parametrize("correspondence,subsample", [("exact", None), ("window", 1),
                                                      ("window", 2)])
def test_point_to_plane_matches_jax(correspondence, subsample):
    """2,000 points: brute-force 1-NN, and the static-sort window path
    (forced; target normals as the kernel's 3 payload rows) with and
    without the coarse phase."""
    src, tgt, m = _pair(2000, 1)
    js, jt, ts, tt_ = _clouds(src, tgt)
    kw = dict(max_iterations=15, correspondence=correspondence, subsample=subsample)
    jres = jr.icp_point_to_plane(js, jt, **kw)
    tres = tr.icp_point_to_plane(ts, tt_, **kw)
    _assert_same(jres, tres)
    assert np.abs(tres.transformation.numpy() - m).max() <= 5e-3


def test_point_to_plane_distance_limit_matches_jax():
    """5% of the target lifted by 1 m: the 0.3 m limit drops them."""
    src, tgt, _ = _pair(2000, 2)
    tgt[::20, 2] += 1.0
    js, jt, ts, tt_ = _clouds(src, tgt)
    kw = dict(max_iterations=8, max_correspondence_distance=0.3)
    _assert_same(jr.icp_point_to_plane(js, jt, **kw), tr.icp_point_to_plane(ts, tt_, **kw))


def test_point_to_plane_needs_target_normals():
    src, tgt, _ = _pair(300, 3)
    js, jt, ts, tt_ = _clouds(src, tgt, with_normals=False)
    with pytest.raises(JaxInvalidDataError) as je:
        jr.icp_point_to_plane(js, jt)
    with pytest.raises(InvalidDataError) as te:
        tr.icp_point_to_plane(ts, tt_)
    assert str(te.value) == str(je.value)


def test_static_corr_setup_carries_payloads():
    """The matched payload rows are the matched targets' own rows, and a
    source payload comes back in source-sorted order, tile-strided with
    the coarse phase."""
    rng = np.random.default_rng(4)
    src = torch.from_numpy(_surface(1024, rng))
    tgt = src + 0.01
    ex = torch.from_numpy(rng.normal(0, 1, (1024, 3)).astype(np.float32))
    ones = torch.ones(1024, dtype=torch.bool)
    for stride in (1, 2):
        match, src_ex = tr._static_corr_setup(src, ones, tgt, ones, torch.eye(4), 1.0, 3,
                                              tgt_extra=tgt + 5.0, src_extra=ex,
                                              tile_stride=stride)
        moved, matched, ok, _, extra = match(torch.eye(4))
        assert extra.shape == (3, moved.shape[0]) and ok.float().mean() > 0.9
        torch.testing.assert_close(extra.T[ok], matched[ok] + 5.0)
        rows = torch.cdist(moved, src).argmin(1)          # each sorted row's source row
        torch.testing.assert_close(src_ex, ex[rows])


def test_batch_icp_matches_jax():
    """Two 400-point pairs (the JAX test's shifts) and a third with a
    rotation, through the brute-force loop from the identity."""
    rng = np.random.default_rng(5)
    pts = _surface(400, rng)
    offs = np.array([[0.05, -0.02, 0.01], [0.02, 0.03, -0.01], [0.0, 0.0, 0.0]], np.float32)
    rot = np.asarray(se3_exp(jnp.asarray([0.0, 0.0, 0.02, 0, 0, 0], jnp.float32)))[:3, :3]
    srcs = np.stack([pts, pts, pts])
    tgts = np.stack([pts + offs[0], pts + offs[1], pts @ rot.T]).astype(np.float32)
    masks = np.ones((3, 400), bool)
    masks[2, ::7] = False
    jres = jr.batch_icp(srcs, masks, tgts, masks, max_iterations=30)
    tres = tr.batch_icp(srcs, masks, tgts, masks, max_iterations=30, device="cpu")
    assert tres.transformation.shape == (3, 4, 4)
    np.testing.assert_allclose(tres.transformation.numpy(), np.asarray(jres.transformation),
                               atol=1e-4)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.correspondences.numpy(),
                                  np.asarray(jres.correspondences))
    np.testing.assert_allclose(tres.mse.numpy(), np.asarray(jres.mse), rtol=0, atol=2e-6)


@pytest.mark.parametrize("levels", [None, (0.4, 0.2, 0.1)])
def test_multiscale_matches_jax(levels):
    """The default pyramid (0.20/0.10/0.05) and the JAX test's coarser one
    on a 1,500-point pair with a 0.05 rad, 19 cm motion."""
    src, tgt, m = _pair(1500, 7, xi=(0.0, 0.0, 0.05, 0.15, -0.1, 0.05), noise=0.002)
    js, jt, ts, tt_ = _clouds(src, tgt, with_normals=False)
    jcfg = jr.MultiscaleConfig() if levels is None else jr.MultiscaleConfig(voxel_levels=levels)
    tcfg = interop.multiscale_config_from(jcfg)
    assert tcfg == (tr.MultiscaleConfig() if levels is None
                    else tr.MultiscaleConfig(voxel_levels=levels))
    jres = jr.multiscale_icp_point_to_point(js, jt, jcfg)
    tres = tr.multiscale_icp_point_to_point(ts, tt_, tcfg)
    _assert_same(jres, tres)
    assert np.abs(tres.transformation.numpy() - m).max() <= 0.02


def test_solve_psd_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(0, 1, (6, 6))
    a = (a @ a.T + 0.1 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    ref = np.asarray(jl.solve_psd(jnp.asarray(a), jnp.asarray(b), damping=1e-6))
    got = tl.solve_psd(torch.from_numpy(a), torch.from_numpy(b), damping=1e-6).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    zero = tl.solve_psd(torch.zeros(6, 6), torch.ones(6), damping=1e-6)
    assert torch.isnan(zero).all()
    assert np.isnan(np.asarray(jl.solve_psd(jnp.zeros((6, 6)), jnp.ones(6), 1e-6))).all()
