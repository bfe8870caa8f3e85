"""Descriptor matching, batched Kabsch, RANSAC scoring, global
registration and ``RegistrationModel``: the PyTorch port against the JAX
package.

The two packages draw RANSAC samples from different generators, so the
hypothesis scoring is compared on the same sample indices (drawn with
``jax.random.choice`` exactly as ``_ransac_batch`` draws them), and the
end-to-end runs are compared through the pose each recovers.

Stated tolerances:
* ``match_descriptors``: indices, validity and the mutual check equal;
  squared distances within 1e-4 (both sides expand ‖a‖² + ‖b‖² − 2a·b
  with terms up to ~70 here, and their fp32 matmuls round a·b
  differently);
* batched Kabsch: transforms within 1e-5 of the JAX ``vmap(kabsch)`` on
  exact rigid triples, within 2e-4 with 1 cm noise (the 3x3 SVD
  amplifies rounding by 1/(σ1 − σ2), and random noisy triples come
  near σ1 = σ2);
* ``score_hypotheses``: the same inlier count, the best transform
  within 1e-5;
* global registration and ``RegistrationModel``: the applied pose
  recovered within 0.05 (the JAX package's own bound), and within 1e-3
  of the JAX package's pose.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.models.perception import RegistrationModel as JaxModel  # noqa: E402
from threecrate_tpu.ops import features as jf  # noqa: E402
from threecrate_tpu.ops import global_registration as jg  # noqa: E402
from threecrate_tpu.ops import linalg as jl  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import global_registration as tg  # noqa: E402
from threecrate_tpu_torch.ops import linalg as tl  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _t(x):
    return torch.from_numpy(np.array(x))


def bumpy_surface(n=800, seed=0):
    """tests/test_features.py's fixture."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.5 * np.sin(xy[:, 0] * 2.5) * np.cos(xy[:, 1] * 1.5)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def _rotation_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


# ------------------------------------------------------- matching


def _descriptors(n, seed, invalid_every=9):
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 1, (n, 33)).astype(np.float32)
    v = np.ones(n, bool)
    v[::invalid_every] = False
    return d, v


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("na,nb", [(300, 400), (8192, 8193)],
                         ids=["one-matmul", "tiled-knn"])
def test_match_descriptors_matches_jax(na, nb, mutual):
    """Both branches: below 2^26 pair products one matmul, above it
    (8192 x 8193) the tiled knn."""
    da, va = _descriptors(na, 1)
    db, vb = _descriptors(nb, 2, invalid_every=7)
    db[:na // 2] = da[:na // 2] + 0.01      # half of a has a clear partner
    jj, jd, jo = (np.asarray(x) for x in jf.match_descriptors(
        jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb),
        mutual=mutual))
    tj, td, to = (x.numpy() for x in tt.match_descriptors(
        _t(da), _t(va), _t(db), _t(vb), mutual=mutual))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tj[va], jj[va])
    np.testing.assert_allclose(td[to] ** 2, jd[jo] ** 2, rtol=0, atol=1e-4)
    assert (~np.isfinite(td[~to])).all()
    assert to.mean() > (0.3 if mutual else 0.8)


# --------------------------------------------------------- kabsch


@pytest.mark.parametrize("noise,atol", [(0.0, 1e-5), (0.01, 2e-4)])
def test_kabsch_batched_matches_jax(noise, atol):
    rng = np.random.default_rng(3)
    h = 64
    src = rng.normal(0, 1, (h, 3, 3)).astype(np.float32)
    rot = np.stack([_rotation_z(a) for a in rng.uniform(-3, 3, h)])
    tgt = (np.einsum("hij,hkj->hki", rot, src) + rng.normal(0, 2, (h, 1, 3))
           + rng.normal(0, noise, (h, 3, 3))).astype(np.float32)
    tgt[0] = src[0] * np.array([1, 1, -1], np.float32)        # a reflection
    w = np.ones((h, 3), np.float32)
    ref = np.asarray(jax.vmap(jl.kabsch)(jnp.asarray(src), jnp.asarray(tgt),
                                         jnp.asarray(w)))
    got = tl.kabsch_batched(_t(src), _t(tgt), _t(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=atol)
    np.testing.assert_allclose(np.linalg.det(got[:, :3, :3]), 1.0, atol=1e-5)


# -------------------------------------------------------- RANSAC


def _correspondences(m=512, seed=4):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    rot, t = _rotation_z(0.7), np.array([1.0, -2.0, 0.5], np.float32)
    tgt = (src @ rot.T + t).astype(np.float32)
    outlier = rng.uniform(0, 1, m) < 0.4
    tgt[outlier] = rng.uniform(-5, 5, (outlier.sum(), 3))
    ok = rng.uniform(0, 1, m) > 0.1
    return src, tgt, ok, rot, t


def test_score_hypotheses_matches_jax():
    """The JAX batch and the port's scoring on the same sample indices."""
    src, tgt, ok, rot, t = _correspondences()
    key = jax.random.PRNGKey(7)
    n_hyp, thresh = 512, 0.05
    ref_t, ref_count = jg._ransac_batch(key, jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(ok), n_hyp, jnp.float32(thresh))
    probs = jnp.asarray(ok).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = np.asarray(jax.random.choice(key, src.shape[0], shape=(n_hyp, 3), p=probs))
    got_t, got_count = tg.score_hypotheses(_t(idx).long(), _t(src), _t(tgt), _t(ok),
                                           thresh)
    assert int(got_count) == int(ref_count)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-5)
    np.testing.assert_allclose(got_t.numpy()[:3, :3], rot, atol=1e-4)
    np.testing.assert_allclose(got_t.numpy()[:3, 3], t, atol=1e-4)


def test_sampling_follows_validity_and_seed():
    _, _, ok, _, _ = _correspondences()
    draw = [tg.sample_hypotheses(torch.Generator().manual_seed(s), _t(ok), 1000)
            for s in (0, 0, 1)]
    assert draw[0].shape == (1000, 3)
    assert ok[draw[0].numpy()].all()
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])


# ---------------------------------------------------- end to end


def _pose_case():
    """tests/test_features.py's global-registration case."""
    pts = bumpy_surface(700, seed=4)
    t_true = (tt.Transform.from_axis_angle([0, 0, 1.0], 0.6)
              @ tt.Transform.from_translation([1.5, -0.8, 0.4])).matrix.numpy()
    tgt = (pts @ t_true[:3, :3].T + t_true[:3, 3]).astype(np.float32)
    return pts, tgt, t_true


_CFG = dict(ransac_iterations=8192, fpfh_radius=0.5, distance_threshold=0.05)


def test_global_registration_recovers_pose():
    pts, tgt, t_true = _pose_case()
    cfg = interop.global_registration_config_from(
        jg.GlobalRegistrationConfig(refine_with_icp=True, **_CFG))
    res = tt.global_registration(tt.PointCloud.from_numpy(pts, device="cpu"),
                                 tt.PointCloud.from_numpy(tgt, device="cpu"), cfg)
    assert bool(res.converged) and res.inlier_count.dtype == torch.int32
    assert 0.5 < float(res.inlier_ratio) <= 1.0
    np.testing.assert_allclose(res.as_transform().matrix.numpy(), t_true, atol=0.05)
    assert float(res.mse) < 1e-4


def test_registration_model_matches_jax():
    pts, tgt, t_true = _pose_case()
    ref = JaxModel(max_iterations=30, **_CFG)(tc.PointCloud.from_numpy(pts),
                                              tc.PointCloud.from_numpy(tgt))
    got = tt.RegistrationModel(max_iterations=30, **_CFG)(
        tt.PointCloud.from_numpy(pts, device="cpu"),
        tt.PointCloud.from_numpy(tgt, device="cpu"))
    np.testing.assert_allclose(got.transformation.numpy(), t_true, atol=0.05)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-3)


def test_too_few_correspondences_rejected():
    pc = tt.estimate_normals(tt.PointCloud.from_numpy(bumpy_surface(20), device="cpu"), k=5)
    res = tt.extract_fpfh_features_with_normals(pc, tt.FpfhConfig(radius=0.5))
    with pytest.raises(tt.InvalidDataError):
        tg.global_registration_with_features(
            pc, pc, res.descriptors, res.valid, res.descriptors,
            torch.zeros_like(res.valid), tt.GlobalRegistrationConfig(ransac_iterations=64))


def test_configs_match_jax():
    assert interop.global_registration_config_from(jg.GlobalRegistrationConfig()) \
        == tt.GlobalRegistrationConfig()
    assert [f for f in tt.GlobalRegistrationConfig.__dataclass_fields__] == \
        [f for f in jg.GlobalRegistrationConfig.__dataclass_fields__]
    assert [f for f in tt.FpfhConfig.__dataclass_fields__] == \
        [f for f in jf.FpfhConfig.__dataclass_fields__]
