"""PerceptionStep, the slice as a whole: the PyTorch port against the
JAX package on the same scan pair.

Stated tolerances: translation and rotation entries within 1e-4, MSE
within 1e-2 relative, >= 99% of valid normals within 1° of the JAX
normal (sign included).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu.models import PerceptionStep as JaxStep  # noqa: E402
from threecrate_tpu.ops import normals as jn  # noqa: E402
from threecrate_tpu.ops import registration as jr  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import kernels  # noqa: E402
from threecrate_tpu_torch.ops import normals as tn  # noqa: E402
from threecrate_tpu_torch.ops import registration as tr  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

SHIFT = np.array([0.05, -0.03, 0.02], np.float32)


def _pair(n, seed, scan):
    rng = np.random.default_rng(seed)
    if scan:
        from bench import _kitti_like
        src = _kitti_like(n, seed)
    else:
        xy = rng.uniform(-2, 2, (n, 2))
        z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
        src = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    tgt = (src + SHIFT + rng.normal(0, 0.005, src.shape)).astype(np.float32)
    return src, tgt, np.ones(n, bool)


def _compare(jres, tres):
    np.testing.assert_allclose(tres.transform.numpy(), np.asarray(jres.transform),
                               atol=1e-4)
    np.testing.assert_allclose(float(tres.mse), float(jres.mse), rtol=1e-2)
    jnrm, tnrm = np.asarray(jres.normals), tres.normals.numpy()
    valid = np.linalg.norm(jnrm, axis=1) > 0
    np.testing.assert_array_equal(np.linalg.norm(tnrm, axis=1) > 0, valid)
    ang = np.degrees(np.arccos(np.clip((jnrm[valid] * tnrm[valid]).sum(1), -1, 1)))
    assert np.mean(ang < 1.0) >= 0.99, np.quantile(ang, [0.5, 0.99])
    np.testing.assert_allclose(np.linalg.norm(tnrm[valid], axis=1), 1.0, atol=1e-5)
    assert tres.curvature.shape == (len(jnrm),)


@pytest.fixture
def kernel_paths(monkeypatch):
    """Both size thresholds lowered in BOTH packages so the union and
    static-sort paths (the port's kernels) run at 16,640 points. The JAX
    step reads them while tracing, so its caches are dropped before and
    after: no trace made here outlives the patch."""
    for mod in (jn, tn):
        monkeypatch.setattr(mod, "AUTO_WINDOW_THRESHOLD", 4096)
    for mod in (jr, tr):
        monkeypatch.setattr(mod, "CORRESPONDENCE_WINDOW_THRESHOLD", 2 ** 20)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_slice_on_kernel_paths(kernel_paths):
    src, tgt, mask = _pair(16_640, 0, scan=True)
    jres = JaxStep(k=10, max_iterations=10)(src, mask, tgt, mask)
    tres = tt.PerceptionStep(k=10, max_iterations=10, device="cpu")(
        src, mask, tgt, mask)
    _compare(jres, tres)
    np.testing.assert_allclose(tres.transform.numpy()[:3, 3], SHIFT, atol=1e-3)


def test_slice_on_exact_paths():
    """2,048 points with the default thresholds: exact kNN normals and
    brute-force ICP, as tests/test_models.py runs the JAX step."""
    src, tgt, mask = _pair(2048, 1, scan=False)
    kernels.reset_launch_counts()
    jres = JaxStep(k=10, max_iterations=20)(src, mask, tgt, mask)
    tres = tt.PerceptionStep(k=10, max_iterations=20, device="cpu")(
        src, mask, tgt, mask)
    _compare(jres, tres)
    assert float(tres.mse) < 1e-4
    assert sum(kernels.launch_counts().values()) == 0


def test_step_keeps_its_device():
    src, tgt, mask = _pair(512, 2, scan=False)
    step = tt.PerceptionStep(k=8, max_iterations=3, device="cpu")
    res = step(torch.from_numpy(src), torch.from_numpy(mask), tgt, mask)
    assert all(t.device.type == "cpu" for t in res)
    assert res.transform.shape == (4, 4) and res.normals.shape == (512, 3)
    assert (step.k, step.max_iterations, step.conv_thresh) == (8, 3, 1e-6)
