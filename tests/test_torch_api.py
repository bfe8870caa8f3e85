"""The port's flat surface (``api``, the root package, ``prelude``) against
the JAX package's, on the CPU.

``tests/test_api.py``'s ``TestSurface`` on the port, with ``__all__``
equal as sets to JAX's ``api.__all__``; its ``TestEndToEndBunnySlice``
(read → voxel → normals → ICP self-align → write) run on both packages,
each stage compared; the three helpers of ``api.py`` and the prelude's
names. Stated tolerances: the voxel grid's centroids within 1e-6 and
the same count, normals within 1e-4 (the eigensolve's last bits), the
ICP pose within 1e-6 of JAX's, transformed points within 1e-6, the PLY
files byte-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu as tc  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402

from conftest import make_sphere_points  # noqa: E402
from test_api import REFERENCE_SURFACE  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


class TestSurface:
    def test_every_reference_symbol_exists(self):
        missing = [s for s in REFERENCE_SURFACE if not hasattr(tt, s)]
        assert not missing, f"missing API symbols: {missing}"

    def test_all_equals_jax(self):
        """``api.__all__`` names JAX's 187 names, derived as JAX derives
        it; the root exports all of them beside its own extras."""
        assert set(tt.api.__all__) == set(tc.api.__all__)
        assert len(tt.api.__all__) == len(tc.api.__all__)
        assert set(tt.api.__all__) <= set(tt.__all__)
        assert set(tc.__all__) <= set(tt.__all__)
        for name in tt.api.__all__:
            assert getattr(tt, name) is getattr(tt.api, name)
            jv, tv = getattr(tc, name), getattr(tt, name)
            assert type(tv) is type(jv) or (callable(tv) and callable(jv)), name

    def test_numpy_coercion(self, rng):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        out = tt.voxel_downsample(pts, 0.5, device="cpu")
        assert isinstance(out, tt.PointCloud) and out.device.type == "cpu"
        np.testing.assert_allclose(out.to_numpy(), tc.voxel_downsample(pts, 0.5).to_numpy(),
                                   atol=1e-6, rtol=0)

    def test_transform_point_cloud(self):
        pts = np.array([[1, 0, 0]], np.float32)
        m = np.eye(4)
        m[:3, 3] = [0, 1, 0]
        out = tt.transform_point_cloud(pts, m, device="cpu")
        np.testing.assert_allclose(out.to_numpy(), [[1, 1, 0]], atol=1e-6)


def test_helpers_match_jax(rng):
    """``as_point_cloud`` keeps a cloud (and a typed view's cloud) as it
    is and builds one from an array on ``device``; ``transform_point_cloud``
    and ``voxel_downsample`` on arrays and clouds equal JAX's within
    1e-6."""
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    pc = tt.PointCloud.from_numpy(pts, device="cpu")
    assert tt.as_point_cloud(pc) is pc
    typed = tt.NormalPointCloud.from_numpy(pts, pts, device="cpu")
    assert tt.as_point_cloud(typed) is typed.cloud
    built = tt.as_point_cloud(pts, device="cpu", intensity=pts[:, 0])
    np.testing.assert_array_equal(built.to_numpy(), tc.as_point_cloud(pts).to_numpy())
    np.testing.assert_array_equal(built.attr_to_numpy("intensity"), pts[:, 0])
    m = np.array(tc.Transform.from_axis_angle(np.float32([0.2, -0.4, 1.0]), 0.7).matrix)
    m[:3, 3] = [0.5, -1.0, 2.0]
    for src in (pts, pc):
        got = tt.transform_point_cloud(src, m, device="cpu")
        np.testing.assert_allclose(got.to_numpy(), tc.transform_point_cloud(pts, m).to_numpy(),
                                   atol=1e-6, rtol=0)
        down = tt.voxel_downsample(src, 0.3, device="cpu")
        np.testing.assert_allclose(down.to_numpy(), tc.voxel_downsample(pts, 0.3).to_numpy(),
                                   atol=1e-6, rtol=0)


def test_prelude_names_match_jax():
    """``from threecrate_tpu_torch.prelude import *`` brings JAX's 33
    prelude names into scope, each bound to the port's root object."""
    from threecrate_tpu import prelude as jp
    from threecrate_tpu_torch import prelude as tp
    assert tp.__all__ == jp.__all__ and len(tp.__all__) == 33
    scope = {}
    exec("from threecrate_tpu_torch.prelude import *", scope)
    for name in tp.__all__:
        assert scope[name] is getattr(tt, name), name


class TestEndToEndBunnySlice:
    """BASELINE.json config #1: read → voxel(0.05) → normals(k=10) →
    ICP self-align → write, each stage on both packages."""

    def test_full_slice(self, tmp_path):
        pts = make_sphere_points(2000, radius=0.5)
        src_path = tmp_path / "bunnyish.ply"
        tt.write_point_cloud(src_path, tt.PointCloud.from_numpy(pts, device="cpu"))
        jsrc = tmp_path / "bunnyish_jax.ply"
        tc.write_point_cloud(jsrc, tc.PointCloud.from_numpy(pts))
        assert src_path.read_bytes() == jsrc.read_bytes()

        cloud = tt.read_point_cloud(src_path, device="cpu")
        jcloud = tc.read_point_cloud(src_path)
        np.testing.assert_array_equal(cloud.to_numpy(), jcloud.to_numpy())
        down = tt.voxel_grid_filter(cloud, 0.05)
        jdown = tc.voxel_grid_filter(jcloud, 0.05)
        assert len(down) == len(jdown)
        np.testing.assert_allclose(down.to_numpy(), jdown.to_numpy(), atol=1e-6, rtol=0)
        with_n = tt.estimate_normals(down, k=10)
        jwith_n = tc.estimate_normals(jdown, k=10)
        np.testing.assert_allclose(with_n.attr_to_numpy("normals"),
                                   jwith_n.attr_to_numpy("normals"), atol=1e-4, rtol=0)
        res = tt.icp(with_n, with_n, max_iterations=10)
        jres = tc.icp(jwith_n, jwith_n, max_iterations=10)
        assert bool(res.converged) and bool(jres.converged)
        np.testing.assert_allclose(np.asarray(res.transformation), np.eye(4), atol=1e-4)
        np.testing.assert_allclose(res.transformation(), np.asarray(jres.transformation),
                                   atol=1e-6, rtol=0)
        out_path = tmp_path / "out.ply"
        tt.write_point_cloud(out_path, with_n)
        back = tt.read_point_cloud(out_path, device="cpu")
        assert "normals" in back.attrs
        assert len(back) == len(with_n)
        jout = tmp_path / "out_jax.ply"
        tc.write_point_cloud(jout, tc.read_point_cloud(out_path))
        assert jout.read_bytes() == out_path.read_bytes()
