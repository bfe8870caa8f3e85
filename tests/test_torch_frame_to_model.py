"""Frame-to-model tracking and ``FrameToModelOdometry``: the PyTorch port
(``threecrate_tpu_torch.ops.frame_to_model``) against the JAX package on
the CPU, and the slice as a whole.

The scene is ``tests/test_frame_to_model.py``'s: a 60×80 wavy depth
frame fused into a 16³-block sparse grid, frames raycast from known
poses built with ``Transform.from_euler_xyz`` (JAX's; the port's agree
within 1e-7). ``track`` gets the SAME model maps and frame depth in
both packages (JAX's, through ``interop``), so tracking parity stands
apart from fusion and raycast rounding. Stated tolerances:
- ``track``: the pose within 1e-5 of JAX's (1.8e-7 measured), the
  correspondence count equal, the RMSE within 1e-6 m;
- ``FrameToModelOdometry`` over the JAX test's 4-frame trajectory, each
  package fusing, raycasting and tracking on its own: every pose within
  1e-4 of JAX's (7.8e-7 measured), also with ``model_render_scale=2``
  and ``track_stride=2``; ``render`` within 1e-5 m of JAX's depth on
  the same first frame;
- the config's errors: JAX's messages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu.core.organized import CameraIntrinsics as JaxIntrinsics  # noqa: E402
from threecrate_tpu.core.transform import Transform as JaxTransform  # noqa: E402
from threecrate_tpu.ops import frame_to_model as jf  # noqa: E402
from threecrate_tpu.ops import tsdf_raycast as jrc  # noqa: E402
from threecrate_tpu.ops import tsdf_sparse as jsp  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.core.transform import Transform  # noqa: E402
from threecrate_tpu_torch.ops import frame_to_model as tf  # noqa: E402
from threecrate_tpu_torch.ops import tsdf as tts  # noqa: E402
from threecrate_tpu_torch.ops import tsdf_sparse as tsp  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

H, W = 60, 80
INTR = np.array([70.0, 70.0, W / 2 - 0.5, H / 2 - 0.5], np.float32)
GRID = (16, 16, 16)
VOX = 4.0 / 128
EYE = np.eye(4, dtype=np.float32)
ORIGIN = (-2.0, -2.0, 0.5)
RAY = dict(grid_blocks=GRID, block=8, near=0.6, far=4.0)


def _wavy_depth():
    yy, xx = np.mgrid[0:H, 0:W]
    return (2.0 + 0.3 * np.sin(xx / 10.0) * np.cos(yy / 7.0)
            + 0.1 * np.sin(yy / 5.0)).astype(np.float32)


def _pose(rx=0.0, ry=0.0, rz=0.0, t=(0.0, 0.0, 0.0)):
    """The pose as JAX builds it; the port's is within 1e-7."""
    j = np.asarray(JaxTransform.from_euler_xyz(jnp.asarray([rx, ry, rz], jnp.float32),
                                               jnp.asarray(t, jnp.float32)).matrix)
    p = Transform.from_euler_xyz(torch.tensor([rx, ry, rz]),
                                 torch.tensor(t, dtype=torch.float32)).matrix.numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-7)
    return j


def _port_maps(res):
    return interop.raycast_result_from_numpy(
        *(None if x is None else np.asarray(x) for x in res), device="cpu")


@pytest.fixture(scope="module")
def scene():
    """(JAX volume, model maps from the identity, a frame from the true
    pose, the true pose)."""
    vol = jsp.sparse_integrate(
        jsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=8,
                                 max_blocks=4096),
        jnp.asarray(_wavy_depth()), jnp.asarray(INTR), jnp.asarray(EYE),
        grid_blocks=GRID, block=8)
    truth = _pose(rx=0.02, ry=-0.015, rz=0.01, t=(0.03, -0.02, 0.025))
    frame = jrc.sparse_raycast(vol, jnp.asarray(INTR), jnp.asarray(truth), H, W, **RAY)
    model = jrc.sparse_raycast(vol, jnp.asarray(INTR), jnp.asarray(EYE), H, W, **RAY)
    return vol, model, np.asarray(frame.depth), truth


def _track_both(model, depth, intr, **kw):
    j = jf.track(model, jnp.asarray(EYE), jnp.asarray(depth), jnp.asarray(intr),
                 jnp.asarray(EYE), **{k: (jnp.asarray(v) if k == "model_intr" else v)
                                      for k, v in kw.items()})
    tf.reset_counts()
    t = tf.track(_port_maps(model), EYE, depth, intr, EYE, **kw)
    return j, t


def _pose_err(a, b):
    d = np.linalg.inv(np.asarray(a, np.float64)) @ np.asarray(b, np.float64)
    return (np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)),
            np.linalg.norm(d[:3, 3]))


@pytest.mark.parametrize("case", ["full", "half_res_model", "strided_frame"])
def test_track_matches_jax(scene, case):
    vol, model, depth, truth = scene
    intr, kw = INTR, dict(max_iterations=15)
    if case == "half_res_model":
        mintr = np.array([INTR[0] / 2, INTR[1] / 2, (INTR[2] - 0.5) / 2, (INTR[3] - 0.5) / 2],
                         np.float32)
        model = jrc.sparse_raycast(vol, jnp.asarray(mintr), jnp.asarray(EYE), H // 2, W // 2,
                                   **RAY)
        kw["model_intr"] = mintr
    elif case == "strided_frame":
        depth, intr = depth[::2, ::2], INTR / 2
        kw.update(model_intr=INTR, min_valid_pixels=100)
    j, t = _track_both(model, depth, intr, **kw)
    assert bool(t.converged) and bool(j.converged)
    np.testing.assert_allclose(t.cam_to_world.numpy(), np.asarray(j.cam_to_world), rtol=0,
                               atol=1e-5)
    assert int(t.n_valid) == int(j.n_valid) > 500
    assert float(t.rmse) == pytest.approx(float(j.rmse), abs=1e-6)
    rot, trans = _pose_err(truth, t.cam_to_world.numpy())
    assert rot < 2e-3 and trans < 0.5 * VOX
    assert 1 <= tf.counts["iterations"] <= 15


def test_track_identity_and_lost_match_jax(scene):
    """The fused frame itself stays at the identity; an empty frame is
    lost and keeps the seed, as in JAX."""
    _, model, _, _ = scene
    j, t = _track_both(model, _wavy_depth(), INTR, max_iterations=5)
    np.testing.assert_allclose(t.cam_to_world.numpy(), np.asarray(j.cam_to_world), rtol=0,
                               atol=1e-5)
    rot, trans = _pose_err(EYE, t.cam_to_world.numpy())
    assert rot < 1e-3 and trans < 0.5 * VOX
    j, t = _track_both(model, np.zeros((H, W), np.float32), INTR, max_iterations=5)
    assert not bool(t.converged) and not bool(j.converged)
    assert int(t.n_valid) == 0 and tf.counts["iterations"] == 1
    assert torch.equal(t.cam_to_world, torch.eye(4))


def _trajectory():
    master = jsp.sparse_integrate(
        jsp.create_sparse_volume(VOX, origin=ORIGIN, grid_blocks=GRID, block=8,
                                 max_blocks=4096),
        jnp.asarray(_wavy_depth()), jnp.asarray(INTR), jnp.asarray(EYE),
        grid_blocks=GRID, block=8)
    gt = [EYE] + [_pose(rx=0.008 * i, ry=-0.005 * i, t=(0.012 * i, -0.008 * i, 0.015 * i))
                  for i in range(1, 4)]
    frames = [_wavy_depth()] + [
        np.asarray(jrc.sparse_raycast(master, jnp.asarray(INTR), jnp.asarray(p), H, W,
                                      **RAY).depth) for p in gt[1:]]
    return frames, gt


@pytest.mark.parametrize("knobs", [{}, {"model_render_scale": 2},
                                   {"model_render_scale": 2, "track_stride": 2}],
                         ids=["default", "scale2", "scale2_stride2"])
def test_odometry_trajectory_matches_jax(knobs):
    """tests/test_frame_to_model.py's 4-frame trajectory through both
    packages' ``FrameToModelOdometry``: poses within 1e-4 of JAX's and
    within the JAX test's bounds of the truth."""
    frames, gt = _trajectory()
    cfg = dict(far=4.0, near=0.6, **knobs)
    kw = dict(voxel_size=VOX, origin=ORIGIN, grid_blocks=GRID, block=8, max_blocks=4096)
    jo = jf.FrameToModelOdometry(JaxIntrinsics(70.0, 70.0, W / 2 - 0.5, H / 2 - 0.5), H, W,
                                 config=jf.FrameToModelConfig(**cfg), **kw)
    to = tt.FrameToModelOdometry(tt.CameraIntrinsics(70.0, 70.0, W / 2 - 0.5, H / 2 - 0.5),
                                 H, W, config=tt.FrameToModelConfig(**cfg), device="cpu", **kw)
    for i, (f, true) in enumerate(zip(frames, gt)):
        pj = np.asarray(jo.register_frame(jnp.asarray(f)).matrix)
        pt = to.register_frame(f).matrix
        assert pt.device.type == "cpu" and to.pose is pt
        np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-4, err_msg=f"frame {i}")
        rot, trans = _pose_err(true, pt.numpy())
        assert rot < 5e-3 and trans < 1.5 * VOX, (i, rot, trans)
    ts = knobs.get("track_stride", 1)
    assert to.n_frames == 4 and int(to.last_track.n_valid) > 1000 // ts ** 2
    assert abs(int(to.last_track.n_valid) - int(jo.last_track.n_valid)) <= 0.01 * int(
        jo.last_track.n_valid)
    assert int(to.volume.n_blocks) == int(jo.volume.n_blocks)


def test_render_matches_jax():
    """One frame fused from the identity, rendered back: the volumes are
    equal, so the maps agree as raycasts of one volume do."""
    kw = dict(voxel_size=VOX, origin=ORIGIN, grid_blocks=GRID, block=8, max_blocks=4096,
              config=None)
    jo = jf.FrameToModelOdometry(INTR, H, W, **{**kw, "config": jf.FrameToModelConfig(
        far=4.0, near=0.6)})
    to = tt.FrameToModelOdometry(INTR, H, W, device="cpu", **{**kw, "config":
                                                              tt.FrameToModelConfig(
                                                                  far=4.0, near=0.6)})
    depth = _wavy_depth()
    jo.register_frame(jnp.asarray(depth))
    to.register_frame(depth)
    np.testing.assert_array_equal(to.volume.block_keys.numpy(),
                                  np.asarray(jo.volume.block_keys))
    jr, tr = jo.render(), to.render()
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    np.testing.assert_allclose(tr.depth.numpy(), np.asarray(jr.depth), rtol=0, atol=1e-5)
    m = tr.mask.numpy()
    assert m[10:-10, 10:-10].mean() > 0.9
    assert np.median(np.abs(tr.depth.numpy() - depth)[m]) < 0.5 * VOX
    moved = _pose(t=(0.02, 0.0, 0.0))
    np.testing.assert_allclose(to.render(moved).depth.numpy(),
                               np.asarray(jo.render(jnp.asarray(moved)).depth), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("field, value", [
    ("max_iterations", 0), ("model_render_scale", 0), ("track_stride", 0),
    ("dist_gate", -1.0), ("dist_gate", 0.0), ("update_fraction", 0.0),
    ("update_fraction", 1.5)])
def test_config_errors_match_jax(field, value):
    with pytest.raises(ValueError) as j:
        jf.FrameToModelConfig(**{field: value})
    with pytest.raises(ValueError) as t:
        tt.FrameToModelConfig(**{field: value})
    assert str(t.value) == str(j.value)


def test_config_defaults_and_carrier_match_jax():
    j = jf.FrameToModelConfig(max_iterations=7, track_stride=2, update_fraction=0.25)
    assert interop.frame_to_model_config_from(j) == tt.FrameToModelConfig(
        max_iterations=7, track_stride=2, update_fraction=0.25)
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(tt.FrameToModelConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jf.FrameToModelConfig)]


@pytest.mark.parametrize("make", [
    lambda: tts.create_volume((4, 4, 4), 0.1),
    lambda: tsp.create_sparse_volume(0.1, grid_blocks=(2, 2, 2), max_blocks=4),
    lambda: tt.FrameToModelOdometry(INTR, H, W, grid_blocks=(2, 2, 2), max_blocks=4)],
    ids=["create_volume", "create_sparse_volume", "FrameToModelOdometry"])
def test_default_device_is_the_card(make):
    """Volumes and the odometry are built on the card by default: without
    CUDA, torch's own error comes through (no CPU fallback)."""
    if torch.cuda.is_available():
        out = make()
        assert (out.volume if hasattr(out, "volume") else out).tsdf.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


ROOT_NAMES = ["TsdfVolume", "create_tsdf_volume", "tsdf_extract_surface", "tsdf_integrate",
              "tsdf_integrate_sequence", "tsdf_extract_surface_banded", "SparseTsdfVolume",
              "create_sparse_tsdf_volume", "sparse_tsdf_extract_surface",
              "sparse_tsdf_integrate", "sparse_tsdf_marching_cubes_soup",
              "sparse_tsdf_to_dense", "RaycastResult", "tsdf_raycast", "tsdf_shade",
              "tsdf_shade_rgb", "sparse_tsdf_raycast", "FrameToModelConfig",
              "FrameToModelOdometry", "TrackResult", "track_frame_to_model",
              "CameraIntrinsics", "OrganizedPointCloud"]


@pytest.mark.parametrize("name", ROOT_NAMES)
def test_root_names_match_jax(name):
    """The root names the JAX package exports for this slice, under the
    same aliases, bound to the port's function or type of the same
    name."""
    import threecrate_tpu as tc

    j, t = getattr(tc, name), getattr(tt, name)
    assert name in tt.__all__
    assert t.__name__ == j.__name__
