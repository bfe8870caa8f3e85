"""Colorization from registered images: the PyTorch port
(``threecrate_tpu_torch.ops.colorization``) against the JAX package on
the CPU.

Stated tolerances: none. The port evaluates the projection as XLA:CPU
does: R·p + t as the first column's product then one fused
multiply-add a column, each pixel coordinate x/z·f + c as one fused
multiply-add, and each sum of the bilinear blend with its last product
fused (``torch.addcmul``), so every point picks JAX's pixel and gets
JAX's colour bit for bit, in both modes and for float and uint8
images, also on noise clouds whose pixel coordinates land within an
ulp of .5 ties (nearest) and of integers (bilinear cells).
``tests/test_mesh_ops.py::TestColorization``'s cases run as they do on
the JAX package there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu import PointCloud as JCloud  # noqa: E402
from threecrate_tpu.core.organized import CameraIntrinsics as JIntrinsics  # noqa: E402
from threecrate_tpu.ops import colorization as jcol  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch.ops import colorization as tcol  # noqa: E402

CPU = {"device": "cpu"}
MODES = ["NEAREST", "BILINEAR"]


def _views(img, intr, w2c):
    return (jcol.RgbImageView(img, JIntrinsics(*intr), w2c),
            tcol.RgbImageView(img, tt.CameraIntrinsics(*intr), w2c))


def _colors(pts, views, mode, many=False, default=(0.0, 0.0, 0.0), mask=None):
    jc = JCloud.from_numpy(pts)
    tcl = tt.PointCloud.from_numpy(pts, **CPU)
    if mask is not None:
        jc = jc.with_mask(jc.mask & np.pad(mask, (0, jc.capacity - len(mask))))
        tcl = tcl.with_mask(tcl.mask & torch.from_numpy(np.pad(mask, (0, tcl.capacity
                                                                      - len(mask)))))
    jm, tm = getattr(jcol.InterpolationMode, mode), getattr(tcol.InterpolationMode, mode)
    if many:
        a = jcol.colorize_from_images(jc, [v[0] for v in views], jm, default)
        b = tcol.colorize_from_images(tcl, [v[1] for v in views], tm, default)
    else:
        a = jcol.colorize_point_cloud(jc, views[0], jm, default)
        b = tcol.colorize_point_cloud(tcl, views[1], tm, default)
    assert b.device.type == "cpu" and b.colors.dtype == torch.float32
    # the packages pad to different capacities: compare the points' rows
    return np.asarray(a.attrs["colors"])[:len(pts)], b.colors.numpy()[:len(pts)]


# ---------------------------------------------------------------------------
# tests/test_mesh_ops.py::TestColorization, on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("u8", [False, True])
def test_single_image_projection(u8):
    img = np.zeros((4, 4, 3), np.float32)
    img[2, 2] = [1.0, 0.0, 0.0]
    if u8:
        img = (img * 255).astype(np.uint8)
    views = _views(img, (4.0, 4.0, 2.0, 2.0), np.eye(4, dtype=np.float32))
    pts = np.array([[0, 0, 1.0], [0, 0, -1.0]], np.float32)
    a, b = _colors(pts, views, "NEAREST")
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(b[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(b[1], [0, 0, 0], atol=1e-6)


@pytest.mark.parametrize("u8", [False, True])
def test_bilinear_blends(u8):
    img = np.zeros((2, 2, 3), np.float32)
    img[:, 1] = 1.0
    if u8:
        img = (img * 255).astype(np.uint8)
    views = _views(img, (1.0, 1.0, 0.5, 0.5), np.eye(4, dtype=np.float32))
    a, b = _colors(np.array([[0, 0, 1.0]], np.float32), views, "BILINEAR")
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(b[0], [0.5, 0.5, 0.5], atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_first_hit_priority(mode):
    eye = np.eye(4, dtype=np.float32)
    views = [_views(np.full((2, 2, 3), 0.25, np.float32), (1.0, 1.0, 0.5, 0.5), eye),
             _views(np.full((2, 2, 3), 0.75, np.float32), (1.0, 1.0, 0.5, 0.5), eye)]
    a, b = _colors(np.array([[0, 0, 1.0]], np.float32), views, mode, many=True)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(b[0], [0.25] * 3, atol=1e-6)


# ---------------------------------------------------------------------------
# noise clouds at the ties
# ---------------------------------------------------------------------------

def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _scene(seed, u8, n=4000, h=48, w=64, tie=0.5):
    """Points placed by back-projecting pixel coordinates within ~1e-6 of
    k + ``tie`` (so the fp32 projection lands on or an ulp beside it),
    plus a quarter of uniform noise, some behind the camera or outside
    the image; a rotated, shifted camera and a random image."""
    rng = np.random.default_rng(seed)
    w2c = np.eye(4)
    w2c[:3, :3] = _rotation(rng)
    w2c[:3, 3] = rng.normal(0, 0.5, 3)
    w2c = w2c.astype(np.float32)
    intr = (50.5, 49.25, 31.7, 23.3)
    u = rng.integers(0, w - 1, n) + tie + rng.normal(0, 1e-6, n)
    v = rng.integers(0, h - 1, n) + tie + rng.normal(0, 1e-6, n)
    z = rng.uniform(0.5, 5, n)
    cam = np.stack([(u - intr[2]) / intr[0] * z, (v - intr[3]) / intr[1] * z, z], -1)
    world = (cam - w2c[:3, 3].astype(np.float64)) @ w2c[:3, :3].astype(np.float64)
    pts = np.concatenate([world, rng.uniform(-20, 20, (n // 4, 3))]).astype(np.float32)
    img = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if u8
           else rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    return pts, img, intr, w2c


@pytest.mark.parametrize("tie", [0.5, 0.0])
@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_noise_cloud_near_ties_is_bit_equal(mode, u8, tie):
    for seed in range(3):
        pts, img, intr, w2c = _scene(seed, u8, tie=tie)
        a, b = _colors(pts, _views(img, intr, w2c), mode)
        np.testing.assert_array_equal(b, a)
        assert (a != 0).any(1).mean() > 0.5


@pytest.mark.parametrize("mode", MODES)
def test_many_views_defaults_and_masks_are_bit_equal(mode):
    """Six views of one noise cloud (earlier views win), a grey default
    colour and a third of the points masked out."""
    pts, _, intr, _ = _scene(7, True)
    views = [_views(*_scene(10 + i, i % 2 == 0)[1:]) for i in range(6)]
    mask = np.random.default_rng(8).uniform(size=len(pts)) > 0.3
    a, b = _colors(pts, views, mode, many=True, default=(0.5, 0.25, 0.125), mask=mask)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(b[~mask], np.tile([0.5, 0.25, 0.125], ((~mask).sum(), 1)))


def test_tensor_inputs_and_normalized_image():
    """Images and extrinsics may be tensors; uint8 images normalise to
    [0, 1] float32 as the JAX package's do."""
    pts, img, intr, w2c = _scene(3, True, n=500)
    jv, tv = _views(img, intr, w2c)
    np.testing.assert_array_equal(tv.normalized_image().numpy(),
                                  np.asarray(jv.normalized_image()))
    tv2 = tcol.RgbImageView(torch.from_numpy(img), tt.CameraIntrinsics(*intr),
                            torch.from_numpy(w2c))
    cloud = tt.PointCloud.from_numpy(pts, **CPU)
    for mode in tcol.InterpolationMode:
        np.testing.assert_array_equal(tcol.colorize_point_cloud(cloud, tv2, mode).colors.numpy(),
                                      tcol.colorize_point_cloud(cloud, tv, mode).colors.numpy())
    assert tcol.colorize_from_images(cloud, []).colors.abs().sum() == 0


def test_root_names_are_the_module():
    for name in ("InterpolationMode", "RgbImageView", "colorize_from_images",
                 "colorize_point_cloud"):
        assert getattr(tt, name) is getattr(tcol, name) and name in tt.__all__
    assert [m.value for m in tcol.InterpolationMode] == [m.value for m in jcol.InterpolationMode]
