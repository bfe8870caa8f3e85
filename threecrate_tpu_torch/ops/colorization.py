"""Point-cloud colorization from registered RGB images.

Counterpart of ``threecrate_tpu.ops.colorization`` (the rework of
threecrate-algorithms/src/colorization.rs): project every point through
a world→camera isometry and pinhole intrinsics, bounds/z>0 test,
nearest or bilinear sampling, multi-image first-hit priority
(colorize_from_images, colorization.rs:261). One projection is a
``(N, 3) × (3, 3)`` product in full fp32 and gathers over the whole
cloud per image, as plain tensor ops on the cloud's device.

A pixel coordinate x/z·f + c is one fused multiply-add
(``torch.addcmul``), as XLA contracts it, so that the rounding and the
floor pick the same pixel on the card, on the CPU and in the JAX
package; the bilinear blend fuses its last product into each sum for
the same reason.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import torch

from ..core.organized import CameraIntrinsics
from ..core.point_cloud import PointCloud


class InterpolationMode(enum.Enum):
    """colorization.rs:134."""

    NEAREST = "nearest"
    BILINEAR = "bilinear"


@dataclasses.dataclass(frozen=True)
class RgbImageView:
    """An RGB image + its camera (colorization.rs:49).

    image: (H, W, 3) float32 in [0,1] or uint8 (array or tensor).
    world_to_camera: (4, 4) extrinsics.
    """

    image: object
    intrinsics: CameraIntrinsics
    world_to_camera: object

    def normalized_image(self) -> torch.Tensor:
        return _float_image(torch.as_tensor(self.image))


def _float_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 images over 255, as float32; float images as float32."""
    if img.dtype == torch.uint8:
        # a divisor on the image's device: CUDA multiplies by the
        # reciprocal of a host scalar, which rounds differently
        return img.to(torch.float32) / torch.tensor(255.0, device=img.device)
    return img.to(torch.float32)


def _view_inputs(view: RgbImageView, device):
    """The view's normalised image (uploaded as it is stored),
    intrinsics and extrinsics on ``device``."""
    intr = torch.tensor([view.intrinsics.fx, view.intrinsics.fy,
                         view.intrinsics.cx, view.intrinsics.cy],
                        dtype=torch.float32, device=device)
    w2c = torch.as_tensor(view.world_to_camera).to(device, torch.float32)
    return _float_image(torch.as_tensor(view.image).to(device)), intr, w2c


def _camera_frame(points: torch.Tensor, w2c: torch.Tensor) -> torch.Tensor:
    """R·p + t as XLA:CPU evaluates the product: the first column's
    product, then one FMA a column, then the translation; the same
    elementwise operations on every device (a library product's
    summation order varies with the device)."""
    r = w2c[:3, :3]
    cam = torch.addcmul(points[:, :1] * r[:, 0], points[:, 1:2], r[:, 1])
    return torch.addcmul(cam, points[:, 2:3], r[:, 2]) + w2c[:3, 3]


def _project(points, mask, intr, w2c, h, w):
    """Each point's pixel coordinates (u, v) in an (h, w) image and
    whether it lands in the image, in front of the camera."""
    cam = _camera_frame(points, w2c)
    z = cam[:, 2]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    zc = torch.clamp_min(z, 1e-9)
    u = torch.addcmul(cx, cam[:, 0] / zc, fx)
    v = torch.addcmul(cy, cam[:, 1] / zc, fy)
    inside = mask & (z > 1e-6) & (u >= 0) & (u <= w - 1) & \
        (v >= 0) & (v <= h - 1)
    return u, v, inside


def _project_sample(points, mask, img, intr, w2c, h, w, bilinear):
    u, v, inside = _project(points, mask, intr, w2c, h, w)
    if bilinear:
        u0 = torch.clamp(torch.floor(u).to(torch.int32), 0, w - 2)
        v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, h - 2)
        du = torch.clamp(u - u0, 0.0, 1.0)[:, None]
        dv = torch.clamp(v - v0, 0.0, 1.0)[:, None]
        u0, v0 = u0.long(), v0.long()
        c00 = img[v0, u0]
        c01 = img[v0, u0 + 1]
        c10 = img[v0 + 1, u0]
        c11 = img[v0 + 1, u0 + 1]
        # c00·(1-du)·(1-dv) + c01·du·(1-dv) + c10·(1-du)·dv + c11·du·dv,
        # each sum fusing the product on its left, as XLA contracts it
        color = torch.addcmul(c01 * du * (1 - dv), c00 * (1 - du), 1 - dv)
        color = torch.addcmul(color, c10 * (1 - du), dv)
        color = torch.addcmul(color, c11 * du, dv)
    else:
        ui = torch.clamp(torch.round(u).to(torch.int32), 0, w - 1).long()
        vi = torch.clamp(torch.round(v).to(torch.int32), 0, h - 1).long()
        color = img[vi, ui]
    return color, inside


def colorize_point_cloud(cloud: PointCloud, view: RgbImageView,
                         mode: InterpolationMode = InterpolationMode.NEAREST,
                         default_color=(0.0, 0.0, 0.0)) -> PointCloud:
    """Colorize from a single registered image (colorize_point_cloud,
    colorization.rs:217)."""
    img, intr, w2c = _view_inputs(view, cloud.device)
    h, w = img.shape[:2]
    color, inside = _project_sample(
        cloud.points, cloud.mask, img, intr, w2c, h, w,
        mode == InterpolationMode.BILINEAR)
    base = torch.tensor(default_color, dtype=torch.float32,
                        device=cloud.device).expand(color.shape)
    out = torch.where(inside[:, None], color, base)
    return cloud.with_colors(out)


def colorize_from_images(cloud: PointCloud, views: Sequence[RgbImageView],
                         mode: InterpolationMode = InterpolationMode.NEAREST,
                         default_color=(0.0, 0.0, 0.0)) -> PointCloud:
    """Multi-image colorization with first-hit priority
    (colorize_from_images, colorization.rs:261): earlier views win."""
    dev = cloud.device
    colors = torch.tensor(default_color, dtype=torch.float32,
                          device=dev).expand(cloud.capacity, 3)
    assigned = torch.zeros((cloud.capacity,), dtype=torch.bool, device=dev)
    for view in views:
        img, intr, w2c = _view_inputs(view, dev)
        h, w = img.shape[:2]
        c, inside = _project_sample(
            cloud.points, cloud.mask, img, intr, w2c, h, w,
            mode == InterpolationMode.BILINEAR)
        take = inside & ~assigned
        colors = torch.where(take[:, None], c, colors)
        assigned = assigned | take
    return cloud.with_colors(colors)
