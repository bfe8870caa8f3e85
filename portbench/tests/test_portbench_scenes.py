"""The scan generators: sizes, determinism, the truth of a pair, and the
HDL-64E beam model's return count and geometry."""

import math

import pytest
import torch

from portbench import scenes

HDL64 = {"kind": "hdl64", "beams": 64, "elevation_deg": [2.0, -24.8], "azimuth_step_deg": 0.17,
         "mount_height_m": 1.73, "range_m": [2.0, 120.0], "range_noise_m": 0.02,
         "boxes": 40, "box_m": [4.5, 2.0, 1.5], "road_x_m": [-7.0, -5.0]}
SENSOR = {"of": "sensor", "yaw_rad": [-0.17, 0.17], "translation_m": [[10.0, 12.0], [0, 0], [0, 0]]}
POINTS = {"of": "points", "yaw_rad": [0.35, 0.35], "translation_m": [[2.0, 2.0], [-1.5, -1.5],
                                                                     [0.3, 0.3]]}


def test_ring_pairs_are_seeded_and_true():
    a = scenes.make_pairs({"kind": "ring", "points": 5000}, POINTS, 2, 2 ** 31 + 99, "cpu")
    b = scenes.make_pairs({"kind": "ring", "points": 5000}, POINTS, 2, 2 ** 31 + 99, "cpu")
    c = scenes.make_pairs({"kind": "ring", "points": 5000}, POINTS, 2, 2 ** 31 + 98, "cpu")
    assert all(torch.equal(x.target, y.target) for x, y in zip(a, b))
    assert not torch.equal(a[0].target, c[0].target)
    assert not torch.equal(a[0].target, a[1].target)
    p = a[0]
    assert p.target.shape == (5000, 3) and p.target.dtype == torch.float32
    r = torch.linalg.vector_norm(p.target[:, :2], dim=1)
    assert float(r.min()) >= 2.0 and 0.25 < float((p.target[:, 2] > 0.2).float().mean()) < 0.35
    moved = p.target @ torch.tensor([[math.cos(0.35), -math.sin(0.35), 0],
                                     [math.sin(0.35), math.cos(0.35), 0], [0, 0, 1]]).T
    assert (p.source - moved - torch.tensor([2.0, -1.5, 0.3])).abs().max() < 1e-4
    assert (scenes.apply(p.truth.double(), p.source) - p.target).abs().max() < 1e-4


def test_pose_error():
    t = scenes.pose(0.2, [1.0, 2.0, 3.0])
    e = scenes.pose(0.2 + 1e-3, [1.0, 2.0, 3.5])
    dt, dr = scenes.pose_error(e, t)
    assert dt == pytest.approx(0.5) and dr == pytest.approx(1e-3, rel=1e-6)


@pytest.fixture(scope="module")
def hdl_pair():
    return scenes.make_pairs(HDL64, SENSOR, 1, 2 ** 31 + 5, "cpu")[0]


def test_hdl64_return_count(hdl_pair):
    rays = 64 * round(360 / 0.17)
    for scan in (hdl_pair.source, hdl_pair.target):
        assert 115_000 < scan.shape[0] < 128_000 < rays


def test_hdl64_geometry(hdl_pair):
    scan = hdl_pair.target.double()
    rng = torch.linalg.vector_norm(scan, dim=1)
    assert float(rng.min()) >= 2.0 - 0.1 and float(rng.max()) <= 120.0 + 0.1
    el = torch.rad2deg(torch.asin(scan[:, 2] / rng))
    assert float(el.max()) < 2.0 + 0.1 and float(el.min()) > -24.8 - 0.1
    ground = scan[:, 2] < -1.6
    assert float((scan[ground, 2] + 1.73).abs().median()) < 0.01
    assert 0.05 < 1 - float(ground.double().mean()) < 0.4
    # the nearest ground ring lies where the lowest beam meets the ground
    assert float(torch.linalg.vector_norm(scan[ground, :2], dim=1).min()) == pytest.approx(
        1.73 / math.tan(math.radians(24.8)), abs=0.1)


def test_hdl64_pair_truth(hdl_pair):
    dt, _ = scenes.pose_error(torch.eye(4), hdl_pair.truth)
    assert 10.0 <= dt <= 12.0
    world_src = scenes.apply(hdl_pair.truth.double(), hdl_pair.source)
    box_src = world_src[world_src[:, 2] > -1.0]
    box_tgt = hdl_pair.target[hdl_pair.target[:, 2] > -1.0]
    d = torch.cdist(box_src[:2000].double(), box_tgt.double()).min(1).values
    assert float(d.median()) < 0.3


def test_hdl64_points_motion_moves_the_sweep():
    p = scenes.make_pairs(HDL64, POINTS, 1, 2 ** 31 + 6, "cpu")[0]
    assert p.source.shape == p.target.shape
    assert (scenes.apply(p.truth.double(), p.source) - p.target).abs().max() < 1e-4


def test_a_scene_kind_is_found_by_name():
    assert scenes.kind("ring").ring_scan(10, torch.Generator().manual_seed(1), "cpu").shape == (10, 3)
    with pytest.raises(ValueError, match="unknown scene kind"):
        scenes.make_pairs({"kind": "no-such-kind"}, POINTS, 1, 1, "cpu")
    with pytest.raises(ValueError, match="motion is of the points"):
        scenes.make_pairs({"kind": "ring", "points": 10}, SENSOR, 1, 1, "cpu")
