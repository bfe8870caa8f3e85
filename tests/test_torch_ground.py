"""Patchwork++ ground segmentation: the PyTorch port
(``threecrate_tpu_torch.ops.ground``) against the JAX package.

The clouds are ``TestPatchwork``'s street (``tests/test_segmentation.py``:
ground ring at −1.723 m with 3 cm noise, box objects above it; seeds 0
and 3), the street shifted by ±100 m and ±20 m in x and y, and a
16,384-point LiDAR-like scan lowered by the sensor height. Stated
tolerances:
- ``_patch_ids``: equal on >= 99.99% of points, and every differing
  point within 1e-6 rad of a sector edge or 1e-6 m of a ring edge
  (``torch.atan2`` and XLA's may differ by an ulp);
- ``_rgpf`` on JAX's own patch ids: ``patch_valid`` equal, the patch
  normals within 1e-5 on >= 99% of the valid patches and within 1e-3 on
  all (the per-patch moments are summed in another order, and a patch of
  a dozen points magnifies that), ``ground_mask`` equal on >= 99.9% of
  points;
- ``patchwork_plus_plus`` and ``segment_ground``: the same, end to end.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu import PointCloud  # noqa: E402
from threecrate_tpu.ops import ground as jgr  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import ground as tgr  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

SENSOR_H = 1.723


def _street(seed=0, n_ground=20000, n_obj=800):
    """``TestPatchwork._street``: (points, ground labels)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_ground)
    r = rng.uniform(2.8, 60, n_ground)
    h = -SENSOR_H
    gpts = np.stack([r * np.cos(ang), r * np.sin(ang), h + rng.normal(0, 0.03, n_ground)], -1)
    objs = []
    for cx, cy in rng.uniform(-30, 30, (8, 2)):
        if np.hypot(cx, cy) < 4:
            continue
        objs.append(np.stack([cx + rng.uniform(-1, 1, 100), cy + rng.uniform(-1, 1, 100),
                              h + rng.uniform(0.3, 2.0, 100)], -1))
    opts = np.concatenate(objs)[:n_obj]
    pts = np.concatenate([gpts, opts]).astype(np.float32)
    return pts, np.concatenate([np.ones(n_ground, bool), np.zeros(len(opts), bool)])


def _scan(n, seed):
    """The JAX benchmark's LiDAR-like scan (ground at z ≈ 0, 30% lifted up
    to 4 m), lowered by the sensor height."""
    from bench import _kitti_like
    pts = _kitti_like(n, seed)
    pts[:, 2] -= SENSOR_H
    return pts


CLOUDS = {
    "street0": lambda: _street(0)[0],
    "street3": lambda: _street(3)[0],
    "street+100": lambda: _street(0)[0] + np.float32([100, 100, 0]),
    "street-100": lambda: _street(0)[0] + np.float32([-100, 100, 0]),
    "street+20": lambda: _street(0)[0] + np.float32([20, -20, 0]),
    "scan": lambda: _scan(16384, 4),
}


def _clouds(pts):
    jc = PointCloud.from_numpy(pts)
    return jc, interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask), device="cpu")


def _assert_rgpf_close(jres, tres):
    """(ground, patch_valid, patch_normals) of both packages."""
    jg, jv, jn = (np.asarray(x) for x in jres)
    tg, tv, tn = (x.numpy() for x in tres)
    np.testing.assert_array_equal(tv, jv)
    err = np.abs(tn - jn).max(1)[jv]    # no valid patch beyond 80 m
    assert err.size == 0 or (np.mean(err <= 1e-5) >= 0.99 and (err <= 1e-3).all()), \
        np.sort(err)[-3:]
    assert np.mean(tg == jg) >= 0.999


@pytest.mark.parametrize("name", list(CLOUDS))
def test_patch_ids_match_jax(name):
    cfg = jgr.PatchworkConfig()
    jc, tc = _clouds(CLOUDS[name]())
    tables = jgr._patch_tables(cfg)
    jp = np.asarray(jgr._patch_ids(jc.points, jc.mask, *(jnp.asarray(t) for t in tables),
                                   len(cfg.rings_per_zone)))
    tp = tgr._patch_ids(tc.points, tc.mask, *(torch.from_numpy(t) for t in tables),
                        len(cfg.rings_per_zone)).numpy()
    differ = tp != jp
    assert np.mean(~differ) >= 0.9999
    if differ.any():
        p = np.asarray(jc.points, np.float64)[differ]
        theta = np.arctan2(p[:, 1], p[:, 0]) + np.pi
        r = np.hypot(p[:, 0], p[:, 1])
        edges_r = np.concatenate([np.linspace(a, b, n + 1) for a, b, n in zip(
            cfg.zone_radii[:-1], cfg.zone_radii[1:], cfg.rings_per_zone)])
        gap_t = np.min([np.abs(theta - 2 * math.pi * np.arange(n + 1)[:, None] / n).min(0)
                        for n in set(cfg.sectors_per_zone)], 0)
        gap_r = np.abs(r[:, None] - edges_r[None]).min(1)
        assert ((gap_t <= 1e-6) | (gap_r <= 1e-6)).all()


@pytest.mark.parametrize("name", ["street0", "street3", "street+20", "scan"])
def test_rgpf_on_jax_patch_ids_matches_jax(name):
    """Region-wise fitting alone, both packages fed JAX's patch ids."""
    cfg = jgr.PatchworkConfig()
    jc, tc = _clouds(CLOUDS[name]())
    tables = jgr._patch_tables(cfg)
    pid = jgr._patch_ids(jc.points, jc.mask, *(jnp.asarray(t) for t in tables),
                         len(cfg.rings_per_zone))
    args = (cfg.n_patches, cfg.num_iterations)
    params = (cfg.seed_fraction, cfg.min_seed_points, cfg.distance_threshold,
              cfg.uprightness_threshold, cfg.elevation_threshold, cfg.flatness_threshold,
              cfg.min_patch_points, cfg.sensor_height)
    jres = jgr._rgpf(jc.points, pid, *args,
                     *(jnp.float32(x) if isinstance(x, float) else x for x in params))
    tres = tgr._rgpf(tc.points, torch.from_numpy(np.array(pid)), *args, *params)
    _assert_rgpf_close(jres, tres)
    assert np.asarray(jres[1]).sum() > 0


@pytest.mark.parametrize("name", list(CLOUDS))
def test_patchwork_plus_plus_matches_jax(name):
    jc, tc = _clouds(CLOUDS[name]())
    jres = jgr.patchwork_plus_plus(jc)
    tres = tgr.patchwork_plus_plus(tc)
    _assert_rgpf_close((jres.ground_mask, jres.patch_valid, jres.patch_normals),
                       (tres.ground_mask, tres.patch_valid, tres.patch_normals))
    np.testing.assert_array_equal(tres.nonground_mask.numpy(),
                                  tc.mask.numpy() & ~tres.ground_mask.numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_segment_ground_matches_jax(seed):
    """``TestPatchwork``'s split, with its recall and precision bounds on
    the port."""
    pts, truth = _street(seed)
    jc, tc = _clouds(pts)
    jg, jng = jgr.segment_ground(jc)
    tg, tng = tgr.segment_ground(tc)
    assert len(tg) + len(tng) == len(pts)
    assert abs(len(tg) - len(jg)) <= 1e-3 * len(pts)
    got = tg.mask.numpy()[:len(truth)]
    assert got[truth].mean() > 0.85 and truth[got].mean() > 0.9


def test_patchwork_config_matches_jax():
    assert set(tgr.PatchworkConfig.__dataclass_fields__) == \
        set(jgr.PatchworkConfig.__dataclass_fields__)
    for f in tgr.PatchworkConfig.__dataclass_fields__:
        assert getattr(tgr.PatchworkConfig(), f) == getattr(jgr.PatchworkConfig(), f)
    assert tgr.PatchworkConfig().n_patches == jgr.PatchworkConfig().n_patches == 504
    assert tgr.GroundSegmentationResult._fields == jgr.GroundSegmentationResult._fields


def test_patchwork_config_from_carries_every_field():
    cfg = jgr.PatchworkConfig(zone_radii=(0.0, 3.0, 10.0, 70.0), rings_per_zone=(2, 3, 4),
                              sectors_per_zone=(8, 16, 24), sensor_height=2.0,
                              seed_fraction=0.3, min_seed_points=5, num_iterations=2,
                              distance_threshold=0.2, uprightness_threshold=0.8,
                              elevation_threshold=0.5, flatness_threshold=0.02,
                              min_patch_points=12)
    got = interop.patchwork_config_from(cfg)
    assert isinstance(got, tgr.PatchworkConfig)
    for f in jgr.PatchworkConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(cfg, f), f
    assert got.n_patches == cfg.n_patches
