"""The port's ``viz`` (camera, renderers, viewer) on the CPU, and against
the JAX package's.

``tests/test_viz.py``'s 16 tests run on the port (clouds and meshes on
the CPU), then parity on the same NumPy inputs:

- point renders bit-equal to JAX's: the port copies XLA:CPU's fused
  projection (``torch.addcmul``) and its serial scatter's write order
  (each pixel takes its highest writing index), so every pixel has
  JAX's bits, the depth-shade fallback over padded rows included;
- tied depths and an owned last pixel follow that write order in both;
- flat mesh renders bit-equal on >= 99.9% of pixels (measured: all; the
  face colour copies XLA's FMA and its reassociated 1/3), PBR within
  1e-5 on >= 99% (measured: all within 2e-7; the BRDF's elementwise
  chain rounds differently in its last bits), the same pixels covered;
- ties between faces go to the lowest face index for any face tiling,
  and pixel chunks or a pixel sample change no bit;
- ``OrbitCamera`` bit-equal, ``frame_ansi`` strings equal, the viewer's
  live pipelines equal to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.viz import OrbitCamera as JCamera  # noqa: E402
from threecrate_tpu.viz import renderer as jr  # noqa: E402
from threecrate_tpu.viz import viewer as jv  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch.viz import (  # noqa: E402
    InteractiveViewer, OrbitCamera, render_mesh, render_point_cloud, show_mesh,
    show_point_cloud)
from threecrate_tpu_torch.viz import renderer as tr  # noqa: E402

from conftest import make_sphere_points  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

BG = np.array([0.08, 0.09, 0.11])


def coverage(img):
    return (np.abs(img - BG) > 0.02).any(-1).mean()


def _pc(pts, **attrs):
    return tt.PointCloud.from_numpy(pts, device="cpu", **attrs)


def _mesh(v, f):
    return tt.TriangleMesh.from_numpy(v, f, device="cpu")


def _sphere_arrays(n=24):
    th = np.linspace(0, np.pi, n)
    ph = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                  np.cos(T)], -1).reshape(-1, 3).astype(np.float32)
    f = []
    w = 2 * n
    for i in range(n - 1):
        for j in range(w):
            a = i * w + j
            b = i * w + (j + 1) % w
            c = (i + 1) * w + j
            d = (i + 1) * w + (j + 1) % w
            f += [[a, b, c], [b, d, c]]
    return v, np.asarray(f, np.int32)


def _tetra_arrays():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    return v, f


# ---------------------------------------------------------------------------
# tests/test_viz.py on the port
# ---------------------------------------------------------------------------

class TestPointRenderer:
    def test_sphere_renders_centered(self):
        img = render_point_cloud(_pc(make_sphere_points(2000)), width=160, height=120)
        assert img.shape == (120, 160, 3)
        cov = coverage(img)
        assert 0.02 < cov < 0.9
        mid = (np.abs(img[40:80, 53:107] - BG) > 0.02).any(-1).mean()
        border = (np.abs(img[:10, :] - BG) > 0.02).any(-1).mean()
        assert mid > border

    def test_colors_used(self):
        pts = make_sphere_points(500)
        cols = np.zeros((500, 3), np.float32)
        cols[:, 0] = 1.0  # pure red
        img = render_point_cloud(_pc(pts, colors=cols), width=120, height=90)
        lit = np.abs(img - BG).max(-1) > 0.05
        assert lit.any()
        np.testing.assert_allclose(img[lit][:, 0], 1.0, atol=1e-5)

    def test_depth_occlusion(self):
        cam = OrbitCamera(target=np.zeros(3, np.float32), distance=5.0, yaw=0.0, pitch=0.0)
        near = np.array([[1.0, 0, 0]], np.float32)
        far = np.array([[-1.0, 0, 0]], np.float32)
        cols = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
        pc = _pc(np.concatenate([near, far]), colors=cols)
        img = render_point_cloud(pc, cam, width=60, height=60, point_size=3)
        lit = np.abs(img - BG).max(-1) > 0.05
        assert lit.any()
        assert (img[lit][:, 0] > 0.9).all()


class TestMeshRenderer:
    def test_renders_filled_shape(self):
        img = render_mesh(_mesh(*_tetra_arrays()), width=160, height=120)
        assert 0.05 < coverage(img) < 0.9

    def test_shading_varies_by_face(self):
        m = _mesh(*_tetra_arrays())
        cam = OrbitCamera.fit(m.to_numpy()[0])
        cam.yaw, cam.pitch = 4.0, -0.5
        img = render_mesh(m, cam, width=160, height=120)
        lit = img[np.abs(img - BG).max(-1) > 0.02]
        assert np.unique(np.round(lit[:, 0], 2)).size >= 2


class TestViewer:
    def test_viewer_roundtrip(self, tmp_path):
        pytest.importorskip("PIL")
        v = InteractiveViewer(width=120, height=90)
        v.set_point_cloud(_pc(make_sphere_points(500)))
        v.orbit(0.3, 0.1)
        v.zoom(0.8)
        v.pan(0.05, 0.02)
        assert v.render().shape == (90, 120, 3)
        p = tmp_path / "shot.png"
        v.screenshot(p)
        assert p.exists() and p.stat().st_size > 100

    def test_viewer_live_pipelines(self):
        """Plane RANSAC and ICP from the viewer, on the port's ops: the
        inlier count and pose equal JAX's viewer's (pose within 1e-6)."""
        rng = np.random.default_rng(0)
        xy = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
        pts = np.concatenate([xy, 0.001 * rng.normal(size=(300, 1)).astype(np.float32)], 1)
        v, j = InteractiveViewer(), jv.InteractiveViewer()
        v.set_point_cloud(_pc(pts))
        j.set_point_cloud(tc.PointCloud.from_numpy(pts))
        res, ref = v.run_plane_segmentation(), j.run_plane_segmentation()
        assert int(res.inlier_count) == int(ref.inlier_count) > 250
        icp_res = v.run_icp(_pc(pts))
        assert bool(icp_res.converged)
        np.testing.assert_allclose(icp_res.transformation.numpy(),
                                   np.asarray(j.run_icp(tc.PointCloud.from_numpy(pts))
                                              .transformation), atol=1e-6, rtol=0)
        with pytest.raises(ValueError):
            InteractiveViewer().run_icp(_pc(pts))

    def test_show_helpers(self, tmp_path):
        pytest.importorskip("PIL")
        show_point_cloud(_pc(make_sphere_points(200)), tmp_path / "c.png", width=80, height=60)
        assert (tmp_path / "c.png").exists()
        m = _mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                  np.array([[0, 1, 2]], np.int32))
        show_mesh(m, tmp_path / "m.png", width=80, height=60)
        assert (tmp_path / "m.png").exists()


def _viewer(viewer_cls=InteractiveViewer, cloud=_pc):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 1, (500, 3)).astype(np.float32)
    v = viewer_cls(width=160, height=120)
    v.set_point_cloud(cloud(pts))
    return v


class TestTerminalLoop:
    def test_scripted_session(self, capsys):
        v = _viewer()
        frames = v.run_terminal(cols=40, rows=12, keys=iter("ad+-wpq"))
        out = capsys.readouterr().out
        assert frames == 7
        assert "\x1b[38;2;" in out
        assert v.pipeline.value == "windowed"

    def test_key_dispatch_moves_camera(self):
        v = _viewer()
        yaw0 = v.camera.yaw
        assert v.handle_key("a")
        assert v.camera.yaw != yaw0
        d0 = v.camera.distance
        assert v.handle_key("+")
        assert v.camera.distance < d0
        assert not v.handle_key("q")

    def test_frame_ansi_shape(self):
        s = _viewer().frame_ansi(cols=32, rows=10)
        assert s.count("\n") == 9
        assert s.count("▀") == 32 * 10


class TestPbrRenderer:
    def test_pbr_renders_and_differs_from_flat(self):
        m = _mesh(*_sphere_arrays())
        img_pbr = tr.render_mesh_pbr(m, width=160, height=120)
        img_flat = render_mesh(m, width=160, height=120)
        assert img_pbr.shape == (120, 160, 3)
        assert np.isfinite(img_pbr).all()
        assert 0.05 < coverage(img_pbr) < 0.95
        assert np.abs(img_pbr - img_flat).max() > 0.05

    def test_pbr_smooth_normals_gradient(self):
        img = tr.render_mesh_pbr(_mesh(*_sphere_arrays()), width=160, height=120)
        lit = img[np.abs(img - BG).max(-1) > 0.02]
        assert np.unique(np.round(lit[:, 0], 2)).size > 20

    def test_material_params_have_effect(self):
        m = _mesh(*_sphere_arrays())
        shiny = tr.render_mesh_pbr(m, width=120, height=90,
                                   material=tr.PbrMaterial(metallic=0.9, roughness=0.1))
        rough = tr.render_mesh_pbr(m, width=120, height=90,
                                   material=tr.PbrMaterial(metallic=0.0, roughness=0.9))
        assert np.abs(shiny - rough).max() > 0.05

    def test_emission_adds_light(self):
        m = _mesh(*_sphere_arrays())
        dark = tr.render_mesh_pbr(m, width=80, height=60, material=tr.PbrMaterial())
        glow = tr.render_mesh_pbr(m, width=80, height=60,
                                  material=tr.PbrMaterial(emission=(0.5, 0.5, 0.5)))
        mask = np.abs(dark - BG).max(-1) > 0.02
        assert glow[mask].mean() > dark[mask].mean() + 0.05

    def test_render_to_texture_modes(self, tmp_path):
        m = _mesh(*_sphere_arrays(12))
        img_p = tr.render_to_texture(m, width=80, height=60, shading_mode="pbr")
        img_f = tr.render_to_texture(m, width=80, height=60, shading_mode="flat")
        assert img_p.shape == img_f.shape == (60, 80, 3)
        pytest.importorskip("PIL")
        p = tmp_path / "pbr.png"
        tr.save_image(p, img_p)
        assert p.read_bytes()[:4] == b"\x89PNG"
        with pytest.raises(ValueError):
            tr.render_to_texture(m, shading_mode="wireframe")


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, colored, point_size", [
    (3000, False, 2), (3000, True, 1), (2500, True, 3), (1000, False, 1)])
def test_point_render_matches_jax(n, colored, point_size):
    """Noisy spheres (3,000 and 2,500 points pad to JAX's capacity of
    3,072 and 2,560, so the depth-shade fallback reads padded rows):
    every pixel bit-equal to JAX's."""
    rng = np.random.default_rng(n + point_size)
    pts = (make_sphere_points(n, seed=4) + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    attrs = {"colors": rng.uniform(0, 1, (n, 3)).astype(np.float32)} if colored else {}
    got = render_point_cloud(_pc(pts, **attrs), width=160, height=120, point_size=point_size)
    ref = jr.render_point_cloud(tc.PointCloud.from_numpy(pts, **attrs), width=160, height=120,
                                point_size=point_size)
    np.testing.assert_array_equal(got, ref)


def _last_pixel_point(cam, width, height, depth):
    """A world point that projects to pixel (width - 1, height - 1), the
    last pixel of the image, at ``depth`` in front of the camera."""
    fx, fy, cx, cy = cam.intrinsics(width, height)
    x = (width - 1 - cx) * depth / fx
    y = -(height - 1 - cy) * depth / fy
    cam_pt = np.array([x, y, -depth, 1.0])
    return (np.linalg.inv(cam.view_matrix().astype(np.float64)) @ cam_pt)[:3].astype(np.float32)


def test_colour_pass_write_order():
    """The colour pass's write order on tied pixels, in both packages:
    points at one position (tied depths) show the colour of the last
    one; where a point owns the last pixel, a later point that owns no
    pixel writes that pixel's old colour over it (XLA's serial scatter,
    copied: each pixel takes its highest writing index)."""
    cam = OrbitCamera(target=np.zeros(3, np.float32), distance=5.0, yaw=0.0, pitch=0.0)
    jcam = JCamera(target=np.zeros(3, np.float32), distance=5.0, yaw=0.0, pitch=0.0)
    w = h = 40
    cols = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]

    def both(pts, colors, cap=None):
        got = render_point_cloud(tt.PointCloud.from_numpy(pts, capacity=cap, device="cpu",
                                                          colors=colors),
                                 cam, w, h, point_size=1)
        ref = jr.render_point_cloud(tc.PointCloud.from_numpy(pts, capacity=cap, colors=colors),
                                    jcam, w, h, point_size=1)
        np.testing.assert_array_equal(got, ref)
        return got

    tied = np.zeros((3, 3), np.float32)
    img = both(tied, cols[:3])
    lit = np.abs(img - BG).max(-1) > 0.05
    assert lit.sum() == 1 and np.array_equal(img[lit][0], cols[2])   # the last index
    # near-tied: within depth·(1 + 1e-6) all three own the pixel
    near = tied + np.float32([[0, 0, 0], [1e-7, 0, 0], [2e-7, 0, 0]])
    img = both(near, cols[:3])
    assert np.array_equal(img[np.abs(img - BG).max(-1) > 0.05][0], cols[2])
    # the last pixel, owned by the cloud's last row: its colour shows
    last = _last_pixel_point(cam, w, h, 5.0)
    pts = np.stack([np.zeros(3, np.float32), last])
    img = both(pts, cols[:2], cap=2)
    assert np.array_equal(img[h - 1, w - 1], cols[1])
    # owned by a row that padding rows follow: they own no pixel and
    # write the last pixel's old colour (black) after it
    img = both(pts, cols[:2], cap=128)
    assert np.array_equal(img[h - 1, w - 1], np.zeros(3, np.float32))


def test_flat_mesh_render_matches_jax():
    """A noisy UV sphere of 2,208 faces: the same pixels covered, colours
    bit-equal on >= 99.9% of pixels and within 1e-5 on all."""
    v, f = _sphere_arrays(24)
    v = v + np.random.default_rng(1).normal(0, 0.01, v.shape).astype(np.float32)
    got = render_mesh(_mesh(v, f), width=160, height=120)
    ref = jr.render_mesh(tc.TriangleMesh.from_numpy(v, f), width=160, height=120)
    d = np.abs(got - ref).max(-1)
    assert (d == 0).mean() >= 0.999 and d.max() <= 1e-5


def test_pbr_mesh_render_matches_jax():
    """The same sphere through the PBR pipeline (auto light, and a
    metallic material under the reference's literal light): within 1e-5
    of JAX's on >= 99% of pixels, the same pixels covered."""
    v, f = _sphere_arrays(24)
    v = v + np.random.default_rng(1).normal(0, 0.01, v.shape).astype(np.float32)
    for mat in (None, (0.9, 0.2)):
        kw_t, kw_j = {}, {}
        if mat is not None:
            kw_t = {"material": tr.PbrMaterial(metallic=mat[0], roughness=mat[1]),
                    "lighting": tr.MeshLightingParams()}
            kw_j = {"material": jr.PbrMaterial(metallic=mat[0], roughness=mat[1]),
                    "lighting": jr.MeshLightingParams()}
        got = tr.render_mesh_pbr(_mesh(v, f), width=160, height=120, **kw_t)
        ref = jr.render_mesh_pbr(tc.TriangleMesh.from_numpy(v, f), width=160, height=120,
                                 **kw_j)
        assert np.array_equal(np.abs(got - BG).max(-1) > 0, np.abs(ref - BG).max(-1) > 0)
        assert (np.abs(got - ref).max(-1) <= 1e-5).mean() >= 0.99


def test_face_ties_take_the_lowest_index_for_any_tiling():
    """Two coincident triangles of different colours, then the tetra: the
    lower face index wins at equal depth, with one, two or 512 faces a
    tile and in pixel chunks of 1,000, as in JAX's render."""
    v = np.array([[0, -1, -1], [0, 1, -1], [0, 0, 1]], np.float32)
    verts = np.concatenate([v, v])
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    colors = np.concatenate([np.tile([1.0, 0, 0], (3, 1)), np.tile([0, 1.0, 0], (3, 1))])
    cam = OrbitCamera(target=np.zeros(3, np.float32), distance=5.0, yaw=0.0, pitch=0.0)
    view = torch.as_tensor(cam.view_matrix())
    intr = torch.tensor(cam.intrinsics(48, 36), dtype=torch.float32)
    ld = torch.tensor([1.0, 0.0, 0.0])
    args = (torch.from_numpy(verts), torch.from_numpy(faces), torch.ones(2, dtype=torch.bool),
            torch.from_numpy(colors).float(), view, intr, ld, 48, 36)
    imgs = [tr.rasterize_flat(*args, face_tile=t) for t in (1, 2, 512)]
    lit = (imgs[0] - torch.tensor(BG, dtype=torch.float32)).abs().amax(-1) > 0.02
    assert lit.any() and (imgs[0][lit][:, 1] == 0).all()        # red: face 0
    for img in imgs[1:]:
        assert torch.equal(img, imgs[0])
    jimg = jr.render_mesh_jit(*[np.asarray(a) for a in args[:7]], 48, 36)
    np.testing.assert_array_equal(imgs[0].numpy(), np.asarray(jimg))


def test_pixel_chunks_and_samples_change_no_bit(monkeypatch):
    """The tetra and the sphere rendered in pixel chunks of 1,000 equal
    the one-chunk render, and a sample of flat pixel indices equals the
    full image at those pixels (flat and PBR)."""
    m = _mesh(*_sphere_arrays(12))
    full = render_mesh(m, width=80, height=60)
    pbr = tr.render_mesh_pbr(m, width=80, height=60)
    monkeypatch.setattr(tr, "PIXEL_CHUNK", 1000)
    np.testing.assert_array_equal(render_mesh(m, width=80, height=60), full)
    np.testing.assert_array_equal(tr.render_mesh_pbr(m, width=80, height=60), pbr)
    cam = OrbitCamera.fit(m.to_numpy()[0])
    view = torch.as_tensor(cam.view_matrix())
    intr = torch.tensor(cam.intrinsics(80, 60), dtype=torch.float32)
    ld = np.float32([0.4, 0.3, 0.85])
    ld = torch.from_numpy(ld / np.linalg.norm(ld))
    sample = torch.from_numpy(np.random.default_rng(3).choice(80 * 60, 500, replace=False))
    vcol = torch.tensor((0.7, 0.72, 0.78)).expand(m.vertices.shape)
    got = tr.rasterize_flat(m.vertices, m.faces, m.face_mask, vcol, view, intr, ld, 80, 60,
                            pixels=sample)
    np.testing.assert_array_equal(got.numpy(), full.reshape(-1, 3)[sample.numpy()])


def test_orbit_camera_matches_jax():
    """``OrbitCamera``: fit, the controls, the matrices and intrinsics
    bit-equal to JAX's (the same NumPy code)."""
    pts = make_sphere_points(300, seed=2) * np.float32(3.0) + np.float32([1, -2, 0.5])
    t, j = OrbitCamera.fit(pts, fov_deg=40.0), JCamera.fit(pts, fov_deg=40.0)
    for cam in (t, j):
        cam.orbit(0.3, 2.0)
        cam.zoom(0.7)
        cam.pan(0.1, -0.2)
    np.testing.assert_array_equal(t.view_matrix(), j.view_matrix())
    np.testing.assert_array_equal(t.eye(), j.eye())
    assert t.intrinsics(640, 480) == j.intrinsics(640, 480)
    assert (t.distance, t.yaw, t.pitch) == (j.distance, j.yaw, j.pitch)


def test_frame_ansi_matches_jax():
    """The viewer's ANSI frame of the same cloud after the same keys:
    the same string."""
    v = _viewer()
    j = _viewer(jv.InteractiveViewer, tc.PointCloud.from_numpy)
    for key in "adwh":
        v.handle_key(key)
        j.handle_key(key)
    assert v.frame_ansi(cols=48, rows=16) == j.frame_ansi(cols=48, rows=16)
