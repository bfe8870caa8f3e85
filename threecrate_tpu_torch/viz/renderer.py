"""Device-side rendering: point splatting and mesh rasterization.

Counterpart of ``threecrate_tpu.viz.renderer`` (threecrate-gpu's render
stack: PointCloudRenderer, gpu/src/renderer.rs:139-550 +
shaders/point_cloud.wgsl; MeshRenderer with flat/PBR shading,
gpu/src/mesh.rs:14-1208), in plain PyTorch on the cloud's or mesh's
device; no hand kernel lies here.

* point clouds: project → pixel id → **scatter-min z-buffer**
  (``scatter_reduce_(..., "amin")``, exact in any order) → colour pass;
* meshes: brute-force coverage — barycentric tests of (pixel chunk ×
  face tile) pairs with a running depth/colour merge over the face
  tiles, in face order. Each pixel is independent, so the pixels are
  cut into chunks (``PIXEL_CHUNK``) to bound the (pixels × tile)
  temporaries, and a tile whose faces lie outside a chunk's rows is
  skipped for it; neither changes a bit.

The colour pass copies JAX's scatter-*set*: every point writes one
pixel, its colour where it owns that pixel's depth (within
``depth·(1 + 1e-6)``) and pixel ``n_pix - 1``'s old colour otherwise,
and where several points write one pixel XLA:CPU's serial scatter
keeps the last. Here each pixel takes the value of its highest writing
index (``scatter_reduce_(..., "amax")`` over the point indices, then a
gather), the same on every device. The projection and the raster's
barycentric sums copy XLA:CPU's fused multiply-adds (``torch.addcmul``).

Output is a plain (H, W, 3) float image on the host — usable headless
(PNG), in notebooks, or by the viewer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from .camera import OrbitCamera

BACKGROUND = (0.08, 0.09, 0.11)
_BIG = 3e38
# pixels a raster chunk holds: (pixels × face tile) float32 temporaries
# of 128 MiB at the default tile of 512 faces
PIXEL_CHUNK = 65536


def _background(device) -> torch.Tensor:
    return torch.tensor(BACKGROUND, dtype=torch.float32, device=device)


def _project(points, view, intr):
    """(u, v, z) of each point: the camera product as XLA:CPU evaluates
    it (the first column's product, one FMA a column, then the
    translation) and u = x / z · fx + cx as one FMA."""
    r = view[:3, :3]
    cam = torch.addcmul(points[:, :1] * r[:, 0], points[:, 1:2], r[:, 1])
    cam = torch.addcmul(cam, points[:, 2:3], r[:, 2]) + view[:3, 3]
    z = -cam[:, 2]  # camera looks down -z
    zc = torch.clamp_min(z, 1e-9)
    u = torch.addcmul(intr[2], cam[:, 0] / zc, intr[0])
    v = torch.addcmul(intr[3], -cam[:, 1] / zc, intr[1])
    return u, v, z


def _pixel(c: torch.Tensor) -> torch.Tensor:
    """Nearest pixel index (half to even), clamped far outside any image
    so that the integer conversion is defined for every point."""
    return torch.clamp(torch.round(c), -2.0 ** 30, 2.0 ** 30).to(torch.int64)


def render_points(points, mask, colors, view, intr, width: int, height: int,
                  point_size: int = 1) -> torch.Tensor:
    """Splat a padded cloud into an (height, width, 3) image on its
    device (``render_points_jit`` of the JAX package): a square of
    ``point_size`` pixels a point, the nearest depth wins."""
    device = points.device
    u, v, z = _project(points, view, intr)
    ur, vr = _pixel(u), _pixel(v)
    front = mask & (z > 1e-6)
    n_pix = width * height
    r = point_size // 2
    offsets = [(dx, dy) for dx in range(-r, r + 1)
               for dy in range(-r, r + 1)] or [(0, 0)]

    def splat(dx, dy):
        ui, vi = ur + dx, vr + dy
        ok = front & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
        return ok, torch.where(ok, vi * width + ui, 0)

    depth = torch.full((n_pix,), _BIG, dtype=torch.float32, device=device)
    for dx, dy in offsets:
        ok, pix = splat(dx, dy)
        depth.scatter_reduce_(0, pix, torch.where(ok, z, _BIG), "amin")
    # second pass: write colour where this point owns the depth buffer
    color = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    order = torch.arange(points.shape[0], device=device)
    for dx, dy in offsets:
        ok, pix = splat(dx, dy)
        owns = ok & (z <= depth[pix] * (1 + 1e-6))
        target = torch.where(owns, pix, n_pix - 1)
        value = torch.where(owns[:, None], colors, color[n_pix - 1])
        last = torch.full((n_pix,), -1, dtype=torch.int64, device=device)
        last.scatter_reduce_(0, target, order, "amax")
        color = torch.where((last >= 0)[:, None], value[last.clamp_min(0)], color)
    img = torch.where((depth < _BIG)[:, None], color, _background(device))
    return img.reshape(height, width, 3)


def render_point_cloud(cloud: PointCloud,
                       camera: Optional[OrbitCamera] = None,
                       width: int = 640, height: int = 480,
                       point_size: int = 2,
                       color=(0.85, 0.85, 0.9)) -> np.ndarray:
    """Render a cloud to an (H, W, 3) image (PointCloudRenderer role).

    Uses per-point colors when present; otherwise shades by depth over
    every row of the cloud, padding included, as the JAX package does.
    """
    if camera is None:
        camera = OrbitCamera.fit(cloud.to_numpy())
    device = cloud.device
    view = torch.as_tensor(camera.view_matrix(), device=device)
    intr = torch.tensor(camera.intrinsics(width, height), dtype=torch.float32,
                        device=device)
    if cloud.colors is not None:
        colors = cloud.colors
    else:
        # depth-shade fallback (JAX runs it op by op: no fused z here)
        z = _project(cloud.points, view, intr)[2]
        z_min, z_max = z.min(), z.max()
        zr = (z - z_min) / torch.clamp_min(z_max - z_min, 1e-9)
        base = torch.tensor(color, dtype=torch.float32, device=device)
        colors = base * (1.0 - 0.6 * zr[:, None])
    img = render_points(cloud.points, cloud.mask, colors, view, intr,
                        width, height, point_size)
    return img.cpu().numpy()


# ---------------------------------------------------------------------------
# mesh rasterization
# ---------------------------------------------------------------------------

def _pad_faces(face_tile: int, face_mask, *arrays):
    """Pad per-face arrays to a multiple of ``face_tile`` faces: depth
    rows (the first array) with 3e38, the others with 0, the mask with
    False."""
    pad = (-face_mask.shape[0]) % face_tile
    if not pad:
        return (face_mask, *arrays)
    out = [torch.nn.functional.pad(face_mask, (0, pad))]
    for i, a in enumerate(arrays):
        rows = a.new_full((pad,) + a.shape[1:], _BIG if i == 0 else 0)
        out.append(torch.cat([a, rows]))
    return tuple(out)


def _pixel_centres(width: int, height: int, pixels, device):
    """(x, y) pixel centres of the whole image in row order, or of the
    flat pixel indices ``pixels``."""
    if pixels is None:
        pixels = torch.arange(width * height, device=device)
    pixels = torch.as_tensor(pixels, device=device).to(torch.int64)
    return ((pixels % width).to(torch.float32) + 0.5,
            (pixels // width).to(torch.float32) + 0.5)


def _cover(px, py, tu, tv, tz, tm):
    """Barycentrics (P, T) of pixel centres in a tile of faces and each
    pair's depth (3e38 where the pixel lies outside the face); the
    products that XLA:CPU contracts into FMAs are FMAs here too."""
    x0, x1, x2 = tu[:, 0], tu[:, 1], tu[:, 2]
    y0, y1, y2 = tv[:, 0], tv[:, 1], tv[:, 2]
    den = torch.addcmul((x2 - x1) * (y0 - y2), y1 - y2, x0 - x2)
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    dx = px[:, None] - x2[None, :]
    dy = py[:, None] - y2[None, :]
    w0 = torch.addcmul((x2 - x1)[None, :] * dy, (y1 - y2)[None, :], dx) / den
    w1 = torch.addcmul((x0 - x2)[None, :] * dy, (y2 - y0)[None, :], dx) / den
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & tm[None, :]
    zpix = torch.addcmul(torch.addcmul(w1 * tz[None, :, 1], w0, tz[None, :, 0]),
                         w2, tz[None, :, 2])
    zpix = torch.where(inside & (zpix > 1e-6), zpix, _BIG)
    return w0, w1, w2, zpix


def _raster(width, height, face_tile, pixels, faces_uvz, face_mask, payload,
            pick, n_out, device):
    """Run the face tiles over each pixel chunk: for every pixel the
    nearest covering face, the lowest face index on a tie (``argmin``
    takes the first index in a tile, the strict ``<`` keeps the earlier
    tile). ``pick(w0, w1, w2, best, tile_payload)`` gives the (P, n_out)
    values of each pixel's best face in a tile. A tile whose faces' rows
    (v, with a pixel's margin) miss the chunk's rows is skipped: it
    covers none of its pixels, so the result keeps every bit. Returns
    (depth, values) of the pixels in row order (or in the order of
    ``pixels``)."""
    fu, fv, fz = faces_uvz
    face_mask, fz, fu, fv, *payload = _pad_faces(face_tile, face_mask, fz, fu, fv, *payload)
    px_all, py_all = _pixel_centres(width, height, pixels, device)
    n_tiles = fu.shape[0] // face_tile
    rows = fv.reshape(n_tiles, face_tile * 3)
    live = face_mask.reshape(n_tiles, face_tile).repeat_interleave(3, dim=1)
    # per tile the lowest and highest row of its live faces (one host copy)
    tile_rows = torch.stack([torch.where(live, rows, torch.inf).amin(1),
                             torch.where(live, rows, -torch.inf).amax(1)], 1).cpu().tolist()
    depth_out, values_out = [], []
    for s in range(0, px_all.shape[0], PIXEL_CHUNK):
        px, py = px_all[s:s + PIXEL_CHUNK], py_all[s:s + PIXEL_CHUNK]
        if pixels is None:   # row-major: the chunk's first and last rows
            lo, hi = s // width + 0.5, (s + px.shape[0] - 1) // width + 0.5
        else:
            lo, hi = (float(x) for x in torch.aminmax(py))
        depth = torch.full(px.shape, _BIG, dtype=torch.float32, device=device)
        values = torch.zeros(px.shape + (n_out,), dtype=torch.float32, device=device)
        for i, (v_lo, v_hi) in enumerate(tile_rows):
            if v_hi < lo - 1.0 or v_lo > hi + 1.0:
                continue
            tile = slice(i * face_tile, (i + 1) * face_tile)
            w0, w1, w2, zpix = _cover(px, py, fu[tile], fv[tile], fz[tile], face_mask[tile])
            best = torch.argmin(zpix, dim=1)
            best_z = torch.gather(zpix, 1, best[:, None])[:, 0]
            better = best_z < depth
            depth = torch.where(better, best_z, depth)
            values = torch.where(better[:, None],
                                 pick(w0, w1, w2, best, [p[tile] for p in payload]), values)
        depth_out.append(depth)
        values_out.append(values)
    return torch.cat(depth_out), torch.cat(values_out)


def _face_screen(verts, faces, view, intr):
    u, v, z = _project(verts, view, intr)
    f = faces.long()
    return (u[f], v[f], z[f]), f


def _flat_shade(verts, f, vert_colors, light_dir):
    """Per-face colour: the corner colours' mean, lit by |n·l| (two-sided
    Lambert) over an ambient of 0.25, as XLA:CPU evaluates it: n·l as
    an FMA chain, 0.25 + 0.75·lam as one FMA, and the mean's 1/3 moved
    onto the light term."""
    fsum = vert_colors[f].sum(1)
    tri = verts[f]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=1, keepdim=True), 1e-12)
    lam = torch.addcmul(torch.addcmul(n[:, 0] * light_dir[0], n[:, 1], light_dir[1]),
                        n[:, 2], light_dir[2]).abs()
    light = torch.addcmul(lam.new_tensor(0.25), lam, lam.new_tensor(0.75))
    return (light * (1.0 / 3.0))[:, None] * fsum


def rasterize_flat(verts, faces, face_mask, vert_colors, view, intr, light_dir,
                   width: int, height: int, face_tile: int = 512,
                   pixels=None) -> torch.Tensor:
    """Flat-shaded raster (``render_mesh_jit`` of the JAX package): the
    (height, width, 3) image on the mesh's device, or the (P, 3) colours
    of the flat pixel indices ``pixels``."""
    device = verts.device
    uvz, f = _face_screen(verts, faces, view, intr)
    shade = _flat_shade(verts, f, vert_colors, light_dir)
    depth, color = _raster(width, height, face_tile, pixels, uvz, face_mask, [shade],
                           lambda w0, w1, w2, best, tp: tp[0][best], 3, device)
    color = torch.where((depth < _BIG)[:, None], color, _background(device))
    return color if pixels is not None else color.reshape(height, width, 3)


def _mesh_camera(mesh, camera, width, height):
    """The camera (fitted to the mesh's vertices when None), its view
    matrix and intrinsics on the mesh's device."""
    if camera is None:
        v, _ = mesh.to_numpy()
        camera = OrbitCamera.fit(v)
    view = torch.as_tensor(camera.view_matrix(), device=mesh.device)
    intr = torch.tensor(camera.intrinsics(width, height), dtype=torch.float32,
                        device=mesh.device)
    return camera, view, intr


def render_mesh(mesh: TriangleMesh, camera: Optional[OrbitCamera] = None,
                width: int = 640, height: int = 480,
                color=(0.7, 0.72, 0.78),
                light_dir=(0.4, 0.3, 0.85)) -> np.ndarray:
    """Render a mesh with flat lambertian shading (MeshRenderer role,
    ShadingMode::Flat; PBR parameters map to the same pipeline with a
    different shade function)."""
    _, view, intr = _mesh_camera(mesh, camera, width, height)
    if mesh.colors is not None:
        vcol = mesh.colors
    else:
        vcol = torch.tensor(color, dtype=torch.float32,
                            device=mesh.device).expand(mesh.vertices.shape)
    ld = np.asarray(light_dir, np.float32)
    ld = ld / np.linalg.norm(ld)
    img = rasterize_flat(mesh.vertices, mesh.faces, mesh.face_mask, vcol, view, intr,
                         torch.as_tensor(ld, device=mesh.device), width, height)
    return img.cpu().numpy()


def save_image(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) float image to PNG (needs PIL)."""
    from PIL import Image
    arr = np.clip(np.asarray(image) * 255 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(str(path))


# ---------------------------------------------------------------------------
# PBR shading (ShadingMode::Pbr, gpu/src/mesh.rs:14-1208 +
# shaders/mesh_pbr.wgsl) — deferred: the raster interpolates per-pixel
# world position / normal / albedo via barycentrics (G-buffer carries),
# then the metallic-roughness BRDF (GGX distribution, Smith geometry,
# Schlick fresnel, point-light attenuation, ACES tone map + gamma) runs
# ONCE per pixel instead of per (pixel x face-tile) pair.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PbrMaterial:
    """Mirrors PbrMaterial (gpu/src/mesh.rs:114-138)."""

    albedo: Tuple[float, float, float] = (0.7, 0.7, 0.7)
    metallic: float = 0.0
    roughness: float = 0.5
    ao: float = 1.0
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class MeshLightingParams:
    """Mirrors MeshLightingParams (gpu/src/mesh.rs:157-182)."""

    light_position: Tuple[float, float, float] = (10.0, 10.0, 10.0)
    light_intensity: float = 1.0
    light_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient_strength: float = 0.03
    gamma: float = 2.2
    exposure: float = 1.0


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def _pbr_shade(world_pos, normal, albedo, view_pos, mat_vec, light_vec):
    """Per-pixel metallic-roughness BRDF (mesh_pbr.wgsl:76-210)."""
    metallic, roughness, ao = mat_vec[0], mat_vec[1], mat_vec[2]
    emission = mat_vec[3:6]
    light_pos = light_vec[0:3]
    light_intensity = light_vec[3]
    light_color = light_vec[4:7]
    ambient_strength = light_vec[7]
    gamma = light_vec[8]
    exposure = light_vec[9]

    view_dir = _unit(view_pos[None, :] - world_pos)
    to_light = light_pos[None, :] - world_pos
    dist = torch.clamp_min(torch.linalg.vector_norm(to_light, dim=-1), 1e-6)
    light_dir = to_light / dist[:, None]
    half_dir = _unit(view_dir + light_dir)
    radiance = light_color[None, :] * light_intensity / (dist * dist)[:, None]

    # two-sided shading: a raster with no backface culling can see
    # either face; flip the normal toward the viewer (the reference
    # culls back faces instead — same visible result)
    n_flip = torch.where((normal * view_dir).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    n = normal * n_flip

    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    n_dot_h = torch.clamp_min((n * half_dir).sum(-1), 0.0)
    a2 = (roughness * roughness) ** 2
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    ndf = a2 / (torch.pi * denom * denom)
    n_dot_v = torch.clamp_min((n * view_dir).sum(-1), 0.0)
    n_dot_l = torch.clamp_min((n * light_dir).sum(-1), 0.0)
    k = (roughness + 1.0) ** 2 / 8.0
    g = (n_dot_v / (n_dot_v * (1 - k) + k)) * \
        (n_dot_l / (n_dot_l * (1 - k) + k))
    h_dot_v = torch.clamp_min((half_dir * view_dir).sum(-1), 0.0)
    fr = f0 + (1.0 - f0) * torch.clamp(1.0 - h_dot_v, 0.0, 1.0)[:, None] ** 5
    spec = (ndf * g)[:, None] * fr / (4.0 * n_dot_v * n_dot_l + 1e-4)[:, None]
    kd = (1.0 - fr) * (1.0 - metallic)
    lo = (kd * albedo / torch.pi + spec) * radiance * n_dot_l[:, None]
    ambient = ambient_strength * albedo * ao
    color = ambient + lo + emission[None, :]

    # ACES tone map + gamma (tone_map_aces, mesh_pbr.wgsl:169-183)
    exposed = color * exposure
    tone = (exposed * (2.51 * exposed + 0.03)) / \
        (exposed * (2.43 * exposed + 0.59) + 0.14)
    return torch.clamp(tone, 0.0, 1.0) ** (1.0 / gamma)


def _pick_gbuffer(w0, w1, w2, best, tp):
    """Each pixel's interpolated world position, normal and colour at its
    best face of a tile: (P, 9)."""
    bw = [torch.gather(w, 1, best[:, None]) for w in (w0, w1, w2)]
    out = []
    for corners in tp:                       # (T, 3 corners, 3)
        b = corners[best]
        out.append(torch.addcmul(torch.addcmul(bw[1] * b[:, 1], bw[0], b[:, 0]),
                                 bw[2], b[:, 2]))
    return torch.cat(out, dim=1)


def rasterize_pbr(verts, faces, face_mask, vert_colors, vert_normals, view, intr,
                  view_pos, mat_vec, light_vec, width: int, height: int,
                  face_tile: int = 512, pixels=None) -> torch.Tensor:
    """PBR raster (``render_mesh_jit_pbr`` of the JAX package): the same
    tiled barycentric scan as :func:`rasterize_flat`, carrying a
    G-buffer (depth, world position, smooth normal, albedo) shaded once
    a pixel afterwards. The (height, width, 3) image, or the (P, 3)
    colours of the flat pixel indices ``pixels``."""
    device = verts.device
    uvz, f = _face_screen(verts, faces, view, intr)
    depth, g = _raster(width, height, face_tile, pixels, uvz, face_mask,
                       [verts[f], vert_normals[f], vert_colors[f]], _pick_gbuffer, 9,
                       device)
    hit = depth < _BIG
    pbuf, nbuf, cbuf = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    nrm = _unit(nbuf)
    # vertex color blended with material albedo (mesh_pbr.wgsl:190)
    albedo = 0.5 * mat_vec[6:9][None, :] + 0.5 * cbuf
    shaded = _pbr_shade(pbuf, nrm, albedo, view_pos, mat_vec, light_vec)
    color = torch.where(hit[:, None], shaded, _background(device))
    return color if pixels is not None else color.reshape(height, width, 3)


def _pbr_inputs(mesh, camera, width, height, material, lighting):
    """The camera, view, intrinsics and the (mesh with normals, vertex
    colours, material vector, light vector) of a PBR render, with the
    auto-fitted light when ``lighting`` is None."""
    mat = material or PbrMaterial()
    camera, view, intr = _mesh_camera(mesh, camera, width, height)
    light = lighting
    if light is None:
        # auto-fit: the reference's fixed defaults (light at (10,10,10),
        # intensity 1) attenuate by 1/d² and render unit-scale meshes
        # nearly black; scale the default light to the camera orbit so
        # radiance at the subject is O(1). Pass MeshLightingParams()
        # explicitly for the reference's literal defaults.
        eye = np.asarray(camera.eye(), np.float32)
        up = np.array([0.0, 0.0, 1.0], np.float32)
        pos = eye + up * (0.5 * camera.distance)
        d2 = float(np.sum((pos - camera.target) ** 2))
        light = MeshLightingParams(light_position=tuple(pos),
                                   light_intensity=1.2 * d2)
    m = mesh if mesh.normals is not None else mesh.compute_vertex_normals()
    device = mesh.device
    if mesh.colors is not None:
        vcol = mesh.colors
    else:
        vcol = torch.tensor(mat.albedo, dtype=torch.float32,
                            device=device).expand(mesh.vertices.shape)
    mat_vec = torch.tensor([mat.metallic, mat.roughness, mat.ao,
                            *mat.emission, *mat.albedo], dtype=torch.float32, device=device)
    light_vec = torch.tensor([*light.light_position, light.light_intensity,
                              *light.light_color, light.ambient_strength, light.gamma,
                              light.exposure], dtype=torch.float32, device=device)
    return camera, view, intr, m, vcol, mat_vec, light_vec


def render_mesh_pbr(mesh: TriangleMesh,
                    camera: Optional[OrbitCamera] = None,
                    width: int = 640, height: int = 480,
                    material: Optional[PbrMaterial] = None,
                    lighting: Optional[MeshLightingParams] = None
                    ) -> np.ndarray:
    """Render with the PBR pipeline (ShadingMode::Pbr,
    gpu/src/mesh.rs:849-986): per-pixel interpolated vertex normals,
    metallic-roughness BRDF, point light, ACES tone mapping."""
    camera, view, intr, m, vcol, mat_vec, light_vec = _pbr_inputs(
        mesh, camera, width, height, material, lighting)
    img = rasterize_pbr(
        m.vertices, m.faces, m.face_mask, vcol, m.normals, view, intr,
        torch.as_tensor(np.asarray(camera.eye(), np.float32), device=mesh.device),
        mat_vec, light_vec, width, height)
    return img.cpu().numpy()


def render_to_texture(mesh: TriangleMesh,
                      camera: Optional[OrbitCamera] = None,
                      width: int = 640, height: int = 480,
                      shading_mode: str = "pbr",
                      material: Optional[PbrMaterial] = None,
                      lighting: Optional[MeshLightingParams] = None,
                      **kw) -> np.ndarray:
    """Offscreen render returning the (H, W, 3) image
    (MeshRenderer::render_to_texture, gpu/src/mesh.rs:988-1069) —
    ``shading_mode``: "pbr" | "flat"."""
    if shading_mode == "pbr":
        return render_mesh_pbr(mesh, camera, width, height,
                               material, lighting)
    if shading_mode == "flat":
        return render_mesh(mesh, camera, width, height, **kw)
    raise ValueError(f"unknown shading_mode {shading_mode!r} "
                     "(expected 'pbr' or 'flat')")
