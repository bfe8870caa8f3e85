"""Mesh smoothing: Laplacian, Taubin λ/μ, and HC (Humphrey's Classes).

Counterpart of ``threecrate_tpu.ops.mesh_smoothing``, on the mesh's
device. The one-ring is an edge list (the six directed edges of every
face, sorted on (src, dst) by two stable sorts, least significant key
first, and deduplicated), and every smoothing step is a pair of
``index_add_`` scatters: neighbour centroids for all vertices at once.
On the CPU the scatter adds in index order, as XLA's does, and each
update is fused where XLA:CPU fuses it (``torch.addcmul``: pos +
f·(mean − pos); α·orig + (1 − α)·pos and β·b + (1 − β)·b̄ with the
second product fused), so the CPU results equal the JAX package's bit
for bit. (A one-iteration HC differs by an ulp: XLA inlines a one-trip
loop and fuses α·orig there instead.) On the card the scatter is atomic, so sums may
round differently from call to call. The iterations are a Python loop
with no host sync in it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.mesh import TriangleMesh


@dataclasses.dataclass(frozen=True)
class LaplacianConfig:
    """mesh_smoothing.rs:66."""

    iterations: int = 10
    factor: float = 0.5


@dataclasses.dataclass(frozen=True)
class TaubinConfig:
    """mesh_smoothing.rs:126 (λ > 0 shrink, μ < 0 inflate)."""

    iterations: int = 10
    lambda_factor: float = 0.5
    mu_factor: float = -0.53


@dataclasses.dataclass(frozen=True)
class HcConfig:
    """mesh_smoothing.rs:190 (Vollmer/Mencl/Müller HC-Laplacian)."""

    iterations: int = 10
    alpha: float = 0.1
    beta: float = 0.6


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's ``jnp.float32``)."""
    return float(np.float32(x))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``x`` on ``like``'s device, filled there (a copy
    from the host would sync)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _edge_list(faces: torch.Tensor, face_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicated directed edge list from faces (the one-ring,
    mesh_smoothing.rs:24-38). Returns (src, dst, valid) of length 6F."""
    f = faces.to(torch.int32)
    src = torch.cat([f[:, 0], f[:, 1], f[:, 1], f[:, 2], f[:, 2], f[:, 0]])
    dst = torch.cat([f[:, 1], f[:, 0], f[:, 2], f[:, 1], f[:, 0], f[:, 2]])
    ok = face_mask.repeat(6)
    big = 2**31 - 1
    s = torch.where(ok, src, big)
    d = torch.where(ok, dst, big)
    order = torch.sort(d, stable=True).indices
    order = order[torch.sort(s[order], stable=True).indices]
    s, d = s[order], d[order]
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=s.device),
                     (s[1:] == s[:-1]) & (d[1:] == d[:-1])])
    valid = (s != big) & ~dup
    return torch.where(valid, s, 0), torch.where(valid, d, 0), valid


def _neighbor_mean(pos, src, dst, valid):
    w = valid.to(pos.dtype)
    sums = torch.zeros_like(pos).index_add_(0, src, pos[dst] * w[:, None])
    cnt = torch.zeros(pos.shape[:1], dtype=pos.dtype, device=pos.device).index_add_(0, src, w)
    return sums / torch.clamp_min(cnt, 1.0)[:, None], cnt > 0


def _step(pos, vmask, src, dst, evalid, factor: float):
    mean, has = _neighbor_mean(pos, src, dst, evalid)
    new = torch.addcmul(pos, mean - pos, _scalar(factor, pos))
    return torch.where((vmask & has)[:, None], new, pos)


def _laplacian(verts, vmask, src, dst, evalid, iterations: int, factor: float):
    pos = verts
    for _ in range(iterations):
        pos = _step(pos, vmask, src, dst, evalid, factor)
    return pos


def _taubin(verts, vmask, src, dst, evalid, iterations: int, lam: float, mu: float):
    pos = verts
    for _ in range(iterations):
        pos = _step(_step(pos, vmask, src, dst, evalid, lam), vmask, src, dst, evalid, mu)
    return pos


def _hc(verts, vmask, src, dst, evalid, iterations: int, alpha: float, beta: float):
    orig = verts
    pos = verts
    one_alpha = _f32(np.float32(1) - np.float32(alpha))
    one_beta = _f32(np.float32(1) - np.float32(beta))
    for _ in range(iterations):
        mean, has = _neighbor_mean(pos, src, dst, evalid)
        keep = (vmask & has)[:, None]
        q = torch.where(keep, mean, pos)
        b = q - torch.addcmul(alpha * orig, pos, _scalar(one_alpha, pos))
        b_mean, _ = _neighbor_mean(b, src, dst, evalid)
        new = q - torch.addcmul(beta * b, b_mean, _scalar(one_beta, pos))
        pos = torch.where(keep, new, pos)
    return pos


def _prep(mesh: TriangleMesh):
    return _edge_list(mesh.faces, mesh.face_mask)


def smooth_laplacian(mesh: TriangleMesh,
                     config: LaplacianConfig = LaplacianConfig()) -> TriangleMesh:
    """Laplacian smoothing (smooth_laplacian, mesh_smoothing.rs:95)."""
    src, dst, ev = _prep(mesh)
    new = _laplacian(mesh.vertices, mesh.vertex_mask, src, dst, ev,
                     config.iterations, _f32(config.factor))
    return mesh.with_vertices(new)


def smooth_taubin(mesh: TriangleMesh,
                  config: TaubinConfig = TaubinConfig()) -> TriangleMesh:
    """Taubin shrink/inflate smoothing (smooth_taubin,
    mesh_smoothing.rs:158)."""
    src, dst, ev = _prep(mesh)
    new = _taubin(mesh.vertices, mesh.vertex_mask, src, dst, ev, config.iterations,
                  _f32(config.lambda_factor), _f32(config.mu_factor))
    return mesh.with_vertices(new)


def smooth_hc(mesh: TriangleMesh, config: HcConfig = HcConfig()) -> TriangleMesh:
    """HC-Laplacian with original-position correction (smooth_hc,
    mesh_smoothing.rs:225)."""
    src, dst, ev = _prep(mesh)
    new = _hc(mesh.vertices, mesh.vertex_mask, src, dst, ev, config.iterations,
              _f32(config.alpha), _f32(config.beta))
    return mesh.with_vertices(new)
