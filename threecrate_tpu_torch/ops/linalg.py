"""Batched small linear algebra: 3x3 eigensolves, Kabsch, transforms.

Counterpart of ``threecrate_tpu.ops.linalg``, with the same closed
forms and degeneracy guards. Every product runs in full fp32: TF32
keeps about three decimal digits, which caps ICP's rotation error near
1e-2 (the JAX package forces ``Precision.HIGHEST`` for the same
reason), so the matmuls here go through :func:`fp32_matmul`.

The 3x3 SVD of the Kabsch fit runs on the host: the moments it needs
are reduced on the device and read back as one small tensor, so an ICP
iteration costs exactly one device→host copy (see
``kabsch_from_moments``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import profiling

_EPS = 1e-12


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full fp32: TF32 is switched off before the product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b


def _scale_of(a: torch.Tensor) -> torch.Tensor:
    # normalise to max|a| ~ 1: every guard below is an absolute epsilon,
    # which misfires on mm-scale covariances (entries ~1e-8) otherwise
    return torch.clamp_min(a.abs().amax(dim=(-2, -1)), 1e-30)


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def eigvals_sym3x3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric ``(..., 3, 3)`` matrices, ascending
    (closed-form trigonometric method, Smith 1961)."""
    a = a.to(torch.float32)
    scale = _scale_of(a)
    a = a / scale[..., None, None]
    q = a.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    a_sub = a - q[..., None, None] * eye
    p2 = (a_sub * a_sub).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, _EPS))
    b = a_sub / p[..., None, None]
    r = torch.clamp(_det3(b) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    isotropic = p2 < _EPS
    e1 = torch.where(isotropic, q, e1)
    e2 = torch.where(isotropic, q, e2)
    e3 = torch.where(isotropic, q, e3)
    return torch.stack([e3, e2, e1], dim=-1) * scale[..., None]


def _eigenvector_for(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric 3x3 ``a`` for eigenvalue ``lam``: the
    largest cross product of rows of (a - lam I), with rank-1 and rank-0
    fallbacks."""
    scale = _scale_of(a)
    a = a / scale[..., None, None]
    lam = lam / scale
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = a - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    best_n = torch.maximum(torch.maximum(n01, n02), n12)
    row_n = (m * m).sum(-1)
    big_row = torch.gather(
        m, -2, row_n.argmax(-1)[..., None, None].expand(*m.shape[:-2], 1, 3)
    )[..., 0, :]
    alt = torch.linalg.cross(big_row, eye[0].expand_as(big_row))
    alt2 = torch.linalg.cross(big_row, eye[1].expand_as(big_row))
    alt = torch.where(((alt * alt).sum(-1) >= (alt2 * alt2).sum(-1))[..., None],
                      alt, alt2)
    v = torch.where((best_n > _EPS)[..., None], best, alt)
    v = torch.where(((v * v).sum(-1) > _EPS)[..., None], v, eye[2].expand_as(v))
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                               1e-30)


def eigh3x3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric 3x3 eigendecomposition: ``(eigvals ascending
    (..., 3), eigvecs (..., 3, 3))`` with ``eigvecs[..., :, i]`` the i-th
    eigenvector."""
    vals = eigvals_sym3x3(a)
    v0 = _eigenvector_for(a, vals[..., 0])
    v2 = _eigenvector_for(a, vals[..., 2])
    v1 = torch.linalg.cross(v2, v0)
    v1 = v1 / torch.clamp_min(torch.linalg.vector_norm(v1, dim=-1, keepdim=True),
                              1e-30)
    return vals, torch.stack([v0, v1, v2], dim=-1)


def smallest_eigenvector_sym3x3(a: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvector, eigenvalue) of the smallest eigenpair."""
    lam = eigvals_sym3x3(a)[..., 0]
    return _eigenvector_for(a, lam), lam


def weighted_covariance(points: torch.Tensor, weights: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean and covariance over axis -2: ``points (..., K, 3)``,
    ``weights (..., K)`` (>= 0, zero = ignored) → ``(mean (..., 3), cov
    (..., 3, 3))``, the product in full fp32."""
    w = weights[..., None]
    wsum = torch.clamp_min(w.sum(-2), _EPS)
    mean = (points * w).sum(-2) / wsum
    d = (points - mean[..., None, :]) * torch.sqrt(w)
    cov = fp32_matmul(d.transpose(-1, -2), d) / wsum[..., None]
    return mean, cov


def kabsch_moments(source: torch.Tensor, target: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """The weighted statistics a rigid fit needs, as one (15,) tensor on
    the inputs' device: ``[μs (3), μt (3), H (9)]`` with
    H = Σ w (s − μs)(t − μt)ᵀ."""
    w = weights.to(source.dtype)
    wsum = torch.clamp_min(w.sum(), _EPS)
    mu_s = (source * w[:, None]).sum(0) / wsum
    mu_t = (target * w[:, None]).sum(0) / wsum
    h = fp32_matmul(((source - mu_s) * w[:, None]).T, target - mu_t)
    return torch.cat([mu_s, mu_t, h.reshape(9)])


def kabsch_from_moments(moments: torch.Tensor) -> torch.Tensor:
    """(4, 4) rigid transform from ``kabsch_moments``' output, with the
    det<0 reflection fix. Runs wherever ``moments`` lies; the callers
    pass a host copy."""
    mu_s, mu_t, h = moments[0:3], moments[3:6], moments[6:15].reshape(3, 3)
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(fp32_matmul(vt.T, u.T)))
    diag = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    r = fp32_matmul(fp32_matmul(vt.T, diag), u.T)
    m = torch.eye(4, dtype=h.dtype, device=h.device)
    m[:3, :3] = r
    m[:3, 3] = mu_t - fp32_matmul(r, mu_s)
    return m


def kabsch_from_sums(wsum: torch.Tensor, sum_s: torch.Tensor, sum_t: torch.Tensor,
                     sum_st: torch.Tensor) -> torch.Tensor:
    """``kabsch`` from precomputed weighted sums: Σw, Σw·s (3,), Σw·t (3,)
    and Σw·s⊗t (3, 3), the form a fused correspondence kernel emits. The
    same fit: H = Σw·s⊗t − Σw·μs⊗μt. The 3x3 SVD runs on the host and the
    (4, 4) transform comes back to the sums' device."""
    wsum = torch.clamp_min(torch.as_tensor(wsum, dtype=sum_s.dtype, device=sum_s.device),
                           _EPS)
    mu_s, mu_t = sum_s / wsum, sum_t / wsum
    h = sum_st - wsum * torch.outer(mu_s, mu_t)
    moments = torch.cat([mu_s, mu_t, h.reshape(9)]).cpu()
    return kabsch_from_moments(moments).to(sum_s.device)


def kabsch(source: torch.Tensor, target: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment (Kabsch/Umeyama, no scale): the (4, 4)
    transform minimising Σ wᵢ ‖R sᵢ + t − tᵢ‖², on the inputs' device.
    The moments reduce on the device; the 3x3 SVD runs on the host."""
    moments = kabsch_moments(source, target, weights).cpu()
    return kabsch_from_moments(moments).to(source.device)


def kabsch_batched(source: torch.Tensor, target: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``kabsch`` over a batch: ``(H, K, 3)`` point sets and ``(H, K)``
    weights → ``(H, 4, 4)`` transforms, with the det<0 reflection fix,
    all on the inputs' device (the JAX package's ``vmap(kabsch)``)."""
    w = weights.to(source.dtype)
    wsum = torch.clamp_min(w.sum(-1), _EPS)[:, None]
    mu_s = (source * w[..., None]).sum(-2) / wsum
    mu_t = (target * w[..., None]).sum(-2) / wsum
    ds = (source - mu_s[:, None]) * w[..., None]
    h = fp32_matmul(ds.transpose(-1, -2), target - mu_t[:, None])   # (H, 3, 3)
    with profiling.host_sync("kabsch.svd", h, 2):    # the solver's status is read back
        u, _, vt = torch.linalg.svd(h)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    d = torch.sign(_det3(fp32_matmul(v, ut)))
    diag = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    r = fp32_matmul(fp32_matmul(v, diag), ut)
    m = torch.eye(4, dtype=h.dtype, device=h.device).repeat(h.shape[0], 1, 1)
    m[:, :3, :3] = r
    m[:, :3, 3] = mu_t - fp32_matmul(r, mu_s[..., None])[..., 0]
    return m


def solve_psd(a: torch.Tensor, b: torch.Tensor, damping: float = 1e-9) -> torch.Tensor:
    """Solve the symmetric positive definite ``a x = b`` in fp32 by a
    Cholesky factorisation of ``a + damping·tr(a)/n·I`` (the 6x6
    point-to-plane system). Where the factorisation fails the result is
    NaN, as the JAX package's ``cho_solve`` gives."""
    n = a.shape[-1]
    a = a + damping * torch.trace(a) / n * torch.eye(n, dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b[..., None], chol)[..., 0]
    return torch.where(info == 0, x, torch.nan)


def transform_points(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) homogeneous matrix to (..., 3) points, in fp32."""
    return fp32_matmul(points, matrix[:3, :3].T) + matrix[:3, 3]
