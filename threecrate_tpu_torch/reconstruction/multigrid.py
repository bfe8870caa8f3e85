"""Geometric multigrid for the screened Poisson system.

Counterpart of ``threecrate_tpu.reconstruction.multigrid``: a
cell-centred V-cycle for ``(ε' I − S) χ = b``, S the unscaled 7-point
stencil with replicate (Neumann) boundaries and ε' = screening·h²:

- smoother: weighted Jacobi (ω = 2/3);
- restriction: the mean over 2³ cells (``avg_pool3d``);
- prolongation: trilinear interpolation (``interpolate``, half-pixel
  centres, the JAX package's ``jax.image.resize``);
- coarsest level (≤ ``coarsest``³ cells): plain CG.

Under 2× coarsening the spacing doubles, so the screening term and the
restricted residual both scale by 4: ``(4ε' I − S) e_c = 4·R(r)``.

The loops are Python loops of device operations; the CG guards stay on
the device, so a solve never syncs the host.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _laplacian_stencil(x: torch.Tensor) -> torch.Tensor:
    """Unscaled 7-point stencil with replicate boundaries (the same
    operator as the JAX package's ``poisson._laplacian``)."""
    n0, n1, n2 = x.shape
    xp = F.pad(x[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    out = -6.0 * x
    out = out + xp[2:, 1:n1 + 1, 1:n2 + 1] + xp[:n0, 1:n1 + 1, 1:n2 + 1]
    out = out + xp[1:n0 + 1, 2:, 1:n2 + 1] + xp[1:n0 + 1, :n1, 1:n2 + 1]
    return out + xp[1:n0 + 1, 1:n1 + 1, 2:] + xp[1:n0 + 1, 1:n1 + 1, :n2]


def _apply_a(x: torch.Tensor, screening) -> torch.Tensor:
    return screening * x - _laplacian_stencil(x)


def _jacobi(x: torch.Tensor, b: torch.Tensor, screening, n: int,
            omega: float = 2.0 / 3.0) -> torch.Tensor:
    """``n`` weighted-Jacobi sweeps with the interior diagonal
    (screening + 6) everywhere: it perturbs only the smoother, not the
    solution."""
    step = omega / (screening + 6.0)
    for _ in range(n):
        x = x + step * (b - _apply_a(x, screening))
    return x


def _restrict(x: torch.Tensor) -> torch.Tensor:
    """Full-weighting 2× coarsening: the mean over 2³ cells."""
    return F.avg_pool3d(x[None, None], 2)[0, 0]


def _prolong(x: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    return F.interpolate(x[None, None], size=tuple(shape), mode="trilinear",
                         align_corners=False)[0, 0]


def _guard(d: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, d, 1e-30)


def _cg(apply_a, b: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` unpreconditioned CG iterations from zero, the
    denominators guarded on the device (no host sync)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = (r * r).sum()
    for _ in range(iters):
        ap = apply_a(p)
        denom = (p * ap).sum()
        alpha = rs / _guard(denom, denom.abs() > 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = (r * r).sum()
        p = r + rs_new / _guard(rs, rs > 1e-30) * p
        rs = rs_new
    return x


def _coarsest_cg(b: torch.Tensor, screening, iters: int) -> torch.Tensor:
    return _cg(lambda p: _apply_a(p, screening), b, iters)


def _v_cycle(b: torch.Tensor, screening, *, nu1: int, nu2: int, coarsest: int,
             coarsest_iters: int) -> torch.Tensor:
    """One V(nu1, nu2) cycle for (screening·I − S) x = b from a zero
    guess."""
    if b.shape[0] <= coarsest:
        return _coarsest_cg(b, screening, coarsest_iters)
    x = _jacobi(torch.zeros_like(b), b, screening, nu1)
    r = b - _apply_a(x, screening)
    ec = _v_cycle(4.0 * _restrict(r), 4.0 * screening, nu1=nu1, nu2=nu2,
                  coarsest=coarsest, coarsest_iters=coarsest_iters)
    x = x + _prolong(ec, b.shape)
    return _jacobi(x, b, screening, nu2)


def mg_solve(b: torch.Tensor, screening, cycles: int = 12, nu1: int = 3, nu2: int = 3,
             coarsest: int = 8, coarsest_iters: int = 128) -> torch.Tensor:
    """Solve (screening·I − S) x = b with ``cycles`` V-cycles on ``b``'s
    device. The residual contracts ~0.1-0.2 a cycle on smooth right-hand
    sides."""
    screening = torch.as_tensor(screening, dtype=torch.float32, device=b.device)
    x = torch.zeros_like(b)
    for _ in range(cycles):
        r = b - _apply_a(x, screening)
        x = x + _v_cycle(r, screening, nu1=nu1, nu2=nu2, coarsest=coarsest,
                         coarsest_iters=coarsest_iters)
    return x


def mg_residual_norm(b: torch.Tensor, x: torch.Tensor, screening) -> torch.Tensor:
    """‖b − A x‖ / ‖b‖, a 0-d tensor on ``b``'s device."""
    r = b - _apply_a(x, torch.as_tensor(screening, dtype=torch.float32, device=b.device))
    return torch.sqrt((r * r).sum() / torch.clamp_min((b * b).sum(), 1e-30))
