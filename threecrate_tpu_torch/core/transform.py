"""Rigid/affine 3D transforms as ``(4, 4)`` float32 tensors.

Counterpart of ``threecrate_tpu.core.transform``: a :class:`Transform`
wraps one ``(4, 4)`` matrix on some device; ``apply`` on an ``(N, 3)``
tensor is one matmul plus an add. Matmuls run in full fp32 (TF32 off),
as the JAX package forces ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.linalg import fp32_matmul


def _as_matrix(m) -> torch.Tensor:
    m = torch.as_tensor(m, dtype=torch.float32)
    if m.shape[-2:] != (4, 4):
        raise ValueError(f"Transform matrix must be (..., 4, 4), got {tuple(m.shape)}")
    return m


@dataclasses.dataclass(frozen=True)
class Transform:
    """A 3D homogeneous transform; wraps a ``(4, 4)`` float32 tensor."""

    matrix: torch.Tensor

    @classmethod
    def identity(cls, device=None) -> "Transform":
        """The identity, on ``device`` (default the CPU)."""
        return cls(torch.eye(4, dtype=torch.float32, device=device))

    @classmethod
    def from_matrix(cls, m) -> "Transform":
        return cls(_as_matrix(m))

    @classmethod
    def from_translation(cls, t) -> "Transform":
        m = torch.eye(4)
        m[:3, 3] = torch.as_tensor(t, dtype=torch.float32)
        return cls(m)

    @classmethod
    def from_rotation_matrix(cls, r, t=None) -> "Transform":
        m = torch.eye(4)
        m[:3, :3] = torch.as_tensor(r, dtype=torch.float32)
        if t is not None:
            m[:3, 3] = torch.as_tensor(t, dtype=torch.float32)
        return cls(m)

    @classmethod
    def from_axis_angle(cls, axis, angle, t=None) -> "Transform":
        return cls.from_rotation_matrix(axis_angle_to_matrix(axis, angle), t)

    @classmethod
    def from_exp_coords(cls, xi) -> "Transform":
        """se(3) exponential of a 6-vector ``(rx, ry, rz, tx, ty, tz)``."""
        return cls(se3_exp(torch.as_tensor(xi, dtype=torch.float32)))

    @property
    def rotation(self) -> torch.Tensor:
        return self.matrix[..., :3, :3]

    @property
    def translation(self) -> torch.Tensor:
        return self.matrix[..., :3, 3]

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform ``(N, 3)`` points: ``R p + t``."""
        return fp32_matmul(points, self.rotation.transpose(-1, -2)) \
            + self.translation

    def compose(self, other: "Transform") -> "Transform":
        """Returns ``self ∘ other`` (apply ``other`` first)."""
        return Transform(fp32_matmul(self.matrix, other.matrix))

    def __matmul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    def inverse(self) -> "Transform":
        """Closed-form rigid inverse ``[Rᵀ | -Rᵀ t]``."""
        rt = self.rotation.transpose(-1, -2)
        m = torch.zeros_like(self.matrix)
        m[:3, :3] = rt
        m[:3, 3] = -fp32_matmul(rt, self.translation)
        m[3, 3] = 1.0
        return Transform(m)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) cross-product matrix."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def axis_angle_to_matrix(axis, angle) -> torch.Tensor:
    """Rodrigues rotation; ``axis`` need not be normalised."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis), 1e-30)
    angle = torch.as_tensor(angle, dtype=torch.float32)
    k = skew(axis)
    eye = torch.eye(3, dtype=torch.float32, device=axis.device)
    return eye + torch.sin(angle) * k + (1 - torch.cos(angle)) * fp32_matmul(k, k)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) → SE(3): 6-vector (ω | v) → (4, 4).

    Taylor-guarded at small angles, as the JAX version."""
    omega, v = xi[:3], xi[3:]
    theta2 = torch.dot(omega, omega)
    theta = torch.sqrt(theta2 + 1e-30)
    k = skew(omega)
    k2 = fp32_matmul(k, k)
    small = theta < 1e-5
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    m = torch.eye(4, dtype=xi.dtype, device=xi.device)
    m[:3, :3] = eye + a * k + b * k2
    m[:3, 3] = fp32_matmul(eye + b * k + c * k2, v)
    return m
