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
    def from_scaling(cls, s) -> "Transform":
        s = torch.as_tensor(s, dtype=torch.float32).broadcast_to((3,))
        return cls(torch.diag(torch.cat([s, torch.ones(1, device=s.device)])))

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
    def from_quaternion(cls, q, t=None) -> "Transform":
        """Unit quaternion ``(w, x, y, z)`` (+ optional translation)."""
        return cls.from_rotation_matrix(quaternion_to_matrix(q), t)

    @classmethod
    def from_euler_xyz(cls, angles, t=None) -> "Transform":
        """Intrinsic XYZ euler angles ``(rx, ry, rz)`` in radians."""
        rx, ry, rz = torch.as_tensor(angles, dtype=torch.float32)
        ex = axis_angle_to_matrix([1.0, 0.0, 0.0], rx)
        ey = axis_angle_to_matrix([0.0, 1.0, 0.0], ry)
        ez = axis_angle_to_matrix([0.0, 0.0, 1.0], rz)
        return cls.from_rotation_matrix(fp32_matmul(fp32_matmul(ez, ey), ex), t)

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

    def apply_point(self, point) -> torch.Tensor:
        p = torch.as_tensor(point, dtype=torch.float32, device=self.matrix.device)
        return fp32_matmul(self.rotation, p) + self.translation

    def apply_vector(self, vec) -> torch.Tensor:
        """Rotate only (the 3x3 block)."""
        v = torch.as_tensor(vec, dtype=torch.float32, device=self.matrix.device)
        return fp32_matmul(v, self.rotation.transpose(-1, -2))

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


def quaternion_to_matrix(q) -> torch.Tensor:
    """Unit quaternion ``(w, x, y, z)`` → (3, 3) rotation matrix."""
    q = torch.as_tensor(q, dtype=torch.float32)
    w, x, y, z = q / torch.linalg.vector_norm(q)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def matrix_to_quaternion(r) -> torch.Tensor:
    """(3, 3) rotation matrix → unit quaternion ``(w, x, y, z)``; branch-free
    (each component from its own diagonal combination, its sign from the
    antisymmetric part)."""
    r = torch.as_tensor(r, dtype=torch.float32)
    m00, m11, m22 = r[0, 0], r[1, 1], r[2, 2]
    qw = torch.sqrt(torch.clamp_min(1 + (m00 + m11 + m22), 0.0)) / 2
    qx = torch.sqrt(torch.clamp_min(1 + m00 - m11 - m22, 0.0)) / 2
    qy = torch.sqrt(torch.clamp_min(1 - m00 + m11 - m22, 0.0)) / 2
    qz = torch.sqrt(torch.clamp_min(1 - m00 - m11 + m22, 0.0)) / 2
    qx = torch.copysign(qx, r[2, 1] - r[1, 2])
    qy = torch.copysign(qy, r[0, 2] - r[2, 0])
    qz = torch.copysign(qz, r[1, 0] - r[0, 1])
    q = torch.stack([qw, qx, qy, qz])
    return q / torch.linalg.vector_norm(q)


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
