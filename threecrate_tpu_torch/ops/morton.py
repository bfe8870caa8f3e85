"""Morton (Z-order) keys for spatial locality sorts.

Counterpart of ``threecrate_tpu.ops.morton``, bit-exact: 10 bits per
axis, 30-bit int32 keys, ``INT32_MAX`` for invalid points, the same
per-pass lattice shifts and axis roll.

Three details keep the keys equal to the JAX ones:

* ``(GRID-1) / (2·max ext)`` is a true fp32 division (see ``_scale``);
* the spread only shifts values below 2^10 left by at most 16, and the
  final keys use bits 0..29, so no shift overflows int32;
* a float→int32 conversion of a value outside int32's range is
  undefined in C (x86 gives INT32_MIN, CUDA saturates) while XLA
  saturates. Lattice coordinates are clamped to [0, GRID-1] in float
  BEFORE the conversion, which equals XLA's convert-then-clip for every
  finite value.
"""

from __future__ import annotations

import torch

BITS = 10
GRID = 1 << BITS  # 1024
INT32_MAX = 2 ** 31 - 1

PASS_SHIFTS = (
    (0.0, 0.0, 0.0),
    (0.381966, 0.618034, 0.236068),
    (0.754877, 0.324717, 0.569840),
    (0.177124, 0.827090, 0.429203),
)


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x so consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(coords: torch.Tensor) -> torch.Tensor:
    """(…, 3) int cell coords in [0, 1024) → (…,) int32 Morton key."""
    c = coords.to(torch.int32)
    return (_spread_bits(c[..., 0])
            | (_spread_bits(c[..., 1]) << 1)
            | (_spread_bits(c[..., 2]) << 2))


def _scale(ext: torch.Tensor) -> torch.Tensor:
    # (GRID-1) / (2·max ext) as a true fp32 division: ``scalar / tensor``
    # in torch is ``reciprocal() * scalar``, which rounds differently on
    # about a quarter of inputs and would move cell boundaries.
    den = 2.0 * ext.amax()
    return torch.full_like(den, GRID - 1) / den


def _cells(rel: torch.Tensor) -> torch.Tensor:
    return rel.clamp(0.0, GRID - 1).to(torch.int32)


def _masked_keys(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, keys, torch.full_like(keys, INT32_MAX))


def _min_max(points: torch.Tensor, mask: torch.Tensor):
    big = 3e38
    m = mask[:, None]
    return (torch.where(m, points, big).amin(0),
            torch.where(m, points, -big).amax(0))


def frame(points: torch.Tensor, mask: torch.Tensor):
    """(mn, scale) of the masked cloud's isotropic Morton lattice, so other
    points can be encoded into the same lattice (``keys_in_frame``)."""
    mn, mx = _min_max(points, mask)
    return mn, _scale(torch.clamp_min(mx - mn, 1e-6))


def keys_in_frame(points: torch.Tensor, mask: torch.Tensor,
                  mn: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Morton keys of ``points`` in a fixed lattice frame; out-of-frame
    coordinates clamp to the boundary cells. Invalid points get
    INT32_MAX."""
    return _masked_keys(morton_encode(_cells((points - mn) * scale)), mask)


def morton_keys(points: torch.Tensor, mask: torch.Tensor,
                pass_index: int = 0) -> torch.Tensor:
    """Morton keys over the masked bounding box for one search pass."""
    mn, mx = _min_max(points, mask)
    return keys_in_frame_pass(points, mask, mn, torch.clamp_min(mx - mn, 1e-6),
                              pass_index)


def keys_in_frame_pass(points: torch.Tensor, mask: torch.Tensor,
                       mn: torch.Tensor, ext: torch.Tensor,
                       pass_index: int = 0) -> torch.Tensor:
    """Pass-shifted Morton keys with an explicit frame (mn, ext)."""
    # fp32(shift fraction) · ext per axis, built on ext's device
    shift = torch.stack([ext[i] * s for i, s in
                         enumerate(PASS_SHIFTS[pass_index % len(PASS_SHIFTS)])])
    cells = _cells((points - mn + shift) * _scale(ext))
    if pass_index:
        cells = torch.roll(cells, pass_index % 3, dims=-1)
    return _masked_keys(morton_encode(cells), mask)
