"""Descriptor matching: each query's nearest valid database row.

``match_nearest_tiles`` replaces no Pallas kernel (the JAX package
leaves matching to XLA); it is the port's kernel for
``ops.features.match_descriptors``. On CUDA tensors it launches the
hand-written kernel of ``csrc/match.cu`` once for the forward direction
(``desc_a`` against the valid rows of ``desc_b``) and, with ``mutual``,
once more with the sides swapped. On CPU tensors it runs
``match_nearest_plain``: one fp32 matmul up to 2^26 pair products, else
the tiled ``neighbors.knn``, which is what the JAX package computes, bit
for bit.

Both return ``(j, dist, back)``: each ``desc_a`` row's nearest valid
``desc_b`` row, its distance (+inf where ``desc_b`` has no valid row,
and on the knn path also where ``valid_a`` is off) and, with
``mutual``, each ``desc_b`` row's nearest valid ``desc_a`` row (else
None). Ties go to the lowest row.

The kernel packs each answer as one 64-bit word, ``(float_bits(d²) <<
32) | row`` (``pack``/``unpack``); the wrapper fills the output with
``SENTINEL`` (+inf, row 0), blocks combine with ``atomicMin``, and
nothing is read back to the host. d² is max(‖q‖² + ‖p‖² − 2·q·p, 0)
with the norms computed here as ``neighbors.knn`` computes them and q·p
an fp32 FMA chain: it differs from the plain version's cuBLAS product
only in summation order, so only near-ties (within a few ulps of
‖q‖² + ‖p‖²) can pick another row.
"""

from __future__ import annotations

import torch

from ..ops import neighbors
from ..ops.linalg import fp32_matmul
from . import _build

SENTINEL = 0x7F800000 << 32    # (+inf bits, row 0): no valid database row
_ONE_MATMUL = 2 ** 26          # pair products up to which the plain version is one matmul
_ROWS = 128                    # the kernel's row padding (csrc/match.cu kTile)


def pack(d2: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The kernel's int64 words of (d² >= 0 float32, row): ordered by d²,
    then by row; −0 is stored as +0."""
    bits = (d2.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    return (bits << 32) | rows.to(torch.int64)


def unpack(words: torch.Tensor):
    """(d² float32, row int64) of packed words."""
    return (words >> 32).to(torch.int32).view(torch.float32), words & 0xFFFFFFFF


def match_nearest_plain(desc_a, valid_a, desc_b, valid_b, mutual: bool = False):
    """Plain PyTorch version: the port's matching before the kernel."""
    na, nb = desc_a.shape[0], desc_b.shape[0]
    if na * nb > _ONE_MATMUL:
        res = neighbors.knn(desc_b, valid_b, desc_a, valid_a, 1)
        back = (neighbors.knn(desc_a, valid_a, desc_b, valid_b, 1).indices[:, 0]
                if mutual else None)
        return res.indices[:, 0], res.distances[:, 0], back
    an = (desc_a * desc_a).sum(1)
    bn = (desc_b * desc_b).sum(1)
    d2 = an[:, None] + bn[None, :] - 2.0 * fp32_matmul(desc_a, desc_b.T)
    d2 = torch.where(valid_b[None, :], d2, torch.inf)
    j = torch.argmin(d2, dim=1)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, 1, j[:, None])[:, 0], 0.0))
    back = (torch.argmin(torch.where(valid_a[:, None], d2, torch.inf), dim=0)
            if mutual else None)
    return j, dist, back


def _check(desc_a, valid_a, desc_b, valid_b):
    if desc_a.dim() != 2 or desc_b.dim() != 2 or desc_a.shape[1] != desc_b.shape[1]:
        raise ValueError(f"expected (Na, D) and (Nb, D) descriptors, got "
                         f"{tuple(desc_a.shape)} and {tuple(desc_b.shape)}")
    (na, d), nb = desc_a.shape, desc_b.shape[0]
    if valid_a.shape != (na,) or valid_b.shape != (nb,):
        raise ValueError(f"expected ({na},) and ({nb},) validity, got "
                         f"{tuple(valid_a.shape)} and {tuple(valid_b.shape)}")
    for t in (valid_a, desc_b, valid_b):
        if t.device != desc_a.device:
            raise ValueError("all inputs must be on one device")
    if desc_a.dtype != torch.float32 or desc_b.dtype != torch.float32:
        raise TypeError("descriptors must be float32")
    if valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise TypeError("validity must be bool")
    if na == 0 or nb == 0 or d == 0:
        raise ValueError(f"matching needs queries, database rows and a dimension, got "
                         f"({na}, {d}) and ({nb}, {d})")


def _layout(x, rows: int):
    """(D, rows) float32: x transposed, zero padded (the kernel's layout)."""
    out = x.new_zeros((x.shape[1], rows))
    out[:, :x.shape[0]] = x.T
    return out


def _norms(x, valid, rows: int):
    """Squared norms as neighbors.knn computes them, +inf where invalid
    (valid None: every row valid) and in the padding."""
    n = (x * x).sum(-1)
    if valid is not None:
        n = torch.where(valid, n, torch.inf)
    return torch.nn.functional.pad(n, (0, rows - x.shape[0]),
                                   value=0.0 if valid is None else torch.inf)


def _nearest(queries, db, db_valid) -> torch.Tensor:
    """One kernel launch: packed words (Q,) of each query's nearest valid row."""
    q, d = queries.shape
    ldq, ldn = -(-q // _ROWS) * _ROWS, -(-db.shape[0] // _ROWS) * _ROWS
    at, qn = _layout(queries, ldq), _norms(queries, None, ldq)
    bt, pn = _layout(db, ldn), _norms(db, db_valid, ldn)
    out = torch.full((q,), SENTINEL, dtype=torch.int64, device=queries.device)
    with torch.cuda.device(queries.device):
        err = _build.lib().tc_match_nearest(
            at.data_ptr(), qn.data_ptr(), bt.data_ptr(), pn.data_ptr(), out.data_ptr(),
            q, ldq, ldn, d, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "match_nearest")
    match_nearest_tiles.launches += 1
    return out


def match_nearest_tiles(desc_a, valid_a, desc_b, valid_b, mutual: bool = False):
    """Nearest valid ``desc_b`` row of each ``desc_a`` row: ``(j, dist,
    back)`` as the module docstring says."""
    if not _build.on_card(desc_a):
        return match_nearest_plain(desc_a, valid_a, desc_b, valid_b, mutual)
    _check(desc_a, valid_a, desc_b, valid_b)
    d2, j = unpack(_nearest(desc_a, desc_b, valid_b))
    back = unpack(_nearest(desc_b, desc_a, valid_a))[1] if mutual else None
    return j, torch.sqrt(d2), back


match_nearest_tiles.launches = 0
