"""Static-sort ICP correspondence: nearest target within a window.

``icp_match_tiles`` replaces the Pallas kernel of the same name in
``threecrate_tpu/kernels/icp_pallas.py`` (body ``_icp_match_kernel``).
On a CUDA tensor it launches the hand-written kernel of
``csrc/icp_match.cu``; on a CPU tensor it runs ``icp_match_plain``,
which computes the same function and is what the kernel is checked
against.

Inputs: ``src_packed`` (4, Ns) = [moved x, y, z, valid] in the source's
Morton order; ``tgt_packed`` (4+E, Nt) = [x, y, z, valid, extra (E)],
Morton-sorted, invalid targets at 2e19 sentinel coordinates (their d²
overflows to +inf); ``window_start`` (Ns/tile,) int32, the first of the
``w_tiles`` target tiles each source tile searches. Output (4+E, Ns) =
[matched x, y, z, match-valid, matched extra (E)]. Exact ties average
their payloads; an all-invalid window gives zeros and match-valid 0; an
invalid source point gets match-valid 0 (its payload is still the
window's nearest, as in the Pallas kernel).

On the card this is an fp32 ALU-bound scan of w_tiles·tile candidates
per point from shared memory (see ``csrc/icp_match.cu``).
"""

from __future__ import annotations

import torch

from ..ops.linalg import fp32_matmul
from . import _build

W_TILES = 4          # the Pallas module's default window width
_SENTINEL = 2e19
_SMEM_LIMIT = 227 * 1024
_CHUNK_TILES = 256   # source tiles per step of the plain version


def _check(src_packed, tgt_packed, window_start, tile, w_tiles):
    ns, nt = src_packed.shape[1], tgt_packed.shape[1]
    rows = tgt_packed.shape[0]
    if src_packed.shape[0] != 4 or rows < 4:
        raise ValueError(f"expected (4, Ns) source and (4+E, Nt) target, got "
                         f"{tuple(src_packed.shape)} and {tuple(tgt_packed.shape)}")
    if tile <= 0 or tile > 1024 or ns == 0 or ns % tile or nt % tile \
            or nt < w_tiles * tile or w_tiles < 1:
        raise ValueError(f"Ns={ns} and Nt={nt} must be multiples of tile={tile}, "
                         f"with Nt >= w_tiles·tile (w_tiles={w_tiles})")
    if window_start.shape != (ns // tile,):
        raise ValueError(f"window_start must be ({ns // tile},), got "
                         f"{tuple(window_start.shape)}")
    for t in (tgt_packed, window_start):
        if t.device != src_packed.device:
            raise ValueError("all inputs must be on one device")
    return ns, nt, rows


def icp_match_plain(src_packed, tgt_packed, window_start, tile: int = 128,
                    w_tiles: int = W_TILES) -> torch.Tensor:
    """Plain PyTorch version, chunked over source tiles."""
    ns, nt, rows = _check(src_packed, tgt_packed, window_start, tile, w_tiles)
    dev = src_packed.device
    wc = w_tiles * tile
    # payload rows [x, y, z, extra...]; the valid row is not read (the
    # sentinels already make invalid targets unmatchable)
    pay_rows = torch.cat([tgt_packed[0:3], tgt_packed[4:]])
    fill = torch.tensor([_SENTINEL] * 3 + [0.0] * (rows - 4), device=dev)
    out = torch.empty((rows, ns), dtype=torch.float32, device=dev)
    for t0 in range(0, ns // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, ns // tile)
        cols = window_start[t0:t1, None].long() * tile \
            + torch.arange(wc, device=dev)
        inside = (cols >= 0) & (cols < nt)
        pay = torch.where(inside[None], pay_rows[:, cols.clamp(0, nt - 1)],
                          fill[:, None, None])                # (3+E, T, wc)
        q = src_packed[0:3, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
        d = [pay[r][:, None, :] - q[r][:, :, None] for r in range(3)]
        s = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]            # (T, tile, wc)
        m = s.amin(2)
        found = m < torch.inf
        chosen = (s == m[..., None]) & found[..., None]
        cnt = torch.clamp_min(chosen.sum(2, dtype=torch.float32), 1.0)
        # one-hot gather of the payload, averaged over exact ties
        mt = fp32_matmul(chosen.to(torch.float32), pay.permute(1, 2, 0)) \
            / cnt[..., None]                                   # (T, tile, 3+E)
        mt = mt.reshape(-1, rows - 1).T
        sl = slice(t0 * tile, t1 * tile)
        out[0:3, sl] = mt[0:3]
        out[3, sl] = ((src_packed[3, sl] > 0.5) & found.reshape(-1)).to(torch.float32)
        out[4:, sl] = mt[3:]
    return out


def icp_match_tiles(src_packed, tgt_packed, window_start, tile: int = 128,
                    w_tiles: int = W_TILES) -> torch.Tensor:
    """Nearest-in-window correspondence of moved source vs sorted target."""
    if not _build.on_card(src_packed):
        return icp_match_plain(src_packed, tgt_packed, window_start, tile,
                               w_tiles)
    ns, nt, rows = _check(src_packed, tgt_packed, window_start, tile, w_tiles)
    if (rows - 1) * w_tiles * tile * 4 > _SMEM_LIMIT:
        raise ValueError(f"a window of {w_tiles}x{tile} targets with {rows - 4} "
                         "extra rows exceeds the shared memory of a block")
    if src_packed.dtype != torch.float32 or tgt_packed.dtype != torch.float32 \
            or window_start.dtype != torch.int32:
        raise TypeError("expected float32 source/target and int32 window_start")
    src = src_packed.contiguous()
    tgt = tgt_packed.contiguous()
    blk = window_start.contiguous()
    out = torch.empty((rows, ns), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        err = _build.lib().tc_icp_match(
            src.data_ptr(), tgt.data_ptr(), blk.data_ptr(), out.data_ptr(),
            ns, nt, rows, tile, w_tiles, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "icp_match")
    icp_match_tiles.launches += 1
    return out


icp_match_tiles.launches = 0
