"""The least time the card could take for a piece of work.

Frozen copies of ``chip_smoke.py``'s roofline arithmetic:
``HBM_BYTES_PER_S`` and ``FP32_OPS_PER_S`` (``chip_smoke.py:484-485``,
NVIDIA's data sheet for the H100 SXM at its 700 W limit), ``bound``
(``:1154-1159``), ``union_window_ops`` and ``union_work``
(``:1161-1174``). Work is counted from the shapes: each input byte read
once, each output byte written once, and the operations the function
needs whatever the kernel does again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores


def bound(nbytes: float, ops: float):
    """(least seconds, what bounds it) for ``nbytes`` moved and ``ops``
    fp32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def union_window_ops(n_u, tile, band):
    """fp32 operations of a union pass's selection on ``n_u`` queries:
    each of the 3·tile window candidates' d² (~9), a compare with the
    current k-th (1) and the selection test (1), ~2 per ±band candidate,
    12 per query for the six halvings."""
    return n_u * (3 * tile * (9 + 1 + 1) + (2 * band + 1) * 2 + 6 * 2)


def union_work(n_u, tile, band, pairs_a, pairs_b):
    """((bytes, ops) of pass A, (bytes, ops) of pass B) at the band they
    run (max(band, k)), with ``pairs_a`` / ``pairs_b`` selected pairs at
    ~19 operations each (3 differences, 6 products, 10 additions); pass B
    adds the pass-A tile test (~3) per window candidate."""
    ops = union_window_ops(n_u, tile, band)
    return ((4 * n_u * (4 + 11), ops + pairs_a * 19),
            (4 * n_u * (6 + 11), ops + n_u * 3 * tile * 3 + pairs_b * 19))


def icp_match_work(ns, nt, tile):
    """(bytes, ops) of one ``icp_match`` launch without payload rows
    (``chip_smoke.py:1220-1221``'s bytes): the moved source (4, Ns) and
    the sorted target (4, Nt) read, one window start a source tile, the
    (4, Ns) matches written. The operations are one d² (9) a source
    point, the least any search computes: the bound is the bytes'."""
    return 4 * (4 * ns + 4 * nt + ns // tile + 4 * ns), 9 * ns


def search_work(q, n, d, passes, hypotheses, correspondences):
    """(bytes, ops) of descriptor matching plus RANSAC scoring: 2·Q·N·D
    fp32 operations a matching pass (the distances' multiply-adds),
    ~31 a hypothesis and correspondence (the rotation's 9 products and 9
    sums, 3 for the translation, the residual's 3 differences, 3 squares
    and 2 sums, the threshold and validity tests); the descriptors and
    validity of both sides read once, each query's match, distance and
    flag written once, the correspondences read once and each
    hypothesis's pose and count written once."""
    nbytes = (4 * d + 1) * (q + n) + 13 * q + 24 * correspondences + 68 * hypotheses
    return nbytes, 2.0 * q * n * d * passes + 31.0 * hypotheses * correspondences
