"""Marching-cubes triangle table, derived algorithmically: the port's
copy of ``threecrate_tpu.reconstruction.mc_tables`` (NumPy only), so
that the port imports nothing of the JAX package.

Instead of embedding the classic hand-written 256-entry lookup tables,
this module *derives* them at import time by edge-loop tracing: for
each of the 256 corner sign patterns, the cut edges are connected into
closed loops by pairing cut edges within each cube face (the pairing
rule depends only on the face's own sign pattern, so adjacent cubes
always agree → watertight surfaces), and each loop is fan-triangulated.
Winding is normalised downstream by the same gradient test the
marching-tetrahedra path uses.

Cube corners are indexed by coordinate bits: corner = x + 2y + 4z.
Edges are the 12 (corner, corner) pairs below; faces list their corners
in cyclic boundary order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

CORNERS = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
# corner index = x + 2y + 4z


def _corner(x, y, z):
    return x + 2 * y + 4 * z

EDGES: List[Tuple[int, int]] = []
for a in range(8):
    for b in range(a + 1, 8):
        ax, ay, az = a & 1, (a >> 1) & 1, (a >> 2) & 1
        bx, by, bz = b & 1, (b >> 1) & 1, (b >> 2) & 1
        if abs(ax - bx) + abs(ay - by) + abs(az - bz) == 1:
            EDGES.append((a, b))
EDGE_ID = {e: i for i, e in enumerate(EDGES)}
assert len(EDGES) == 12

# each face as its 4 corners in cyclic order
FACES = [
    [_corner(0, 0, 0), _corner(1, 0, 0), _corner(1, 1, 0), _corner(0, 1, 0)],  # z=0
    [_corner(0, 0, 1), _corner(1, 0, 1), _corner(1, 1, 1), _corner(0, 1, 1)],  # z=1
    [_corner(0, 0, 0), _corner(1, 0, 0), _corner(1, 0, 1), _corner(0, 0, 1)],  # y=0
    [_corner(0, 1, 0), _corner(1, 1, 0), _corner(1, 1, 1), _corner(0, 1, 1)],  # y=1
    [_corner(0, 0, 0), _corner(0, 1, 0), _corner(0, 1, 1), _corner(0, 0, 1)],  # x=0
    [_corner(1, 0, 0), _corner(1, 1, 0), _corner(1, 1, 1), _corner(1, 0, 1)],  # x=1
]


def _face_links(case: int, face: List[int]) -> List[Tuple[int, int]]:
    """Pair the face's cut edges into surface segments.

    Walking the face boundary, a cut edge opens or closes an inside run;
    pairing each cut edge with the next cut edge reached *through
    outside corners* draws segments that separate inside from outside,
    and depends only on this face's sign pattern (adjacent cubes share
    it) — the watertightness invariant.
    """
    inside = [(case >> c) & 1 for c in face]
    cuts = []
    for i in range(4):
        j = (i + 1) % 4
        if inside[i] != inside[j]:
            a, b = face[i], face[j]
            cuts.append((i, EDGE_ID[(min(a, b), max(a, b))]))
    if not cuts:
        return []
    if len(cuts) == 2:
        return [(cuts[0][1], cuts[1][1])]
    # 4 cuts (ambiguous face): pair each cut with the next cut reached
    # through an OUTSIDE corner (fixed, pattern-local rule)
    links = []
    for (i, e) in cuts:
        # the corner after the crossing along the walk is face[(i+1)%4];
        # pair only when that corner is OUTSIDE (we traverse the outside
        # arc to the next cut)
        if inside[(i + 1) % 4] == 0:
            # find the cut whose boundary index is the next one cyclically
            nxt = min(((j - i - 1) % 4, ej) for (j, ej) in cuts
                      if j != i)
            links.append((e, nxt[1]))
    return links


def _loops_for_case(case: int) -> List[List[int]]:
    """Closed loops of cut-edge ids for one sign pattern."""
    adj: Dict[int, List[int]] = {}
    for face in FACES:
        for a, b in _face_links(case, face):
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
    loops = []
    unused = set(adj)
    while unused:
        start = min(unused)
        loop = [start]
        unused.discard(start)
        prev, cur = None, start
        while True:
            nxts = [n for n in adj[cur] if n != prev]
            # each cut edge has exactly two links (one per adjacent face)
            nxt = nxts[0] if nxts else adj[cur][0]
            if nxt == start:
                break
            loop.append(nxt)
            unused.discard(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def build_tables(max_tris: int = 5):
    """(tri_table (256, max_tris, 3) edge ids with -1 padding,
    n_tris (256,))."""
    tri_table = -np.ones((256, max_tris, 3), np.int32)
    n_tris = np.zeros((256,), np.int32)
    for case in range(256):
        tris = []
        for loop in _loops_for_case(case):
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        assert len(tris) <= max_tris, (case, len(tris))
        for t, tri in enumerate(tris):
            tri_table[case, t] = tri
        n_tris[case] = len(tris)
    return tri_table, n_tris


TRI_TABLE, N_TRIS = build_tables()


def _pack_tri_table():
    """(256, 2) int32: the 15 per-case edge ids as 4-bit fields
    (sentinel 15 for absent slots): two table gathers per cube instead
    of 15 in the marching-cubes extractor."""
    flat = np.asarray(TRI_TABLE).reshape(256, 15)
    packed = np.zeros((256, 2), np.int64)
    for c in range(256):
        for j in range(15):
            v = int(flat[c, j])
            v = 15 if v < 0 else v
            packed[c, j // 8] |= v << ((j % 8) * 4)
    return (packed & 0xFFFFFFFF).astype(np.uint32).view(np.int32
                                                        ).reshape(256, 2)


TRI_PACKED = _pack_tri_table()
EDGE_CORNERS = np.asarray(EDGES, np.int32)  # (12, 2)
