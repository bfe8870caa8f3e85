"""STL reader/writer (ASCII + binary) with normal recompute.

Counterpart of ``threecrate_tpu.io.stl``, the same host NumPy code;
the reader returns a mesh on ``device`` (the card unless the caller
asks for the CPU).
Covers threecrate-io/src/stl.rs:20-271. Binary decode is one structured
``np.frombuffer`` over the 50-byte triangle records; vertex dedup uses a
rounded-coordinate ``np.unique`` so shared corners weld into a proper
indexed mesh (the reference welds identically).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh

_BIN_TRI = np.dtype([("normal", "<f4", (3,)), ("verts", "<f4", (3, 3)),
                     ("attr", "<u2")])


def _weld(tri_verts: np.ndarray, decimals: int = 6
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 3, 3) corner soup → (verts, faces) via rounded-key dedup."""
    flat = tri_verts.reshape(-1, 3)
    keys = np.round(flat, decimals)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    # representative positions: first occurrence (not the rounded key)
    first = np.full(len(uniq), -1, np.int64)
    seen = np.zeros(len(uniq), bool)
    order = np.arange(len(flat))
    # vectorised "first occurrence per group"
    rev = np.empty_like(order)
    srt = np.argsort(inv, kind="stable")
    grp_first = np.ones(len(flat), bool)
    grp_first[1:] = inv[srt][1:] != inv[srt][:-1]
    first[inv[srt][grp_first]] = srt[grp_first]
    verts = flat[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float32), faces


def read_mesh(path, weld: bool = True, device="cuda", **_) -> TriangleMesh:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 84:
        # tiny file: may still be ascii
        if data.lstrip().startswith(b"solid"):
            return _read_ascii(data, device)
        raise InvalidDataError("STL file too small")
    is_ascii = data.lstrip().startswith(b"solid")
    if is_ascii:
        # binary files can also start with "solid": verify the count math
        n_tri = int(np.frombuffer(data, "<u4", 1, 80)[0])
        if len(data) == 84 + 50 * n_tri:
            is_ascii = False
    if is_ascii:
        return _read_ascii(data, device)
    n_tri = int(np.frombuffer(data, "<u4", 1, 80)[0])
    if len(data) < 84 + 50 * n_tri:
        raise InvalidDataError("binary STL truncated")
    rec = np.frombuffer(data, _BIN_TRI, n_tri, 84)
    verts, faces = _weld(np.ascontiguousarray(rec["verts"]))
    return TriangleMesh.from_numpy(verts, faces, device=device)


def _read_ascii(data: bytes, device) -> TriangleMesh:
    toks = data.decode("ascii", errors="replace").split()
    coords = []
    i = 0
    while i < len(toks):
        if toks[i] == "vertex":
            coords.extend(toks[i + 1:i + 4])
            i += 4
        else:
            i += 1
    if not coords or len(coords) % 9:
        raise InvalidDataError("malformed ascii STL")
    tri = np.array(coords, np.float32).reshape(-1, 3, 3)
    verts, faces = _weld(tri)
    return TriangleMesh.from_numpy(verts, faces, device=device)


def write_mesh(path, mesh: TriangleMesh, binary: bool = True, **_) -> None:
    v, f = mesh.to_numpy()
    tri = v[f]  # (T, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True).clip(1e-30)
    if binary:
        rec = np.zeros(len(f), _BIN_TRI)
        rec["normal"] = n
        rec["verts"] = tri
        with open(path, "wb") as fh:
            fh.write(b"threecrate-tpu binary STL".ljust(80, b" "))
            fh.write(np.uint32(len(f)).tobytes())
            fh.write(rec.tobytes())
    else:
        lines = ["solid threecrate"]
        for ni, ti in zip(n, tri):
            lines.append(f"  facet normal {ni[0]:.6e} {ni[1]:.6e} {ni[2]:.6e}")
            lines.append("    outer loop")
            for p in ti:
                lines.append(f"      vertex {p[0]:.6e} {p[1]:.6e} {p[2]:.6e}")
            lines.append("    endloop")
            lines.append("  endfacet")
        lines.append("endsolid threecrate")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
