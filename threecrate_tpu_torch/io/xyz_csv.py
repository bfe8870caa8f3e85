"""XYZ / CSV / TXT point files with delimiter & schema auto-detection.

Counterpart of ``threecrate_tpu.io.xyz_csv``, the same host NumPy code;
the reader returns a cloud on ``device`` (the card unless the caller
asks for the CPU), the stream reader host arrays.
Covers threecrate-io/src/xyz_csv.rs: delimiter sniffing (space, comma,
semicolon, tab), header detection, a ColumnType schema
(x/y/z/nx/ny/nz/r/g/b/intensity/skip) inferred from headers or column
count (xyz_csv.rs:60,114), streaming chunk reads and write options.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud

_DELIMS = [",", ";", "\t", " "]
_HEADER_ALIASES = {
    "x": "x", "y": "y", "z": "z",
    "nx": "nx", "ny": "ny", "nz": "nz",
    "normal_x": "nx", "normal_y": "ny", "normal_z": "nz",
    "r": "r", "g": "g", "b": "b",
    "red": "r", "green": "g", "blue": "b",
    "intensity": "intensity", "i": "intensity",
}


@dataclasses.dataclass
class XyzCsvSchema:
    """Column layout (ColumnType enum, xyz_csv.rs:60)."""

    delimiter: str
    columns: List[str]            # per-column role: x/y/z/nx/.../skip
    has_header: bool

    @classmethod
    def detect(cls, sample: str) -> "XyzCsvSchema":
        """Sniff delimiter + header + roles from the first lines
        (XyzCsvSchema::detect_from_file, xyz_csv.rs:114)."""
        lines = [ln for ln in sample.splitlines() if ln.strip()][:10]
        if not lines:
            raise InvalidDataError("empty XYZ/CSV file")
        # delimiter: the one splitting the most lines consistently
        best, best_cols = " ", 1
        for d in _DELIMS:
            counts = [len([t for t in ln.split(d) if t != ""]) for ln in lines]
            if len(set(counts)) == 1 and counts[0] > best_cols:
                best, best_cols = d, counts[0]
        first = [t.strip() for t in lines[0].split(best) if t.strip() != ""]

        def _is_num(tok: str) -> bool:
            try:
                float(tok)
                return True
            except ValueError:
                return False

        has_header = not all(_is_num(t) for t in first)
        if has_header:
            columns = [_HEADER_ALIASES.get(t.lower(), "skip") for t in first]
        else:
            n = len(first)
            if n < 3:
                raise InvalidDataError(f"need >= 3 columns, found {n}")
            columns = ["x", "y", "z"]
            rest = n - 3
            if rest == 1:
                columns += ["intensity"]
            elif rest == 3:
                columns += ["nx", "ny", "nz"]
            elif rest == 4:
                columns += ["intensity", "r", "g", "b"]
            elif rest >= 6:
                columns += ["nx", "ny", "nz", "r", "g", "b"]
                columns += ["skip"] * (rest - 6)
            else:
                columns += ["skip"] * rest
        if "x" not in columns or "y" not in columns or "z" not in columns:
            raise InvalidDataError(f"no x/y/z columns detected: {columns}")
        return cls(best, columns, has_header)


def _table_to_cloud(table: np.ndarray, schema: XyzCsvSchema, device) -> PointCloud:
    col = {name: i for i, name in enumerate(schema.columns) if name != "skip"}
    pts = np.stack([table[:, col["x"]], table[:, col["y"]],
                    table[:, col["z"]]], -1).astype(np.float32)
    attrs = {}
    if all(k in col for k in ("nx", "ny", "nz")):
        attrs["normals"] = np.stack(
            [table[:, col["nx"]], table[:, col["ny"]], table[:, col["nz"]]],
            -1).astype(np.float32)
    if all(k in col for k in ("r", "g", "b")):
        rgb = np.stack([table[:, col["r"]], table[:, col["g"]],
                        table[:, col["b"]]], -1)
        if rgb.max(initial=0.0) > 1.001:
            rgb = rgb / 255.0
        attrs["colors"] = rgb.astype(np.float32)
    if "intensity" in col:
        attrs["intensity"] = table[:, col["intensity"]].astype(np.float32)
    return PointCloud.from_numpy(pts, device=device, **attrs)


def _parse_rows(text: str, schema: XyzCsvSchema, skip_header: bool) -> np.ndarray:
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if skip_header and lines:
        lines = lines[1:]
    ncol = len(schema.columns)
    # fast path: the native parser treats space/tab/comma/semicolon as
    # delimiters, which covers every detected schema
    from ..native import parse_floats
    flat = parse_floats("\n".join(lines))
    if flat.size % ncol:
        raise InvalidDataError("ragged XYZ/CSV rows")
    return flat.reshape(-1, ncol)


def read_point_cloud(path, schema: Optional[XyzCsvSchema] = None, device="cuda",
                     **_) -> PointCloud:
    with open(path, "r", errors="replace") as f:
        text = f.read()
    if schema is None:
        schema = XyzCsvSchema.detect(text[:4096])
    table = _parse_rows(text, schema, schema.has_header)
    return _table_to_cloud(table, schema, device)


def read_point_cloud_stream(path, chunk_size: int = 65536,
                            schema: Optional[XyzCsvSchema] = None, **_
                            ) -> Iterator[np.ndarray]:
    with open(path, "r", errors="replace") as f:
        head = f.read(4096)
        f.seek(0)
        if schema is None:
            schema = XyzCsvSchema.detect(head)
        if schema.has_header:
            f.readline()
        while True:
            lines = f.readlines(chunk_size * 32)
            if not lines:
                return
            table = _parse_rows("".join(lines), schema, False)
            cloud = _table_to_cloud(table, schema, "cpu")
            yield cloud.to_numpy()


@dataclasses.dataclass
class XyzCsvWriteOptions:
    """xyz_csv.rs:654."""

    delimiter: str = " "
    header: bool = False
    precision: int = 6


def write_point_cloud(path, cloud: PointCloud,
                      options: Optional[XyzCsvWriteOptions] = None, **_) -> None:
    opts = options or XyzCsvWriteOptions()
    pts = cloud.to_numpy()
    cols = [pts]
    names = ["x", "y", "z"]
    if "normals" in cloud.attrs:
        cols.append(cloud.attr_to_numpy("normals"))
        names += ["nx", "ny", "nz"]
    if "intensity" in cloud.attrs:
        cols.append(cloud.attr_to_numpy("intensity")[:, None])
        names += ["intensity"]
    if "colors" in cloud.attrs:
        cols.append(cloud.attr_to_numpy("colors"))
        names += ["r", "g", "b"]
    mat = np.concatenate(cols, axis=1)
    d, p = opts.delimiter, opts.precision
    with open(path, "w") as f:
        if opts.header:
            f.write(d.join(names) + "\n")
        f.write("\n".join(d.join(f"{v:.{p}g}" for v in row) for row in mat))
        f.write("\n")
