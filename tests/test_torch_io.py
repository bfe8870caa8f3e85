"""File I/O: the PyTorch port (``threecrate_tpu_torch.io`` and
``.native``) against the JAX package on the same files, on the CPU.

Stated tolerances: none. The readers and writers are copies of the JAX
package's host NumPy code, so every array read is bit-equal to JAX's
read of the same file, whichever package wrote it, and every writer's
file is byte-equal to JAX's for the same cloud or mesh. Errors raise
the same type (by name: the packages define their own classes) with
the same message. The native float parser is held to NumPy's: within
2 ulp in float64 (its fast path sums digits without correct rounding)
and bit-equal once rounded to float32, which is what every reader
keeps. Inputs come from numpy seeds: 700 points with normals, colours
and intensity, a noisy UV sphere mesh, and synthesized PCAP, LVX and
LVX2 recordings.
"""

import inspect
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu import PointCloud as JCloud  # noqa: E402
from threecrate_tpu import TriangleMesh as JMesh  # noqa: E402
from threecrate_tpu import io as jio  # noqa: E402
from threecrate_tpu import native as jnative  # noqa: E402
from threecrate_tpu.io import lidar as jlidar  # noqa: E402
from threecrate_tpu.io import mesh_attributes as jma  # noqa: E402
from threecrate_tpu.io import mmap as jmmap  # noqa: E402
from threecrate_tpu.io import ply as jply  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import PointCloud as TCloud  # noqa: E402
from threecrate_tpu_torch import TriangleMesh as TMesh  # noqa: E402
from threecrate_tpu_torch import io as tio  # noqa: E402
from threecrate_tpu_torch import native as tnative  # noqa: E402
from threecrate_tpu_torch.io import lidar as tlidar  # noqa: E402
from threecrate_tpu_torch.io import mesh_attributes as tma  # noqa: E402
from threecrate_tpu_torch.io import mmap as tmmap  # noqa: E402
from threecrate_tpu_torch.io import ply as tply  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_PTS = 700


def _cloud_arrays(seed=0, n=N_PTS):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return {"points": pts, "normals": nrm,
            "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "intensity": rng.uniform(0, 255, n).astype(np.float32)}


def _uv_sphere(n_sub=10, noise=0.02, seed=0):
    rng = np.random.default_rng(seed)
    thetas = np.linspace(0.3, np.pi - 0.3, n_sub)
    phis = np.linspace(0, 2 * np.pi, 2 * n_sub, endpoint=False)
    m = len(phis)
    v = np.stack([np.outer(np.sin(thetas), np.cos(phis)).ravel(),
                  np.outer(np.sin(thetas), np.sin(phis)).ravel(),
                  np.repeat(np.cos(thetas), m)], -1)
    f = []
    for i in range(n_sub - 1):
        for j in range(m):
            a, b = i * m + j, i * m + (j + 1) % m
            c, d = (i + 1) * m + j, (i + 1) * m + (j + 1) % m
            f += [[a, b, c], [b, d, c]]
    v = v + noise * rng.normal(size=v.shape)
    return v.astype(np.float32), np.asarray(f, np.int32)


@pytest.fixture(scope="module")
def clouds():
    a = _cloud_arrays()
    attrs = {k: v for k, v in a.items() if k != "points"}
    return JCloud.from_numpy(a["points"], **attrs), \
        TCloud.from_numpy(a["points"], device="cpu", **attrs), a


@pytest.fixture(scope="module")
def meshes():
    v, f = _uv_sphere()
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    col = np.abs(n).astype(np.float32)
    return JMesh.from_numpy(v, f, normals=n, colors=col), \
        TMesh.from_numpy(v, f, normals=n, colors=col, device="cpu"), (v, f, n, col)


def _arrays(c):
    return {"points": np.asarray(c.to_numpy()),
            **{k: np.asarray(c.attr_to_numpy(k)) for k in c.attrs}}


def _mesh_arrays(m):
    v, f = m.to_numpy()
    return {"vertices": np.asarray(v), "faces": np.asarray(f),
            **{k: np.asarray(m.attr_to_numpy(k)) for k in m.attrs}}


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _raises_alike(jfn, tfn, same_message=True):
    """Both calls raise the same error type (by name), with the same
    message unless ``same_message`` is false."""
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(Exception) as te:
        tfn()
    assert type(te.value).__name__ == type(je.value).__name__, (te.value, je.value)
    if same_message:
        assert str(te.value) == str(je.value)
    return je.value, te.value


# ---------------------------------------------------------------------------
# every format in both directions
# ---------------------------------------------------------------------------

CLOUD_FORMATS = [("ply", {"binary": True}), ("ply", {"binary": False}),
                 ("pcd", {"binary": True}), ("pcd", {"binary": False}),
                 ("pcd", {"compressed": True}), ("xyz", {}), ("csv", {}), ("txt", {}),
                 ("bin", {}), ("obj", {})]
# formats that store the float32 arrays themselves: what is read is what was written
EXACT = {"ply": ("points", "normals", "intensity"), "pcd": ("points", "normals", "intensity"),
         "bin": ("points", "intensity")}


@pytest.mark.parametrize("ext,kw", CLOUD_FORMATS,
                         ids=[f"{e}-{'-'.join(map(str, k.items())) or 'default'}"
                              for e, k in CLOUD_FORMATS])
def test_cloud_files_match_jax_both_ways(clouds, tmp_path, ext, kw):
    """JAX writes and the port reads, the port writes and JAX reads: the
    files are byte-equal and every read gives JAX's arrays."""
    jc, tc, arrays = clouds
    jp, tp = tmp_path / f"jax.{ext}", tmp_path / f"port.{ext}"
    jio.write_point_cloud(jp, jc, **kw)
    tio.write_point_cloud(tp, tc, **kw)
    assert tp.read_bytes() == jp.read_bytes()
    ref = _arrays(jio.read_point_cloud(jp))
    for path in (jp, tp):
        got = tio.read_point_cloud(path, device="cpu")
        assert got.device.type == "cpu"
        _assert_same(_arrays(got), ref)
        _assert_same(_arrays(got), _arrays(jio.read_point_cloud(path)))
    if kw.get("binary", True) or kw.get("compressed"):
        for key in EXACT.get(ext, ()):
            np.testing.assert_array_equal(ref[key], arrays[key], err_msg=key)


MESH_FORMATS = [("ply", {"binary": True}), ("ply", {"binary": False}), ("obj", {}),
                ("stl", {"binary": True}), ("stl", {"binary": False})]


@pytest.mark.parametrize("ext,kw", MESH_FORMATS,
                         ids=[f"{e}-{'-'.join(map(str, k.items())) or 'default'}"
                              for e, k in MESH_FORMATS])
def test_mesh_files_match_jax_both_ways(meshes, tmp_path, ext, kw):
    jm, tm, (v, f, _, _) = meshes
    jp, tp = tmp_path / f"jax.{ext}", tmp_path / f"port.{ext}"
    jio.write_mesh(jp, jm, **kw)
    tio.write_mesh(tm, tp, **kw)                 # the reference argument order
    assert tp.read_bytes() == jp.read_bytes()
    ref = _mesh_arrays(jio.read_mesh(jp))
    for path in (jp, tp):
        got = tio.read_mesh(path, device="cpu")
        assert got.device.type == "cpu"
        _assert_same(_mesh_arrays(got), ref)
    if ext == "ply" and kw["binary"]:
        np.testing.assert_array_equal(ref["vertices"], v)
        np.testing.assert_array_equal(ref["faces"], f)


def test_write_accepts_both_argument_orders(clouds, meshes, tmp_path):
    _, tc, _ = clouds
    _, tm, _ = meshes
    tio.write_point_cloud(tmp_path / "a.ply", tc)
    tio.write_point_cloud(tc, tmp_path / "b.ply")
    tio.write_mesh(str(tmp_path / "a.obj"), tm)
    tio.write_mesh(tm, str(tmp_path / "b.obj"))
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()


def test_ply_write_options_match_jax(clouds, tmp_path):
    jc, tc, _ = clouds
    extra = {"quality": np.arange(N_PTS, dtype=np.float64),
             "label": (np.arange(N_PTS) % 7).astype(np.uint8)}
    for binary in (True, False):
        jp, tp = tmp_path / f"j{binary}.ply", tmp_path / f"t{binary}.ply"
        jply.write_point_cloud(jp, jc, jply.PlyWriteOptions(binary, ["a note"], extra))
        tply.write_point_cloud(tp, tc, tply.PlyWriteOptions(binary, ["a note"], extra))
        assert tp.read_bytes() == jp.read_bytes()
        jr, tr = jply.read_ply_raw(jp), tply.read_ply_raw(tp)
        for k in jr["vertex"]:
            np.testing.assert_array_equal(tr["vertex"][k], jr["vertex"][k])


# ---------------------------------------------------------------------------
# streaming readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,kw", [("ply", {"binary": True}), ("ply", {"binary": False}),
                                    ("xyz", {}), ("pcd", {"binary": True})])
def test_cloud_streams_match_jax(clouds, tmp_path, ext, kw):
    jc, _, _ = clouds
    p = tmp_path / f"s.{ext}"
    jio.write_point_cloud(p, jc, **kw)
    jchunks = list(jio.read_point_cloud_iter(p, chunk_size=128))
    tchunks = list(tio.read_point_cloud_iter(p, chunk_size=128))
    assert len(tchunks) == len(jchunks) > 1
    for a, b in zip(tchunks, jchunks):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ext,kw", [("ply", {"binary": True}), ("ply", {"binary": False}),
                                    ("obj", {}), ("stl", {})])
def test_mesh_streams_match_jax(meshes, tmp_path, ext, kw):
    jm, _, _ = meshes
    p = tmp_path / f"s.{ext}"
    jio.write_mesh(p, jm, **kw)
    jchunks = list(jio.read_mesh_iter(p, chunk_size=64))
    tchunks = list(tio.read_mesh_iter(p, chunk_size=64))
    assert len(tchunks) == len(jchunks) > 2
    for a, b in zip(tchunks, jchunks):
        assert type(a).__name__ == "MeshChunk"
        for field in ("vertices", "faces"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------

def _big_endian_ply(tmp_path, dtype, name):
    v = np.array([[1.5, -2, 3], [4, 5.25, -6], [7, 8, 9.125], [0, 1, 2]])
    header = (f"ply\nformat binary_big_endian 1.0\nelement vertex 4\n"
              f"property {name} x\nproperty {name} y\nproperty {name} z\n"
              f"element face 2\nproperty list uchar int vertex_indices\nend_header\n").encode()
    faces = b"".join(b"\x03" + np.asarray(t, ">i4").tobytes() for t in ([0, 1, 2], [0, 2, 3]))
    p = tmp_path / f"be_{name}.ply"
    p.write_bytes(header + v.astype(dtype).tobytes() + faces)
    return p


def _ragged_ply(tmp_path, binary):
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 1.5, 0], [2, 0, 0]],
                 np.float32)
    polys = [[0, 1, 2], [0, 2, 3, 4], [1, 5, 2, 3, 0]]
    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex 6\nproperty float x\nproperty float y\n"
              "property float z\nelement face 3\nproperty list uchar int vertex_indices\n"
              "property uchar flag\nend_header\n").encode()
    if binary:
        body = v.tobytes() + b"".join(
            bytes([len(q)]) + np.asarray(q, "<i4").tobytes() + b"\x07" for q in polys)
    else:
        body = ("\n".join(" ".join(f"{x:g}" for x in r) for r in v) + "\n"
                + "\n".join(f"{len(q)} " + " ".join(map(str, q)) + " 7" for q in polys)
                + "\n").encode()
    p = tmp_path / f"ragged_{binary}.ply"
    p.write_bytes(header + body)
    return p


def _ragged_only_ply(tmp_path):
    v = np.eye(3, dtype=np.float32).repeat(2, 0)
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 6\nproperty float x\n"
              b"property float y\nproperty float z\nelement face 2\n"
              b"property list uchar int vertex_indices\nend_header\n")
    body = v.tobytes() + b"\x03" + np.asarray([0, 1, 2], "<i4").tobytes() \
        + b"\x05" + np.asarray([1, 2, 3, 4, 5], "<i4").tobytes()
    p = tmp_path / "ragged_only.ply"
    p.write_bytes(header + body)
    return p


def _quad_ply(tmp_path):
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    header = ("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
              "property float z\nelement face 2\nproperty list uchar int vertex_index\n"
              "end_header\n").encode()
    body = b"0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n4 3 2 1 0\n"
    p = tmp_path / "quad.ply"
    p.write_bytes(header + body)
    return p


def _double_ply(tmp_path):
    p = tmp_path / "d.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\ncomment test\nelement vertex 2\n"
                  b"property double x\nproperty double y\nproperty double z\n"
                  b"property float quality\nproperty uchar red\nproperty uchar green\n"
                  b"property uchar blue\nend_header\n1.25 2 3 0.5 255 0 10\n"
                  b"4 5 6.0000001 0.7 1 2 3\n")
    return p


EDGE_FILES = {
    "big_endian_float": lambda t: _big_endian_ply(t, ">f4", "float"),
    "big_endian_double": lambda t: _big_endian_ply(t, ">f8", "double"),
    "ragged_binary": lambda t: _ragged_ply(t, True),
    "ragged_ascii": lambda t: _ragged_ply(t, False),
    "ragged_only": _ragged_only_ply,
    "quads": _quad_ply,
}


@pytest.mark.parametrize("name", sorted(EDGE_FILES))
def test_ply_edge_cases_match_jax(tmp_path, name):
    p = EDGE_FILES[name](tmp_path)
    _assert_same(_mesh_arrays(tio.read_mesh(p, device="cpu")), _mesh_arrays(jio.read_mesh(p)))
    _assert_same(_arrays(tio.read_point_cloud(p, device="cpu")),
                 _arrays(jio.read_point_cloud(p)))
    jr, tr = jply.read_ply_raw(p), tply.read_ply_raw(p)
    assert sorted(jr) == sorted(tr)
    for elem in jr:
        assert sorted(jr[elem]) == sorted(tr[elem])
        for k, a in jr[elem].items():
            b = tr[elem][k]
            if isinstance(a, list):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(y, x)
            else:
                np.testing.assert_array_equal(b, a)


def test_double_ply_with_extra_properties_matches_jax(tmp_path):
    p = _double_ply(tmp_path)
    _assert_same(_arrays(tio.read_point_cloud(p, device="cpu")),
                 _arrays(jio.read_point_cloud(p)))


def _truncated_binary_ply(t):
    p = t / "trunc.ply"
    p.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 100\n"
                  b"property float x\nproperty float y\nproperty float z\nend_header\n"
                  + b"\x00" * 10)
    return p


def _truncated_ascii_ply(t):
    p = t / "trunc_ascii.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                  b"property float y\nproperty float z\nend_header\n1 2 3\n4 5 6\n")
    return p


def _bad_token_count_ply(t):
    p = t / "tokens.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                  b"property float y\nproperty float z\nend_header\n1 2 3\n4 5\n")
    return p


def _write(name, data):
    def make(t):
        p = t / name
        p.write_bytes(data)
        return p
    return make


def _truncated_pcd(t):
    pts = np.zeros((50, 3), np.float32)
    p = t / "trunc.pcd"
    jio.write_point_cloud(p, JCloud.from_numpy(pts), compressed=True)
    p.write_bytes(p.read_bytes()[:-20])
    return p


def _corrupt_lzf_pcd(t):
    p = t / "lzf.pcd"
    jio.write_point_cloud(p, JCloud.from_numpy(np.ones((50, 3), np.float32)), compressed=True)
    data = bytearray(p.read_bytes())
    head = data.index(b"DATA binary_compressed\n") + len(b"DATA binary_compressed\n")
    data[head + 8:] = b"\xff" * (len(data) - head - 8)   # back references before the start
    p.write_bytes(bytes(data))
    return p


def _truncated_stl(t):
    p = t / "trunc.stl"
    p.write_bytes(b"x" * 80 + struct.pack("<I", 10) + b"\x00" * 100)
    return p


BAD_FILES = {
    "not_a_ply": (_write("bad.ply", b"not a ply at all"), "cloud"),
    "ply_truncated_binary": (_truncated_binary_ply, "cloud"),
    "ply_truncated_ascii": (_truncated_ascii_ply, "cloud"),
    "ply_token_count": (_bad_token_count_ply, "cloud"),
    "ply_unknown_type": (_write("type.ply", b"ply\nformat ascii 1.0\nelement vertex 1\n"
                                b"property quad x\nend_header\n1\n"), "cloud"),
    "ply_unknown_format": (_write("fmt.ply", b"ply\nformat binary_middle_endian 1.0\n"
                                  b"element vertex 0\nend_header\n"), "cloud"),
    "ply_no_vertex": (_write("nov.ply", b"ply\nformat ascii 1.0\nelement thing 1\n"
                             b"property float x\nend_header\n1\n"), "mesh"),
    "ply_missing_z": (_write("noz.ply", b"ply\nformat ascii 1.0\nelement vertex 1\n"
                             b"property float x\nproperty float y\nend_header\n1 2\n"), "cloud"),
    "pcd_truncated": (_truncated_pcd, "cloud"),
    "pcd_corrupt_lzf": (_corrupt_lzf_pcd, "cloud"),
    "pcd_malformed": (_write("bad.pcd", b"VERSION 0.7\nFIELDS x y z\n"), "cloud"),
    "pcd_ascii_truncated": (_write("short.pcd", b"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                                   b"POINTS 3\nDATA ascii\n1 2 3\n"), "cloud"),
    "kitti_not_quadruples": (_write("odd.bin", b"\x00" * 20), "cloud"),
    "stl_truncated": (_truncated_stl, "mesh"),
    "stl_too_small": (_write("small.stl", b"\x00" * 40), "mesh"),
    "stl_bad_ascii": (_write("bad_ascii.stl", b"solid x\nvertex 1 2\nendsolid\n"), "mesh"),
    "obj_no_vertices": (_write("empty.obj", b"# nothing\nf 1 2 3\n"), "mesh"),
    "obj_index_out_of_range": (_write("range.obj", b"v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9\n"),
                               "mesh"),
    "xyz_two_columns": (_write("two.xyz", b"1 2\n3 4\n"), "cloud"),
    "xyz_ragged": (_write("ragged.xyz", b"1 2 3\n4 5 6\n7 8 9\n10 11 12 13\n"), "cloud"),
    "xyz_empty": (_write("empty.xyz", b"\n\n"), "cloud"),
    "pcap_bad_magic": (_write("bad.pcap", b"\x00" * 40), "cloud"),
    "pcap_truncated_header": (_write("short.pcap", b"\xd4\xc3\xb2\xa1"), "cloud"),
    "pcap_no_packets": (_write("none.pcap", struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                                         65535, 1)), "cloud"),
    "lvx_bad_magic": (_write("bad.lvx", b"\x00" * 64), "cloud"),
    "lvx_truncated": (_write("short.lvx", b"livox_tech" + b"\x00" * 5), "cloud"),
    "lvx2_bad_magic": (_write("bad.lvx2", b"\x00" * 64), "cloud"),
    "lvx2_too_small": (_write("small.lvx2", b"\x00" * 10), "cloud"),
}


@pytest.mark.parametrize("name", sorted(BAD_FILES))
def test_bad_files_raise_like_jax(tmp_path, name):
    make, kind = BAD_FILES[name]
    p = make(tmp_path)
    if kind == "cloud":
        _raises_alike(lambda: jio.read_point_cloud(p),
                      lambda: tio.read_point_cloud(p, device="cpu"))
    else:
        _raises_alike(lambda: jio.read_mesh(p), lambda: tio.read_mesh(p, device="cpu"))


def test_ply_stream_truncation_raises_like_jax(clouds, tmp_path):
    jc, _, _ = clouds
    p = tmp_path / "s.ply"
    jio.write_point_cloud(p, jc)
    p.write_bytes(p.read_bytes()[:-40])
    _raises_alike(lambda: list(jio.read_point_cloud_iter(p, chunk_size=128)),
                  lambda: list(tio.read_point_cloud_iter(p, chunk_size=128)))


def test_non_triangle_mesh_stream_raises_like_jax(tmp_path):
    p = _ragged_only_ply(tmp_path)
    _raises_alike(lambda: list(jio.read_mesh_iter(p)), lambda: list(tio.read_mesh_iter(p)))


REGISTRY_ERRORS = {
    "read_unknown_extension": (lambda io, t: io.read_point_cloud(t / "a.foo"), False),
    "read_no_extension": (lambda io, t: io.read_point_cloud(t / "noext"), True),
    "read_missing_file": (lambda io, t: io.read_point_cloud(t / "missing.ply"), True),
    "read_mesh_missing_file": (lambda io, t: io.read_mesh(t / "missing.stl"), True),
    "write_unknown_extension": (lambda io, t: io.write_point_cloud(t / "a.foo", None), True),
    "write_no_cloud_writer": (lambda io, t: io.write_point_cloud(t / "a.pcap", None), True),
    "read_no_mesh_reader": (lambda io, t: io.read_mesh(t / "a.pcd"), True),
    "write_no_mesh_writer": (lambda io, t: io.write_mesh(t / "a.xyz", None), True),
    "iter_missing_file": (lambda io, t: io.read_point_cloud_iter(t / "missing.xyz"), True),
}


@pytest.mark.parametrize("name", sorted(REGISTRY_ERRORS))
def test_registry_errors_match_jax(tmp_path, name):
    """Unknown extensions and missing files raise JAX's types and
    messages; the unknown-reader message lists each package's own
    formats, so there only its first part is compared."""
    fn, same_message = REGISTRY_ERRORS[name]
    je, te = _raises_alike(lambda: fn(jio, tmp_path),
                           lambda: fn(tio, tmp_path), same_message)
    assert str(te).split(" (supported")[0] == str(je).split(" (supported")[0]


def test_supported_extensions_are_jax_s_ported_ones():
    later = set()   # every format of the JAX package is ported
    assert tio.supported_extensions() == sorted(set(jio.supported_extensions()) - later)
    assert tt.supported_extensions() == tio.supported_extensions()


READERS = ["ply.read_point_cloud", "ply.read_mesh", "pcd.read_point_cloud",
           "obj.read_point_cloud", "obj.read_mesh", "stl.read_mesh",
           "xyz_csv.read_point_cloud", "lidar.read_kitti_bin", "lidar.read_velodyne_pcap",
           "lidar.read_ouster_pcap", "lidar.read_livox_lvx", "lidar.read_livox_lvx2",
           "mesh_attributes.read_extended_mesh", "las.read_point_cloud", "e57.read_point_cloud",
           "rosbag.read_point_cloud", "rosbag.read_point_cloud_mcap",
           "compression.read_point_cloud", "compression.decompress_point_cloud",
           "compression.decompress_draco", "gltf.read_mesh_glb", "ros2.from_pointcloud2",
           "ros2.from_pointcloud2_organized", "artifacts.load_artifact"]


@pytest.mark.parametrize("name", READERS)
def test_readers_default_to_the_card(name):
    mod, fn = name.split(".")
    sig = inspect.signature(getattr(getattr(tio, mod), fn))
    assert sig.parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# LiDAR recordings
# ---------------------------------------------------------------------------

def _pcap(payloads, big_endian=False):
    e = ">" if big_endian else "<"
    out = [struct.pack(e + "IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)]
    for i, pl in enumerate(payloads):
        vlan = i % 3 == 1
        eth = b"\x00" * 12 + (struct.pack(">HH", 0x8100, 5) if vlan else b"") \
            + struct.pack(">H", 0x0800)
        ip = bytes([0x45, 0]) + struct.pack(">H", 28 + len(pl)) + b"\x00" * 4 \
            + bytes([64, 17]) + b"\x00" * 10
        pkt = eth + ip + struct.pack(">HHHH", 2368, 2368, 8 + len(pl), 0) + pl
        out.append(struct.pack(e + "IIII", i, 0, len(pkt), len(pkt)) + pkt)
    # a non-UDP and a short packet, both skipped
    arp = b"\x00" * 12 + struct.pack(">H", 0x0806) + b"\x00" * 40
    out.append(struct.pack(e + "IIII", 0, 0, len(arp), len(arp)) + arp)
    out.append(struct.pack(e + "IIII", 0, 0, 10, 10) + b"\x00" * 10)
    return b"".join(out)


def _velodyne_payloads(rng, n_pkts):
    out = []
    for _ in range(n_pkts):
        raw = rng.integers(0, 256, 1206, dtype=np.uint8)
        blocks = raw[:1200].reshape(12, 100)
        ok = rng.uniform(size=12) < 0.9
        blocks[:, 0] = np.where(ok, 0xFF, 0x12)
        blocks[:, 1] = np.where(ok, 0xEE, 0x34)
        az = rng.integers(0, 36000, 12)
        blocks[:, 2], blocks[:, 3] = az & 0xFF, az >> 8
        body = blocks[:, 4:].reshape(12, 32, 3)
        body[:, :, 1] %= 60                        # ranges up to ~30 m
        body[rng.uniform(size=(12, 32)) < 0.05, :2] = 0
        out.append(raw.tobytes())
    return out


@pytest.mark.parametrize("model", ["VLP-16", "HDL-32E"])
@pytest.mark.parametrize("big_endian", [False, True])
def test_velodyne_pcap_matches_jax(tmp_path, model, big_endian):
    rng = np.random.default_rng(3)
    p = tmp_path / "v.pcap"
    p.write_bytes(_pcap(_velodyne_payloads(rng, 6), big_endian))
    ref = jio.read_point_cloud(p, model=model)
    got = tio.read_point_cloud(p, model=model, device="cpu")
    assert len(got.to_numpy()) > 1000
    _assert_same(_arrays(got), _arrays(ref))
    _assert_same(_arrays(tlidar.read_velodyne_pcap(p, model, max_packets=2, device="cpu")),
                 _arrays(jlidar.read_velodyne_pcap(p, model, max_packets=2)))


def test_velodyne_numpy_packet_path_matches_native(tmp_path):
    """The per-packet NumPy decode (used without the native library)
    against the native batch decode, within float32 rounding: the two
    evaluate the angles in different precisions."""
    payloads = _velodyne_payloads(np.random.default_rng(4), 3)
    got = tlidar.read_velodyne_pcap(_pcap_file(tmp_path, payloads), device="cpu")
    pts = np.concatenate([tlidar.decode_velodyne_packet(pl, tlidar.VLP_16)[0]
                          for pl in payloads])
    np.testing.assert_allclose(got.to_numpy(), pts, atol=1e-4)


def _pcap_file(tmp_path, payloads):
    p = tmp_path / "x.pcap"
    p.write_bytes(_pcap(payloads))
    return p


def test_velodyne_unknown_model_raises_like_jax(tmp_path):
    p = _pcap_file(tmp_path, _velodyne_payloads(np.random.default_rng(5), 1))
    _raises_alike(lambda: jlidar.read_velodyne_pcap(p, "VLP-64"),
                  lambda: tlidar.read_velodyne_pcap(p, "VLP-64", device="cpu"))


@pytest.mark.parametrize("profile", ["OS1-64", "OS-128"])
def test_ouster_pcap_matches_jax(tmp_path, profile):
    rng = np.random.default_rng(6)
    n_ch = tlidar.OUSTER_PROFILES[profile].n_channels
    col = 16 + 12 * n_ch + 4
    payloads = []
    for _ in range(4):
        raw = rng.integers(0, 256, (16, col), dtype=np.uint8)
        ch = raw[:, 16:16 + 12 * n_ch].reshape(16, n_ch, 12)
        ch[:, :, 2] &= 0x0F                        # ranges below ~1 km
        ch[rng.uniform(size=(16, n_ch)) < 0.1, :3] = 0
        payloads.append(raw.tobytes())
    p = _pcap_file(tmp_path, payloads)
    ref = jlidar.read_ouster_pcap(p, profile)
    got = tlidar.read_ouster_pcap(p, profile, device="cpu")
    assert len(got.to_numpy()) > 1000
    _assert_same(_arrays(got), _arrays(ref))
    _raises_alike(lambda: jlidar.read_ouster_pcap(p, "OS2"),
                  lambda: tlidar.read_ouster_pcap(p, "OS2", device="cpu"))


def _lvx(rng, frames):
    """LVX v1.1: public header (24 bytes), private header (5), one device
    block (59), then frames of packages of data type 0 or 2."""
    out = bytearray(b"livox_tech".ljust(24, b"\x00") + struct.pack("<IB", 50, 1)
                    + b"\x00" * 59)
    for i, types in enumerate(frames):
        body = bytearray()
        for dt in types:
            n, sz = (100, 13) if dt == 0 else (96, 14)
            raw = rng.integers(0, 256, (n, sz), dtype=np.uint8)
            xyz = rng.integers(-30000, 30000, (n, 3)).astype("<i4")
            xyz[rng.uniform(size=n) < 0.05] = 0
            raw[:, :12] = xyz.view(np.uint8).reshape(n, 12)
            body += bytes([0, 1, 0, 0, 0]) + b"\x00" * 4 + bytes([0, dt]) + b"\x00" * 8
            body += raw.tobytes()
        start = len(out)
        out += struct.pack("<QQQ", start, start + 24 + len(body), i) + body
    out += struct.pack("<QQQ", len(out), 0, 99)       # a last header that ends the walk
    return bytes(out)


def _lvx2(rng, frames):
    out = bytearray(struct.pack("<I", 0x20200903) + b"\x02\x00\x00\x00"
                    + struct.pack("<IQI", 28, 0, 50) + bytes([1, 1]) + b"\x00" * 2)
    out += b"SN".ljust(16, b"\x00") + b"\x00" * 25
    start = len(out)
    rel = 0
    for i, types in enumerate(frames):
        body = bytearray()
        for dt in types:
            sz = {0: 8, 1: 14, 2: 10}[dt]
            n = int(rng.integers(20, 60))
            raw = rng.integers(0, 256, (n, sz), dtype=np.uint8)
            body += struct.pack("<BBIBI", 0, 8, n, dt, n * sz) + raw.tobytes()
        length = 24 + len(body)
        nxt = 0 if i == len(frames) - 1 else rel + length
        out += struct.pack("<QQQ", rel, nxt, i) + body
        rel += length
    assert len(out) > start
    return bytes(out)


@pytest.mark.parametrize("ext", ["lvx", "lvx2"])
def test_livox_matches_jax(tmp_path, ext):
    rng = np.random.default_rng(7)
    make = _lvx if ext == "lvx" else _lvx2
    frames = [[0, 2], [2], [0, 0]] if ext == "lvx" else [[0, 1], [2, 1], [0, 2, 1]]
    p = tmp_path / f"r.{ext}"
    p.write_bytes(make(rng, frames))
    got = tio.read_point_cloud(p, device="cpu")
    assert len(got.to_numpy()) > 100
    _assert_same(_arrays(got), _arrays(jio.read_point_cloud(p)))
    fn = "read_livox_lvx" if ext == "lvx" else "read_livox_lvx2"
    _assert_same(_arrays(getattr(tlidar, fn)(p, max_frames=1, device="cpu")),
                 _arrays(getattr(jlidar, fn)(p, max_frames=1)))


def test_kitti_raw_table_matches_jax(clouds, tmp_path):
    jc, _, arrays = clouds
    p = tmp_path / "k.bin"
    jio.write_point_cloud(p, jc)
    table = tlidar.read_kitti_bin_raw(p)
    np.testing.assert_array_equal(table, jlidar.read_kitti_bin_raw(p))
    np.testing.assert_array_equal(table[:, :3], arrays["points"])
    np.testing.assert_array_equal(table[:, 3], arrays["intensity"])


# ---------------------------------------------------------------------------
# the native helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["{:.8g}", "{:.9g}", "{:.17g}", "{:.6e}", "{:.3f}", "{:d}"])
def test_native_parser_matches_numpy(fmt):
    rng = np.random.default_rng(8)
    if fmt == "{:d}":
        vals = rng.integers(-10 ** 6, 10 ** 6, 5000).astype(np.float64)
        text = " ".join(fmt.format(int(v)) for v in vals)
    else:
        vals = rng.uniform(-500, 500, 5000).astype(np.float32).astype(np.float64)
        text = "".join(fmt.format(v) + "\t,;\n "[i % 5] for i, v in enumerate(vals))
    tnative.reset_counts()
    got = tnative.parse_floats(text)
    assert tnative.counts["native"] == 1 and tnative.counts["numpy"] == 0
    ref = np.array(text.replace(",", " ").replace(";", " ").split(), np.float64)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= 2 * np.spacing(np.abs(ref))).all()
    np.testing.assert_array_equal(got.astype(np.float32), ref.astype(np.float32))
    np.testing.assert_array_equal(got, jnative.parse_floats(text))


def test_native_parser_special_tokens_match_jax():
    """strtod takes nan and inf in the native parser; a token it cannot
    read sends the whole text to NumPy, which raises as JAX's does."""
    tnative.reset_counts()
    got = tnative.parse_floats("1 nan inf -2 .5 -.25 1e3")
    np.testing.assert_array_equal(got, [1, np.nan, np.inf, -2, 0.5, -0.25, 1000])
    assert tnative.counts["native"] == 1
    _raises_alike(lambda: jnative.parse_floats("1 x2 3"),
                  lambda: tnative.parse_floats("1 x2 3"))
    assert tnative.counts["numpy"] == 1


def test_lzf_codec_round_trips_and_matches_jax():
    rng = np.random.default_rng(9)
    data = (np.repeat(rng.integers(0, 40, 3000), rng.integers(1, 9, 3000))
            .astype(np.uint8).tobytes() + rng.integers(0, 256, 5000, np.uint8).tobytes()
            + b"\x00" * 3000)
    comp = tnative.lzf_compress(data)
    assert len(comp) < len(data) and comp == jnative.lzf_compress(data)
    assert tnative.lzf_decompress(comp, len(data)) == data
    # the stream is valid for the pure-Python decoder too, and JAX's
    assert jnative.lzf_decompress(comp, len(data)) == data
    for bad in (b"\x20\x05", b"\x05ab", comp[:-1] + b"\xff\xff"):
        _raises_alike(lambda: jnative.lzf_decompress(bad, len(data)),
                      lambda: tnative.lzf_decompress(bad, len(data)))
    _raises_alike(lambda: jnative.lzf_decompress(comp, 10),
                  lambda: tnative.lzf_decompress(comp, 10))


def test_without_a_compiler_the_numpy_fallbacks_run(monkeypatch):
    """With no library every helper falls back, as the JAX package's do:
    NumPy parsing, the all-literal LZF stream and its Python decoder."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    tnative.reset_counts()
    np.testing.assert_array_equal(tnative.parse_floats("1 2.5 -3e2"), [1, 2.5, -300])
    assert tnative.counts["numpy"] == 1 and tnative.counts["native"] == 0
    data = bytes(range(256)) * 3
    comp = tnative.lzf_compress(data)
    assert len(comp) == len(data) + len(data) // 32
    assert tnative.lzf_decompress(comp, len(data)) == data
    assert tnative.lzf_decompress(jnative.lzf_compress(data), len(data)) == data
    assert tnative.decode_velodyne_batch(np.zeros((1, 1206), np.uint8), 0.002) is None


def test_velodyne_batch_decode_matches_jax():
    pk = np.frombuffer(b"".join(_velodyne_payloads(np.random.default_rng(10), 4)),
                       np.uint8).reshape(4, 1206)
    for a, b in zip(tnative.decode_velodyne_batch(pk, 0.002),
                    jnative.decode_velodyne_batch(pk, 0.002)):
        np.testing.assert_array_equal(a, b)


def test_native_build_lands_in_the_port():
    """The library builds under the port's own ``native/build`` with a
    hash of the source and flags in its name, never beside the JAX
    package's source."""
    assert tnative.available()
    so = tnative.library_path()
    assert so.exists()
    assert so.parent == ROOT / "threecrate_tpu_torch" / "native" / "build"
    assert so.name.startswith("libtc_native_") and len(so.stem) == len("libtc_native_") + 16
    assert not list((ROOT / "threecrate_tpu" / "native").glob("libtc_native_*"))
    assert (tnative.SRC.read_bytes() == (ROOT / "threecrate_tpu" / "native"
                                         / "tc_native.cpp").read_bytes())


def test_concurrent_builds_leave_one_library(tmp_path):
    """Six processes build into one empty directory at once (as six test
    workers may): each loads a whole library and one file remains."""
    code = ("import sys\nfrom pathlib import Path\n"
            "from threecrate_tpu_torch import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "assert native.available()\n"
            "assert list(native.parse_floats('1 2 3')) == [1, 2, 3]\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(6)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    assert [f.name for f in tmp_path.iterdir()] == [tnative.library_path().name]


# ---------------------------------------------------------------------------
# extended meshes and the memory map
# ---------------------------------------------------------------------------

def _extended(pkg, mesh, uvs, tangents, custom, metadata):
    return pkg.ExtendedTriangleMesh(mesh, uvs, tangents, custom, metadata)


def test_extended_mesh_files_match_jax_both_ways(meshes, tmp_path):
    jm, tm, (v, f, _, _) = meshes
    rng = np.random.default_rng(11)
    uvs = rng.uniform(0, 1, (len(v), 2)).astype(np.float32)
    tan = rng.normal(size=(len(v), 3)).astype(np.float32)
    custom = {"weight": rng.uniform(size=len(v)).astype(np.float32),
              "rgb": rng.integers(0, 255, (len(v), 3)).astype(np.uint8)}
    meta = {"author": "seed 11", "units": "m"}
    jp, tp = tmp_path / "j.ply", tmp_path / "t.ply"
    jma.write_extended_mesh(jp, _extended(jma, jm, uvs, tan, custom, meta))
    tma.write_extended_mesh(tp, _extended(tma, tm, uvs, tan, custom, meta))
    assert tp.read_bytes() == jp.read_bytes()
    for path in (jp, tp):
        j, t = jma.read_extended_mesh(path), tma.read_extended_mesh(path, device="cpu")
        _assert_same(_mesh_arrays(t.mesh), _mesh_arrays(j.mesh))
        np.testing.assert_array_equal(t.uvs, j.uvs)
        np.testing.assert_array_equal(t.tangents, j.tangents)
        assert sorted(t.custom) == sorted(j.custom) == ["rgb", "weight"]
        for k in j.custom:
            np.testing.assert_array_equal(t.custom[k], j.custom[k])
        assert t.metadata == j.metadata == meta


def test_extended_mesh_validation_and_tangents_match_jax(meshes):
    jm, tm, (v, f, _, _) = meshes
    uvs = np.random.default_rng(12).uniform(0, 1, (len(v), 2)).astype(np.float32)
    _raises_alike(lambda: jma.ExtendedTriangleMesh(jm, uvs[:5]).validate(),
                  lambda: tma.ExtendedTriangleMesh(tm, uvs[:5]).validate())
    for u in (uvs, None):
        j = jma.ExtendedTriangleMesh(jm, u).recompute_tangents().tangents
        t = tma.ExtendedTriangleMesh(tm, u).recompute_tangents().tangents
        np.testing.assert_array_equal(t, j)
    jn = jma.ExtendedTriangleMesh(jm).recompute_normals().mesh.attr_to_numpy("normals")
    tn = tma.ExtendedTriangleMesh(tm).recompute_normals().mesh.attr_to_numpy("normals")
    np.testing.assert_allclose(tn, np.asarray(jn), atol=1e-6)


def test_mmap_reader_matches_jax(tmp_path):
    big, small = tmp_path / "big.bin", tmp_path / "small.bin"
    data = np.arange(40_000, dtype=np.float32)
    big.write_bytes(data.tobytes())
    small.write_bytes(b"tiny")
    for path, mapped in ((big, True), (small, False)):
        with tmmap.MmapReader(path) as t, jmmap.MmapReader(path) as j:
            assert t.is_mapped == j.is_mapped == mapped
            assert t.size == j.size
            assert bytes(t.data()) == bytes(j.data())
        if mapped:
            t = tmmap.MmapReader(path)
            np.testing.assert_array_equal(t.frombuffer(np.float32, 100, 400), data[100:200])
            t.close()
    assert tmmap.MMAP_THRESHOLD == jmmap.MMAP_THRESHOLD
    _raises_alike(lambda: jmmap.MmapReader(tmp_path / "none"),
                  lambda: tmmap.MmapReader(tmp_path / "none"), same_message=False)
