"""The survey-tile formats: the PyTorch port (``threecrate_tpu_torch.io``
las, e57, ros2, rosbag, gltf, compression and artifacts, and the LASzip
half of ``.native``) against the JAX package on the same files, on the
CPU.

Stated tolerances: none. The readers, writers and codecs are copies of
the JAX package's host code (the LASzip source byte-equal), so every
file either package writes is byte-equal to the other's for the same
cloud or mesh, every array read is bit-equal to JAX's read of the same
file, whichever package wrote it, and every refusal raises the same
error type (by name) with the same message. ``.npz`` artifacts hold
zip timestamps, so there the arrays are compared, not the bytes. Inputs
come from numpy seeds, at most 16k points; the rosbag2 and MCAP files
come from the JAX package's own fixture builders
(``tests/test_io_extra.py``).
"""

import ctypes
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_io_extra as jfix  # noqa: E402  (the JAX tests' fixture builders)

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu import native as jnative  # noqa: E402
from threecrate_tpu.core.organized import OrganizedPointCloud as JOrganized  # noqa: E402
from threecrate_tpu.io import artifacts as jart  # noqa: E402
from threecrate_tpu.io import compression as jcomp  # noqa: E402
from threecrate_tpu.io import e57 as je57  # noqa: E402
from threecrate_tpu.io import gltf as jgltf  # noqa: E402
from threecrate_tpu.io import las as jlas  # noqa: E402
from threecrate_tpu.io import ros2 as jros2  # noqa: E402
from threecrate_tpu.io import rosbag as jbag  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import native as tnative  # noqa: E402
from threecrate_tpu_torch.core.organized import OrganizedPointCloud as TOrganized  # noqa: E402
from threecrate_tpu_torch.io import artifacts as tart  # noqa: E402
from threecrate_tpu_torch.io import compression as tcomp  # noqa: E402
from threecrate_tpu_torch.io import e57 as te57  # noqa: E402
from threecrate_tpu_torch.io import gltf as tgltf  # noqa: E402
from threecrate_tpu_torch.io import las as tlas  # noqa: E402
from threecrate_tpu_torch.io import ros2 as tros2  # noqa: E402
from threecrate_tpu_torch.io import rosbag as tbag  # noqa: E402
from threecrate_tpu_torch.ops import tsdf as ttsdf  # noqa: E402

CPU = {"device": "cpu"}


def _arrays(c):
    return {"points": np.asarray(c.to_numpy()),
            **{k: np.asarray(c.attr_to_numpy(k)) for k in c.attrs}}


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _raises_alike(jfn, tfn):
    """Both calls raise the same error type (by name) with the same
    message."""
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(Exception) as te:
        tfn()
    assert type(te.value).__name__ == type(je.value).__name__, (te.value, je.value)
    assert str(te.value) == str(je.value)
    return str(te.value)


def _clouds(n=3000, seed=0, gps=True, walk=True):
    """The same cloud in both packages: a random walk (LAZ compresses it)
    with intensity, colours and, with ``gps``, a rising GPS time."""
    rng = np.random.default_rng(seed)
    pts = (np.cumsum(rng.normal(0, 0.05, (n, 3)), 0) if walk
           else rng.uniform(-50, 50, (n, 3))).astype(np.float32)
    attrs = {"intensity": rng.uniform(0, 1, n).astype(np.float32),
             "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    if gps:
        attrs["gps_time"] = 3.0e5 + np.cumsum(rng.uniform(1e-6, 2e-4, n))
    return tc.PointCloud.from_numpy(pts, **attrs), tt.PointCloud.from_numpy(pts, **CPU, **attrs)


def _cross(tmp_path, ext, jwrite, twrite, jread, tread):
    """Write with both packages, assert the files byte-equal, then read
    each package's file with the other package: arrays bit-equal."""
    jp, tp = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    jwrite(jp)
    twrite(tp)
    assert jp.read_bytes() == tp.read_bytes()
    ref = _arrays(jread(tp))
    _assert_same(_arrays(tread(jp)), ref)
    return ref


# ---------------------------------------------------------------------------
# LAS / LAZ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,ext", [(2, "las"), (3, "las"), (6, "las"), (7, "las"),
                                     (2, "laz"), (3, "laz")])
def test_las_writer_files_match_jax_both_ways(tmp_path, fmt, ext):
    jc, tcl = _clouds(seed=fmt, n=12_000 if ext == "laz" else 3000)
    ref = _cross(tmp_path, ext,
                 lambda p: jlas.write_point_cloud(p, jc, point_format=fmt),
                 lambda p: tlas.write_point_cloud(p, tcl, point_format=fmt),
                 jlas.read_point_cloud, lambda p: tlas.read_point_cloud(p, **CPU))
    want = {"points", "intensity"} | ({"colors"} if fmt != 6 else set()) \
        | ({"gps_time"} if fmt != 2 else set())
    assert sorted(ref) == sorted(want)


def test_las_registry_and_defaults_match_jax(tmp_path):
    """``.laz`` paths compress by default; a cloud without GPS time
    writes format 2, with it format 3; through the registry too."""
    jc, tcl = _clouds(n=2000, gps=False)
    for ext in ("las", "laz"):
        _cross(tmp_path, ext, lambda p: tc.write_point_cloud(p, jc),
               lambda p: tt.write_point_cloud(p, tcl), tc.read_point_cloud,
               lambda p: tt.read_point_cloud(p, **CPU))
        assert (tmp_path / f"t.{ext}").read_bytes()[104] & 0x3F == 2
    assert (tmp_path / "t.laz").stat().st_size < (tmp_path / "t.las").stat().st_size


_RECORD_LEN = {0: 20, 1: 28, 2: 26, 3: 34}
_ITEMS = {0: [(6, 20, 2)], 1: [(6, 20, 2), (7, 8, 2)], 2: [(6, 20, 2), (8, 6, 2)],
          3: [(6, 20, 2), (7, 8, 2), (8, 6, 2)]}


def _records(fmt, n, seed):
    """Random point records of a LAS 1.2 format: every byte random but
    the GPS time, a real double (NaN bits would not compare)."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (n, _RECORD_LEN[fmt]), dtype=np.uint8)
    if fmt in (1, 3):
        gps = rng.uniform(0, 1e6, n).astype("<f8")
        rec[:, 20:28] = gps.view(np.uint8).reshape(n, 8)
    return rec


def _laszip_vlr(compressor, chunk, items):
    payload = struct.pack("<HHBBHII", compressor, 0, 2, 2, 0, 0, chunk)
    payload += struct.pack("<qq", -1, -1) + struct.pack("<H", len(items))
    for it in items:
        payload += struct.pack("<HHH", *it)
    return struct.pack("<H16sHH32s", 0, b"laszip encoded\x00\x00", 22204, len(payload),
                       b"test") + payload


def _las_bytes(native, rec, fmt, compressor=None, chunk=1000, items=None,
               rec_len=None, scale=1e-3, offset=(10.0, -20.0, 3.0)):
    """A LAS 1.2 file of raw records: uncompressed, or LASzip-compressed
    by ``native`` (compressor 1: one chunk of every point)."""
    n = len(rec)
    header_size = 227
    vlr = b""
    if compressor is not None:
        if compressor == 1:
            chunk = n
        vlr = _laszip_vlr(compressor, chunk, items or _ITEMS.get(fmt, _ITEMS[0]))
        body = native.laz_compress(rec, fmt, chunk, header_size + len(vlr))
    else:
        body = rec.tobytes()
    hdr = bytearray(header_size)
    hdr[0:4] = b"LASF"
    hdr[24], hdr[25] = 1, 2
    struct.pack_into("<H", hdr, 94, header_size)
    struct.pack_into("<I", hdr, 96, header_size + len(vlr))
    struct.pack_into("<I", hdr, 100, 1 if vlr else 0)
    hdr[104] = fmt | (0x80 if compressor is not None else 0)
    struct.pack_into("<H", hdr, 105, rec_len or rec.shape[1])
    struct.pack_into("<I", hdr, 107, n)
    struct.pack_into("<6d", hdr, 131, scale, scale, scale, *offset)
    return bytes(hdr) + vlr + body


@pytest.mark.parametrize("compressor", [None, 1, 2])
@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_las_point_formats_0_3_match_jax(tmp_path, fmt, compressor):
    """Hand-built files of every LAS 1.2 format, plain and LASzip
    compressed (compressor 1 and chunked 2), made by each package's
    codec: byte-equal, and read by both to bit-equal arrays."""
    rec = _records(fmt, 2500, seed=10 * fmt + (compressor or 0))
    blobs = [_las_bytes(nat, rec, fmt, compressor) for nat in (jnative, tnative)]
    assert blobs[0] == blobs[1]
    p = tmp_path / f"f{fmt}.{'las' if compressor is None else 'laz'}"
    p.write_bytes(blobs[1])
    ref = _arrays(jlas.read_point_cloud(p))
    _assert_same(_arrays(tlas.read_point_cloud(p, **CPU)), ref)
    if compressor is not None:
        plain = tmp_path / "plain.las"
        plain.write_bytes(_las_bytes(tnative, rec, fmt))
        _assert_same(_arrays(tlas.read_point_cloud(plain, **CPU)), ref)


@pytest.mark.parametrize("fmt,rec_len", [(8, 38), (9, 59), (10, 67)])
def test_las14_formats_8_9_10_read_like_jax(tmp_path, fmt, rec_len):
    """LAS 1.4 records of the wave and NIR formats, which no writer
    emits: every byte random but the GPS time."""
    n = 500
    rng = np.random.default_rng(fmt)
    rec = rng.integers(0, 256, (n, rec_len), dtype=np.uint8)
    rec[:, 22:30] = rng.uniform(0, 1e6, n).astype("<f8").view(np.uint8).reshape(n, 8)
    hdr = bytearray(375)
    hdr[0:4] = b"LASF"
    hdr[24], hdr[25] = 1, 4
    struct.pack_into("<H", hdr, 94, 375)
    struct.pack_into("<I", hdr, 96, 375)
    hdr[104] = fmt
    struct.pack_into("<H", hdr, 105, rec_len)
    struct.pack_into("<6d", hdr, 131, 1e-2, 1e-2, 1e-2, 1.0, 2.0, 3.0)
    struct.pack_into("<Q", hdr, 247, n)
    p = tmp_path / f"f{fmt}.las"
    p.write_bytes(bytes(hdr) + rec.tobytes())
    ref = _arrays(jlas.read_point_cloud(p))
    assert ("nir" in ref) == (fmt != 9)
    _assert_same(_arrays(tlas.read_point_cloud(p, **CPU)), ref)


def _refusal_files(native):
    """Files that each refusal of the LAS reader catches; the LAZ ones
    stop before their point block, so theirs is filler."""
    rec2 = _records(2, 300, seed=1)
    plain = _las_bytes(native, rec2, 2)

    def laz(fmt, rec_len, vlr, body=b"\x00" * 64):
        hdr = bytearray(plain[:227])
        hdr[104] = fmt | 0x80
        struct.pack_into("<H", hdr, 105, rec_len)
        struct.pack_into("<I", hdr, 96, 227 + len(vlr))
        struct.pack_into("<I", hdr, 100, 1 if vlr else 0)
        return bytes(hdr) + vlr + body

    return {
        "compressor_3": laz(2, 26, _laszip_vlr(3, 1000, _ITEMS[2])),
        "compressed_format_6": laz(6, 30, _laszip_vlr(2, 1000, _ITEMS[0])),
        "extra_bytes": laz(2, 30, _laszip_vlr(2, 1000, _ITEMS[2])),
        "item_type": laz(2, 26, _laszip_vlr(2, 1000, [(6, 20, 2), (10, 3, 2)])),
        "item_version": laz(2, 26, _laszip_vlr(2, 1000, [(6, 20, 1), (8, 6, 2)])),
        "no_laszip_vlr": laz(2, 26, b"", rec2.tobytes()),
        "vlr_truncated": laz(2, 26, struct.pack("<H16sHH32s", 0, b"laszip encoded\x00\x00",
                                                22204, 10, b"x") + b"\x00" * 10),
        "point_format_5": plain[:104] + b"\x05" + plain[105:],
        "record_too_short": plain[:105] + struct.pack("<H", 20) + plain[107:],
        "bad_magic": b"NOPE" + plain[4:],
    }


@pytest.mark.parametrize("case", sorted(_refusal_files(tnative)))
def test_las_refusals_match_jax(tmp_path, case):
    p = tmp_path / "x.laz"
    p.write_bytes(_refusal_files(tnative)[case])
    _raises_alike(lambda: jlas.read_point_cloud(p), lambda: tlas.read_point_cloud(p, **CPU))


def test_laz_corrupt_chunk_table_raises_like_jax(tmp_path):
    jc, tcl = _clouds(n=1000)
    p = tmp_path / "c.laz"
    tlas.write_point_cloud(p, tcl)
    blob = bytearray(p.read_bytes())
    off = int.from_bytes(blob[96:100], "little")
    blob[off:off + 8] = (2 ** 62).to_bytes(8, "little")
    p.write_bytes(bytes(blob))
    msg = _raises_alike(lambda: jlas.read_point_cloud(p), lambda: tlas.read_point_cloud(p, **CPU))
    assert msg.startswith("LASzip decode failed")


@pytest.mark.parametrize("kw", [{"point_format": 6, "compress": True},
                                {"point_format": 7, "compress": True},
                                {"point_format": 1}, {"point_format": 0, "compress": True},
                                {"point_format": 8}])
def test_las_writer_refusals_match_jax(tmp_path, kw):
    jc, tcl = _clouds(n=100)
    _raises_alike(lambda: jlas.write_point_cloud(tmp_path / "j.las", jc, **kw),
                  lambda: tlas.write_point_cloud(tmp_path / "t.las", tcl, **kw))


def test_las_writer_rejects_int32_overflow_like_jax(tmp_path):
    pts = np.array([[0, 0, 0], [5.0e6, 0, 0]], np.float32)
    jc, tcl = tc.PointCloud.from_numpy(pts), tt.PointCloud.from_numpy(pts, **CPU)
    for fmt in (None, 6):
        msg = _raises_alike(
            lambda: jlas.write_point_cloud(tmp_path / "j.las", jc, scale=1e-3, point_format=fmt),
            lambda: tlas.write_point_cloud(tmp_path / "t.las", tcl, scale=1e-3, point_format=fmt))
        assert "int32" in msg
    _cross(tmp_path, "las", lambda p: jlas.write_point_cloud(p, jc, scale=10.0),
           lambda p: tlas.write_point_cloud(p, tcl, scale=10.0), jlas.read_point_cloud,
           lambda p: tlas.read_point_cloud(p, **CPU))


def test_laz_without_the_codec_raises_like_jax(tmp_path, monkeypatch):
    """No compiler: LAZ reads and writes refuse as the JAX package's do
    (a host codec, not a device fallback)."""
    jc, tcl = _clouds(n=500)
    p = tmp_path / "a.laz"
    tlas.write_point_cloud(p, tcl)
    monkeypatch.setattr(jnative, "_load_laz", lambda: None)
    monkeypatch.setattr(tnative, "_load_laz", lambda: None)
    assert tnative.laz_decompress(b"", 0, 0, 1, 0, 20) is None
    _raises_alike(lambda: jlas.read_point_cloud(p), lambda: tlas.read_point_cloud(p, **CPU))
    _raises_alike(lambda: jlas.write_point_cloud(tmp_path / "j.laz", jc),
                  lambda: tlas.write_point_cloud(tmp_path / "t.laz", tcl))


class TestLaszipAdversarial:
    """Bit-exactness of the port's LASzip library under hostile records,
    at the ctypes layer, and its block byte-equal to the JAX package's
    (tests/test_io_extra.py's cases)."""

    def _roundtrip(self, rec, fmt, rec_len, chunk=1000):
        blocks = []
        for lib in (tnative._load_laz(), jnative._load_laz()):
            u8p = ctypes.POINTER(ctypes.c_uint8)
            n = len(rec)
            flat = np.ascontiguousarray(rec.reshape(-1))
            out = np.zeros(n * rec_len * 3 + (1 << 16), np.uint8)
            blen = lib.tc_laz_compress(flat.ctypes.data_as(u8p), n, rec_len, fmt, chunk, 500,
                                       out.ctypes.data_as(u8p), len(out))
            assert blen > 0
            fb = np.zeros(500 + blen, np.uint8)
            fb[500:500 + blen] = out[:blen]
            dec = np.zeros(n * rec_len, np.uint8)
            r = lib.tc_laz_decompress(fb.ctypes.data_as(u8p), len(fb), 500, n, chunk, fmt,
                                      dec.ctypes.data_as(u8p), rec_len)
            assert r == 0
            np.testing.assert_array_equal(dec, flat)
            blocks.append(out[:blen].tobytes())
        assert blocks[0] == blocks[1]

    def test_extreme_values(self):
        rng = np.random.default_rng(3)
        n = 3333
        rec = np.zeros((n, 34), np.uint8)
        xyz = rng.integers(-2**31, 2**31, (n, 3), dtype=np.int64).astype("<i4")
        rec[:, :12] = xyz.view(np.uint8).reshape(n, 12)
        rec[:, 12:20] = rng.integers(0, 256, (n, 8), dtype=np.uint8)
        gps = rng.choice([0.0, 1e308, -1e-300, 3.14, np.inf, -np.inf], n).astype("<f8")
        rec[:, 20:28] = gps.view(np.uint8).reshape(n, 8)
        rec[:, 28:34] = rng.integers(0, 256, (n, 6), dtype=np.uint8)
        self._roundtrip(rec, 3, 34)

    def test_constant_points_and_nan_gps(self):
        rng = np.random.default_rng(4)
        n = 2000
        rec = np.zeros((n, 34), np.uint8)
        rec[:] = rng.integers(0, 256, (1, 34), dtype=np.uint8)
        self._roundtrip(rec, 3, 34)
        rec[:, 20:28] = np.full(n, np.nan, "<f8").view(np.uint8).reshape(n, 8)
        self._roundtrip(rec, 3, 34)

    def test_chunk_size_one(self):
        rec = np.random.default_rng(5).integers(0, 256, (129, 20), dtype=np.uint8)
        self._roundtrip(rec, 0, 20, chunk=1)


def test_laz_library_lands_in_the_port():
    """The LASzip library builds beside tc_native under the port's own
    ``native/build`` with a hash of its source and flags in its name;
    its source is the JAX package's, byte for byte."""
    assert tnative.laz_available()
    so = tnative.laz_library_path()
    assert so.exists() and so.parent == tnative.BUILD_DIR
    assert so.name.startswith("libtc_laz_") and len(so.stem) == len("libtc_laz_") + 16
    assert so != tnative.library_path()
    assert tnative.LAZ_SRC.read_bytes() == (
        tnative.LAZ_SRC.parents[2] / "threecrate_tpu" / "native" / "tc_laz.cpp").read_bytes()


# ---------------------------------------------------------------------------
# E57
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("intensity", [False, True])
def test_e57_files_match_jax_both_ways(tmp_path, spherical, intensity):
    rng = np.random.default_rng(57 + spherical)
    n = 4000
    pts = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    attrs = {"intensity": rng.uniform(0, 1, n).astype(np.float32)} if intensity else {}
    jc, tcl = tc.PointCloud.from_numpy(pts, **attrs), tt.PointCloud.from_numpy(pts, **CPU, **attrs)
    ref = _cross(tmp_path, "e57", lambda p: je57.write_point_cloud(p, jc, spherical=spherical),
                 lambda p: te57.write_point_cloud(p, tcl, spherical=spherical),
                 je57.read_point_cloud, lambda p: tt.read_point_cloud(p, **CPU))
    assert len(ref["points"]) == n and ("intensity" in ref) == intensity


def test_e57_page_checksums_match_jax():
    """The port checksums all pages at once: the same CRC-32C words as
    the JAX package's byte loop, page for page."""
    rng = np.random.default_rng(8)
    for n in (0, 1, 1019, 1020, 1021, 5000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert te57._to_physical(data) == je57._to_physical(data)
    assert te57.crc32c(b"123456789") == je57.crc32c(b"123456789") == 0xE3069283


def _scaled_integer_e57(rng, n=300, scale=0.001):
    """A ScaledInteger E57 (the common scanner layout), bit-packed at
    the width its bounds need, as tests/test_io_extra.py builds it."""
    pts = rng.uniform(0, 10, (n, 3))
    q = np.round(pts / scale).astype(np.int64)
    mn, mx = int(q.min()), int(q.max())
    bits = max((mx - mn).bit_length(), 1)

    def pack(vals):
        u = (vals - mn).astype(np.uint64)
        b = ((u[:, None] >> np.arange(bits, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
        return np.packbits(b.ravel(), bitorder="little").tobytes()

    streams = [pack(q[:, i]) for i in range(3)]
    header_len = 6 + 2 * 3
    pad = (-header_len) % 4
    body = b"".join(streams)
    pkt_len = header_len + pad + len(body)
    pkt_len += (-pkt_len) % 4
    packet = struct.pack("<BBHH", 1, 0, pkt_len - 1, 3) + struct.pack("<3H", *map(len, streams))
    packet += b"\x00" * pad + body
    packet += b"\x00" * (pkt_len - len(packet))
    section = struct.pack("<B7xQQQ", 1, 32 + len(packet), je57._phys_off(48 + 32), 0)
    proto = "".join(f'<{nm} type="ScaledInteger" minimum="{mn}" maximum="{mx}" '
                    f'scale="{scale}" offset="0"/>'
                    for nm in ("cartesianX", "cartesianY", "cartesianZ"))
    xml = ('<?xml version="1.0" encoding="UTF-8"?><e57Root type="Structure" '
           'xmlns="http://www.astm.org/COMMIT/E57/2010-e57-v1.0"><data3D type="Vector">'
           '<vectorChild type="Structure"><points type="CompressedVector" fileOffset="48" '
           f'recordCount="{n}"><prototype type="Structure">{proto}</prototype></points>'
           '</vectorChild></data3D></e57Root>').encode()
    logical = bytearray(b"\x00" * 48) + section + packet
    xml_off = len(logical)
    logical += xml
    physical = bytearray(je57._to_physical(bytes(logical)))
    physical[:48] = struct.pack("<8sIIQQQQ", b"ASTM-E57", 1, 0, len(physical),
                                je57._phys_off(xml_off), len(xml), 1024)
    physical[1020:1024] = struct.pack("<I", je57.crc32c(bytes(physical[:1020])))
    return bytes(physical)


def test_e57_scaled_integer_reads_like_jax(tmp_path):
    p = tmp_path / "si.e57"
    p.write_bytes(_scaled_integer_e57(np.random.default_rng(9)))
    ref = _arrays(je57.read_point_cloud(p))
    _assert_same(_arrays(te57.read_point_cloud(p, **CPU)), ref)


@pytest.mark.parametrize("case", ["magic", "page_size", "crc", "no_data3d"])
def test_e57_refusals_match_jax(tmp_path, case):
    pts = np.random.default_rng(1).normal(size=(100, 3)).astype(np.float32)
    p = tmp_path / "s.e57"
    te57.write_point_cloud(p, tt.PointCloud.from_numpy(pts, **CPU))
    blob = bytearray(p.read_bytes())
    if case == "magic":
        blob[:8] = b"NOT-E57!"
    elif case == "page_size":
        struct.pack_into("<Q", blob, 40, 2048)
    elif case == "crc":
        blob[100] ^= 0xFF
    else:
        logical = te57._to_logical(bytes(blob))
        xml_phys, xml_len = struct.unpack_from("<QQ", blob, 24)
        start = te57._logical_from_phys(xml_phys)
        xml = logical[start:start + xml_len].replace(b"data3D", b"data9D")
        logical = logical[:start] + xml + logical[start + xml_len:]
        blob = bytearray(te57._to_physical(logical))
        blob[:48] = p.read_bytes()[:48]
        blob[1020:1024] = struct.pack("<I", te57.crc32c(bytes(blob[:1020])))
    p.write_bytes(bytes(blob))
    _raises_alike(lambda: je57.read_point_cloud(p), lambda: te57.read_point_cloud(p, **CPU))


# ---------------------------------------------------------------------------
# rosbag2 and MCAP, on the JAX tests' fixture builders
# ---------------------------------------------------------------------------

def _bag(tmp_path, n=2000):
    pts = np.random.default_rng(21).normal(size=(n, 3)).astype(np.float32)
    p = tmp_path / "ride.db3"
    jfix.TestRosbag2()._make_bag(p, pts)
    return p, pts


def _mcap(tmp_path, n=2000):
    pts = np.random.default_rng(22).normal(size=(n, 3)).astype(np.float32)
    p = tmp_path / "ride.mcap"
    jfix.TestMcap()._make_mcap(p, pts)
    return p, pts


def test_cdr_decode_matches_jax():
    pts = np.random.default_rng(23).normal(size=(50, 3)).astype(np.float32)
    blob = jfix.make_pointcloud2_cdr(pts, frame="lidar")
    jm, tm = jbag.decode_pointcloud2_cdr(blob), tbag.decode_pointcloud2_cdr(blob)
    assert jm == tm
    _assert_same(_arrays(tros2.from_pointcloud2(tm, **CPU)), _arrays(jros2.from_pointcloud2(jm)))


@pytest.mark.parametrize("topic", [None, "/lidar/points"])
def test_rosbag2_reads_like_jax(tmp_path, topic):
    p, pts = _bag(tmp_path)
    jr, tr = jbag.Rosbag2Reader(p), tbag.Rosbag2Reader(p)
    try:
        assert tr.topics() == jr.topics() and tr.pointcloud_topics() == ["/lidar/points"]
        jc, tcs = jr.read_clouds(topic), tr.read_clouds(topic, **CPU)
        assert len(tcs) == len(jc) == 3
        for a, b in zip(tcs, jc):
            _assert_same(_arrays(a), _arrays(b))
        assert len(tr.read_clouds(max_messages=2, **CPU)) == 2
    finally:
        jr.close()
        tr.close()
    ref = _arrays(tc.read_point_cloud(p, topic=topic))
    _assert_same(_arrays(tt.read_point_cloud(p, topic=topic, **CPU)), ref)
    np.testing.assert_array_equal(ref["points"][-len(pts):], pts + 2)


@pytest.mark.parametrize("topic", [None, "/points"])
def test_mcap_reads_like_jax(tmp_path, topic):
    p, pts = _mcap(tmp_path)
    jr, tr = jbag.McapReader(p), tbag.McapReader(p)
    assert tr.pointcloud_topics() == jr.pointcloud_topics() == ["/points"]
    assert tr.schemas == jr.schemas and tr.channels == jr.channels
    for a, b in zip(tr.read_clouds(topic, **CPU), jr.read_clouds(topic)):
        _assert_same(_arrays(a), _arrays(b))
    ref = _arrays(tc.read_point_cloud(p, topic=topic))
    _assert_same(_arrays(tt.read_point_cloud(p, topic=topic, **CPU)), ref)
    assert len(ref["points"]) == 2 * len(pts)


@pytest.mark.parametrize("case", ["mcap_magic", "mcap_topic", "mcap_compressed", "bag_topic",
                                  "cdr_short", "cdr_encapsulation"])
def test_rosbag_refusals_match_jax(tmp_path, case):
    if case == "mcap_magic":
        p = tmp_path / "x.mcap"
        p.write_bytes(b"nope nope")
        _raises_alike(lambda: jbag.McapReader(p), lambda: tbag.McapReader(p))
    elif case == "mcap_topic":
        p, _ = _mcap(tmp_path, 10)
        _raises_alike(lambda: jbag.read_point_cloud_mcap(p, topic="/x"),
                      lambda: tbag.read_point_cloud_mcap(p, topic="/x", **CPU))
    elif case == "mcap_compressed":
        body = struct.pack("<QQQI", 0, 0, 0, 0) + struct.pack("<I", 4) + b"zstd" \
            + struct.pack("<Q", 0)
        p = tmp_path / "z.mcap"
        p.write_bytes(b"\x89MCAP0\r\n" + bytes([0x06]) + struct.pack("<Q", len(body)) + body)
        _raises_alike(lambda: jbag.McapReader(p), lambda: tbag.McapReader(p))
    elif case == "bag_topic":
        p, _ = _bag(tmp_path, 10)
        _raises_alike(lambda: tc.read_point_cloud(p, topic="/none"),
                      lambda: tt.read_point_cloud(p, topic="/none", **CPU))
    elif case == "cdr_short":
        _raises_alike(lambda: jbag.decode_pointcloud2_cdr(b"\x00"),
                      lambda: tbag.decode_pointcloud2_cdr(b"\x00"))
    else:
        _raises_alike(lambda: jbag.decode_pointcloud2_cdr(b"\x00\x07\x00\x00"),
                      lambda: tbag.decode_pointcloud2_cdr(b"\x00\x07\x00\x00"))


# ---------------------------------------------------------------------------
# ROS 2 PointCloud2 converters
# ---------------------------------------------------------------------------

def _typed_clouds(normals, colors, n=300):
    rng = np.random.default_rng(31 + 2 * normals + colors)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    attrs = {"intensity": rng.uniform(0, 1, n).astype(np.float32)}
    if normals:
        nr = rng.normal(size=(n, 3)).astype(np.float32)
        attrs["normals"] = nr / np.linalg.norm(nr, axis=1, keepdims=True)
    if colors:
        attrs["colors"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return tc.PointCloud.from_numpy(pts, **attrs), tt.PointCloud.from_numpy(pts, **CPU, **attrs)


def _on_cpu(module):
    """The port's decoders default to the card: ask for the CPU here."""
    return {} if module is jros2 else CPU


CONVERTERS = [("xyz", False, False), ("normals", True, False), ("colored", False, True),
              ("colored_normals", True, True)]


@pytest.mark.parametrize("name,normals,colors", CONVERTERS)
def test_named_converters_match_jax(name, normals, colors):
    jc, tcl = _typed_clouds(normals, colors)
    jm = getattr(jros2, f"{name}_to_pointcloud2")(jc, frame_id="velodyne")
    tm = getattr(tros2, f"{name}_to_pointcloud2")(tcl, frame_id="velodyne")
    assert type(tm).__name__ == "PointCloud2Data" and repr(tm) == repr(jm)
    assert tm.message == jm.message
    assert tm.fields() == jm.fields() and tm.data() == jm.data()
    args = (tm.data(), tm.fields(), tm.point_step, tm.width, tm.height)
    jb = getattr(jros2, f"pointcloud2_to_{name}")(*args)
    tb = getattr(tros2, f"pointcloud2_to_{name}")(*args, **CPU)
    assert type(tb).__name__ == type(jb).__name__
    _assert_same(_arrays(tb), _arrays(jb))


def test_make_and_read_pointcloud2_match_jax():
    jc, tcl = _typed_clouds(True, True)
    jm, tm = jros2.make_pointcloud2(jc, "map"), tros2.make_pointcloud2(tcl, "map")
    assert tm == jm
    _assert_same(_arrays(tros2.from_pointcloud2(tros2.PointCloud2Data(tm), **CPU)),
                 _arrays(jros2.from_pointcloud2(jros2.PointCloud2Data(jm))))


@pytest.mark.parametrize("case", ["missing_normals", "missing_colors", "need_normals",
                                  "need_colors", "too_short", "bad_datatype", "no_z",
                                  "organized_shape"])
def test_converter_refusals_match_jax(case):
    jc, tcl = _typed_clouds(False, False)
    raw = tros2.xyz_to_pointcloud2(tcl)
    args = (raw.data(), raw.fields(), raw.point_step, raw.width, raw.height)
    calls = {
        "missing_normals": lambda m: m.pointcloud2_to_normals(*args, **_on_cpu(m)),
        "missing_colors": lambda m: m.pointcloud2_to_colored(*args, **_on_cpu(m)),
        "need_normals": lambda m: m.normals_to_pointcloud2(jc if m is jros2 else tcl),
        "need_colors": lambda m: m.colored_normals_to_pointcloud2(jc if m is jros2 else tcl),
        "too_short": lambda m: m.pointcloud2_to_xyz(args[0][:-4], *args[1:], **_on_cpu(m)),
        "bad_datatype": lambda m: m.pointcloud2_to_xyz(args[0], [("x", 0, 9, 1)], *args[2:],
                                                       **_on_cpu(m)),
        "no_z": lambda m: m.pointcloud2_to_xyz(args[0], args[1][:2], *args[2:], **_on_cpu(m)),
        "organized_shape": lambda m: m.make_pointcloud2(jc if m is jros2 else tcl,
                                                        organized_shape=(7, 7)),
    }
    _raises_alike(lambda: calls[case](jros2), lambda: calls[case](tros2))


def test_rgba_stride_and_non_dense_match_jax():
    """A strided layout with rgba as UINT32 (alpha discarded), and a
    non-dense message whose NaN rows are skipped."""
    rng = np.random.default_rng(33)
    n = 200
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[::7] = np.nan
    rec = np.zeros(n, np.dtype({"names": ["x", "y", "z", "rgba", "junk"],
                                "formats": ["<f4", "<f4", "<f4", "<u4", "<u4"],
                                "offsets": [0, 4, 8, 16, 20], "itemsize": 24}))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rec["rgba"] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    args = (rec.tobytes(), [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
                            ("rgba", 16, 6, 1)], 24, n, 1, False, False)
    jb = jros2.pointcloud2_to_colored(*args)
    tb = tros2.pointcloud2_to_colored(*args, **CPU)
    assert len(tb) == n - len(range(0, n, 7))
    _assert_same(_arrays(tb), _arrays(jb))


def test_organized_round_trip_matches_jax():
    rng = np.random.default_rng(34)
    h, w = 16, 32
    grid = rng.normal(size=(h, w, 3)).astype(np.float32)
    valid = rng.uniform(size=(h, w)) > 0.2
    jo = JOrganized.from_numpy(np.where(valid[..., None], grid, 0), valid)
    to = TOrganized.from_numpy(np.where(valid[..., None], grid, 0), valid, **CPU)
    jm, tm = jros2.make_pointcloud2_organized(jo), tros2.make_pointcloud2_organized(to)
    assert tm == jm and not tm["is_dense"]
    jb, tb = jros2.from_pointcloud2_organized(jm), tros2.from_pointcloud2_organized(tm, **CPU)
    np.testing.assert_array_equal(tb.points.numpy(), np.asarray(jb.points))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    np.testing.assert_array_equal(tb.mask.numpy(), valid)
    _raises_alike(lambda: jros2.from_pointcloud2_organized(jros2.make_pointcloud2(
        tc.PointCloud.from_numpy(grid.reshape(-1, 3)))),
        lambda: tros2.from_pointcloud2_organized(tros2.make_pointcloud2(
            tt.PointCloud.from_numpy(grid.reshape(-1, 3), **CPU))))


# ---------------------------------------------------------------------------
# GLB, .tcz and artifacts
# ---------------------------------------------------------------------------

def _meshes(attrs=True):
    rng = np.random.default_rng(41)
    v = rng.normal(size=(400, 3)).astype(np.float32)
    f = (np.arange(390)[:, None] + np.array([0, 1, 2])) % 400
    kw = {"normals": rng.normal(size=(400, 3)).astype(np.float32),
          "colors": rng.uniform(0, 1, (400, 3)).astype(np.float32)} if attrs else {}
    return tc.TriangleMesh.from_numpy(v, f, **kw), tt.TriangleMesh.from_numpy(v, f, **CPU, **kw)


def _mesh_arrays(m):
    v, f = m.to_numpy()
    return {"vertices": np.asarray(v), "faces": np.asarray(f),
            **{k: np.asarray(m.attr_to_numpy(k)) for k in m.attrs}}


@pytest.mark.parametrize("attrs", [False, True])
def test_glb_files_match_jax_both_ways(tmp_path, attrs):
    jm, tm = _meshes(attrs)
    jp, tp = tmp_path / "j.glb", tmp_path / "t.glb"
    tc.write_mesh(jp, jm)
    tt.write_mesh(tp, tm)
    assert jp.read_bytes() == tp.read_bytes()
    ref = _mesh_arrays(jgltf.read_mesh_glb(tp))
    got = _mesh_arrays(tt.read_mesh(jp, **CPU))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    _raises_alike(lambda: jgltf.write_mesh_glb(jp, tc.TriangleMesh.from_numpy(
        np.zeros((3, 3), np.float32), np.zeros((0, 3), np.int32))),
        lambda: tgltf.write_mesh_glb(tp, tt.TriangleMesh.from_numpy(
            np.zeros((3, 3), np.float32), np.zeros((0, 3), np.int32), **CPU)))


@pytest.mark.parametrize("bits", [8, 14, 21])
def test_tcz_files_match_jax_both_ways(tmp_path, bits):
    jc, tcl = _clouds(n=4000, gps=False, walk=False)
    cfg_j, cfg_t = jcomp.CompressionConfig(position_bits=bits), \
        tcomp.CompressionConfig(position_bits=bits)
    ref = _cross(tmp_path, "tcz", lambda p: tc.write_point_cloud(p, jc, config=cfg_j),
                 lambda p: tt.write_point_cloud(p, tcl, config=cfg_t), tc.read_point_cloud,
                 lambda p: tt.read_point_cloud(p, **CPU))
    assert sorted(ref) == ["colors", "intensity", "points"]
    blob = tt.compress_draco(tcl, cfg_t)
    assert blob == tc.compress_draco(jc, cfg_j)
    _assert_same(_arrays(tt.decompress_draco(blob, **CPU)), _arrays(tc.decompress_draco(blob)))


@pytest.mark.parametrize("blob", [b"DRACO\x02\x02", b"nope", b""])
def test_tcz_refusals_match_jax(blob):
    _raises_alike(lambda: tc.decompress_draco(blob), lambda: tt.decompress_draco(blob, **CPU))
    _raises_alike(lambda: tc.compress_point_cloud(tc.PointCloud.from_numpy(np.zeros((0, 3)))),
                  lambda: tt.compress_point_cloud(tt.PointCloud.from_numpy(np.zeros((0, 3)),
                                                                           **CPU)))


def _volumes():
    intr = np.array([8.0, 8.0, 4.0, 4.0], np.float32)
    depth = np.full((8, 8), 0.3, np.float32)
    jv = tc.tsdf_integrate(tc.create_tsdf_volume((8, 8, 8), 0.1, with_color=True), depth,
                           intr, np.eye(4, dtype=np.float32))
    tv = ttsdf.integrate(ttsdf.create_volume((8, 8, 8), 0.1, with_color=True, **CPU), depth,
                         intr, np.eye(4, dtype=np.float32))
    return jv, tv


def _artifact_arrays(obj):
    if hasattr(obj, "tsdf"):
        return {k: np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
                for k, v in obj._asdict().items()}
    names = ("points", "mask") if hasattr(obj, "points") else \
        ("vertices", "faces", "vertex_mask", "face_mask")
    out = {k: getattr(obj, k) for k in names}
    out.update({f"attr_{k}": v for k, v in obj.attrs.items()})
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


@pytest.mark.parametrize("kind", ["cloud", "mesh", "tsdf"])
def test_artifacts_load_across_packages(tmp_path, kind):
    """An artifact that either package saves loads into the other's
    objects with equal arrays (dtypes and capacities included)."""
    if kind == "cloud":
        jo, to = _clouds(n=500)
    elif kind == "mesh":
        jo, to = _meshes()
    else:
        jo, to = _volumes()
    ja, ta = _artifact_arrays(jo), _artifact_arrays(to)
    assert sorted(ja) == sorted(ta)
    jart.save_artifact(tmp_path / "j.npz", jo)
    tart.save_artifact(tmp_path / "t.npz", to)
    from_jax = tart.load_artifact(tmp_path / "j.npz", **CPU)
    from_port = jart.load_artifact(tmp_path / "t.npz")
    assert type(from_jax) is type(to) and type(from_port) is type(jo)
    for got, ref in ((_artifact_arrays(from_jax), ja), (_artifact_arrays(from_port), ta)):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if kind == "tsdf":
        depth = np.full((8, 8), 0.3, np.float32)
        resumed = ttsdf.integrate(from_jax, depth, np.array([8.0, 8.0, 4.0, 4.0], np.float32),
                                  np.eye(4, dtype=np.float32))
        assert float(resumed.weight.max()) == 2.0


def test_artifact_refusals_match_jax(tmp_path):
    np.savez(tmp_path / "plain.npz", a=np.zeros(3))
    np.savez(tmp_path / "kind.npz", __tc_kind__=np.asarray("octree"))
    for name in ("plain.npz", "kind.npz"):
        _raises_alike(lambda: jart.load_artifact(tmp_path / name),
                      lambda: tart.load_artifact(tmp_path / name, **CPU))
    _raises_alike(lambda: jart.save_artifact(tmp_path / "x.npz", object()),
                  lambda: tart.save_artifact(tmp_path / "y.npz", object()))
