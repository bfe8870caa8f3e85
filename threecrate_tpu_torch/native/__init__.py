"""Native (C++) I/O helpers, compiled on demand and loaded with ctypes.

Counterpart of ``threecrate_tpu.native``: two small C++ libraries, the
same sources. ``tc_native.cpp`` does the host-side byte crunching NumPy
does poorly: ASCII float parsing, Velodyne packet decoding and the LZF
codec of PCD's ``binary_compressed`` payload. ``tc_laz.cpp`` is the
LASzip codec of ``.laz`` files (compressor 2, point formats 0-3, one
thread a chunk).

``g++`` builds each at its first call, never at import, into ``build/``
beside this file. A library's name carries a hash of its source and
the flags, and it is built under a temporary name and renamed into
place, so processes that build at the same moment never load a
half-written file. Without a compiler every function of
``tc_native`` falls back to NumPy or Python, as the JAX package does,
and the LASzip functions return None; ``counts`` records which parser
each ``parse_floats`` call ran ("native" or "numpy").
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "tc_native.cpp"
LAZ_SRC = Path(__file__).resolve().parent / "tc_laz.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LAZ_GXX_FLAGS = GXX_FLAGS + ("-pthread",)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_laz_lib: Optional[ctypes.CDLL] = None
_laz_tried = False

# parse_floats calls by the parser that ran, since the last reset_counts()
counts = collections.Counter()


def reset_counts() -> None:
    counts.clear()


def _hashed_path(src: Path, flags, stem: str) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _hashed_path(SRC, GXX_FLAGS, "libtc_native")


def laz_library_path() -> Path:
    return _hashed_path(LAZ_SRC, LAZ_GXX_FLAGS, "libtc_laz")


def _build(src: Path, flags, out: Path, timeout: int) -> Optional[Path]:
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(["g++", *flags, "-o", tmp, str(src)],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None without a
    compiler (the NumPy fallbacks then run)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build(SRC, GXX_FLAGS, library_path(), timeout=120)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.tc_parse_floats.restype = ctypes.c_long
        lib.tc_parse_floats.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        lib.tc_count_tokens.restype = ctypes.c_long
        lib.tc_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.tc_decode_velodyne.restype = ctypes.c_long
        lib.tc_decode_velodyne.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.tc_lzf_decompress.restype = ctypes.c_long
        lib.tc_lzf_decompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.tc_lzf_compress.restype = ctypes.c_long
        lib.tc_lzf_compress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        _lib = lib
        return lib


def available() -> bool:
    """True when the native library builds and loads here."""
    return _load() is not None


def parse_floats(text) -> np.ndarray:
    """Parse all numeric tokens in ``text`` (str or bytes) → float64
    array. Uses the native parser when available, else NumPy."""
    if isinstance(text, str):
        text = text.encode("ascii", errors="replace")
    lib = _load()
    if lib is None:
        counts["numpy"] += 1
        return np.array(text.split(), np.float64)
    n_max = lib.tc_count_tokens(text, len(text))
    out = np.empty(n_max, np.float64)
    n = lib.tc_parse_floats(
        text, len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_max)
    if n < n_max:
        # exotic token hit the fallback stop — let numpy handle it all
        counts["numpy"] += 1
        return np.array(text.split(), np.float64)
    counts["native"] += 1
    return out


def decode_velodyne_batch(packets: np.ndarray, dist_resolution: float):
    """(P, 1206) uint8 packets → (distance, azimuth_rad, intensity)
    arrays of length P·12·32 (native) or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    packets = np.ascontiguousarray(packets, np.uint8)
    n_pkts = packets.shape[0]
    n = n_pkts * 12 * 32
    dist = np.empty(n, np.float32)
    az = np.empty(n, np.float32)
    inten = np.empty(n, np.float32)
    lib.tc_decode_velodyne(
        packets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_pkts,
        dist_resolution,
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        az.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        inten.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return dist, az, inten


def lzf_decompress(src: bytes, expected_size: int) -> bytes:
    """LZF block decode (the PCD ``binary_compressed`` payload codec).
    Native when available; pure-Python fallback otherwise."""
    lib = _load()
    if lib is not None:
        sarr = np.frombuffer(src, np.uint8)
        out = np.empty(expected_size, np.uint8)
        n = lib.tc_lzf_decompress(
            sarr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(src),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            expected_size)
        if n < 0:
            raise ValueError("corrupt LZF stream")
        return out[:n].tobytes()
    # fallback: byte-at-a-time python decoder (correct, slow)
    out = bytearray()
    ip, n = 0, len(src)
    while ip < n:
        ctrl = src[ip]
        ip += 1
        if ctrl < 32:
            ln = ctrl + 1
            if ip + ln > n:
                raise ValueError("corrupt LZF stream")
            out += src[ip:ip + ln]
            ip += ln
        else:
            ln = ctrl >> 5
            if ln == 7:
                if ip >= n:
                    raise ValueError("corrupt LZF stream")
                ln += src[ip]
                ip += 1
            ln += 2
            if ip >= n:
                raise ValueError("corrupt LZF stream")
            dist = ((ctrl & 0x1F) << 8 | src[ip]) + 1
            ip += 1
            ref = len(out) - dist
            if ref < 0:
                raise ValueError("corrupt LZF stream")
            for _ in range(ln):
                out.append(out[ref])
                ref += 1
    if len(out) > expected_size:
        raise ValueError("LZF output larger than declared size")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """LZF block encode. Native greedy hash-chain when available; the
    fallback emits an all-literal stream (valid LZF, no compression)."""
    lib = _load()
    if lib is not None:
        sarr = np.frombuffer(data, np.uint8)
        cap = len(data) + len(data) // 16 + 64
        out = np.empty(cap, np.uint8)
        n = lib.tc_lzf_compress(
            sarr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n > 0:
            return out[:n].tobytes()
    out = bytearray()
    for s in range(0, len(data), 32):
        run = data[s:s + 32]
        out.append(len(run) - 1)
        out += run
    return bytes(out)


# ---------------------------------------------------------------------------
# LASzip codec (separate shared object: tc_laz.cpp)
# ---------------------------------------------------------------------------

def _load_laz() -> Optional[ctypes.CDLL]:
    """The loaded LASzip library, built at the first call; None without
    a compiler."""
    global _laz_lib, _laz_tried
    with _lock:
        if _laz_lib is not None or _laz_tried:
            return _laz_lib
        _laz_tried = True
        so = _build(LAZ_SRC, LAZ_GXX_FLAGS, laz_library_path(), timeout=240)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tc_laz_decompress.restype = ctypes.c_long
        lib.tc_laz_decompress.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_uint, ctypes.c_int, u8p, ctypes.c_int]
        lib.tc_laz_compress.restype = ctypes.c_long
        lib.tc_laz_compress.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, ctypes.c_long, u8p, ctypes.c_long]
        _laz_lib = lib
        return lib


def laz_available() -> bool:
    """True when the LASzip library builds and loads here."""
    return _load_laz() is not None


def laz_decompress(file_bytes: bytes, point_off: int, n_points: int,
                   chunk_size: int, point_format: int,
                   rec_len: int) -> Optional[np.ndarray]:
    """Decompress a LAZ point block → (n, rec_len) uint8 records, or
    None when the native codec is unavailable. Raises ValueError on a
    corrupt/unsupported stream."""
    lib = _load_laz()
    if lib is None:
        return None
    buf = np.frombuffer(file_bytes, np.uint8)
    out = np.zeros(n_points * rec_len, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    r = lib.tc_laz_decompress(
        buf.ctypes.data_as(u8p), len(buf), point_off, n_points,
        chunk_size, point_format, out.ctypes.data_as(u8p), rec_len)
    if r != 0:
        raise ValueError(f"LASzip decode failed (code {r})")
    return out.reshape(n_points, rec_len)


def laz_compress(records: np.ndarray, point_format: int,
                 chunk_size: int, block_file_off: int) -> Optional[bytes]:
    """Compress (n, rec_len) uint8 records → LAZ point block bytes
    ([i64 chunk-table pos][chunks][table]), or None when unavailable."""
    lib = _load_laz()
    if lib is None:
        return None
    records = np.ascontiguousarray(records, np.uint8)
    n, rec_len = records.shape
    cap = n * rec_len * 2 + (n // max(chunk_size, 1) + 2) * 64 + 65536
    out = np.zeros(cap, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    r = lib.tc_laz_compress(
        records.ctypes.data_as(u8p), n, rec_len, point_format,
        chunk_size, block_file_off, out.ctypes.data_as(u8p), cap)
    if r < 0:
        raise ValueError(f"LASzip encode failed (code {r})")
    return out[:r].tobytes()
