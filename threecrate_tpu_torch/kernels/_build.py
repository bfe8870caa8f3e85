"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc``, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens at the first
launch, never at import, into ``kernels/build/`` beside this file; the
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. No fast math and
no flush-to-zero: the ICP kernel relies on its 2e19 sentinels
overflowing to +inf.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

from ..core.errors import DeviceError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # pts, valid, out, n, tile, k, band, stream
    "tc_union_window_a": (_P, _P, _P, _I, _I, _I, _I, _P),
    # pts, valid, pos_a, hi_a, out, n, tile, k, band, stream
    "tc_union_window_b": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # pts, valid, out, n, tile, k, band, stream
    "tc_window_normals": (_P, _P, _P, _I, _I, _I, _I, _P),
    # src, tgt, window_start, out, ns, nt, rows, tile, w_tiles, stream
    "tc_icp_match": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # packed, out, n, tile, r2, stream
    "tc_spfh_a": (_P, _P, _I, _I, _F, _P),
    "tc_fpfh_weight_a": (_P, _P, _I, _I, _F, _P),
    # packed, pos_a, out, n, tile, r2, stream
    "tc_spfh_b": (_P, _P, _P, _I, _I, _F, _P),
    "tc_fpfh_weight_b": (_P, _P, _P, _I, _I, _F, _P),
    # packed, out, n, tile, band, r2, stream
    "tc_spfh_band_a": (_P, _P, _I, _I, _I, _F, _P),
    "tc_spfh_band_b": (_P, _P, _I, _I, _I, _F, _P),
    # packed, plus (or null), out, n, band, r2, radius, stream
    "tc_shot_moments_a": (_P, _P, _P, _I, _I, _F, _F, _P),
    # packed, out, rows (or null), n, band, r2, radius, stream
    "tc_shot_moments_b": (_P, _P, _P, _I, _I, _F, _F, _P),
    # packed, lrf, out, rows (or null), n, band, r2, inv_r, usc, accumulate, stream
    "tc_shot_hist_a": (_P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _P),
    "tc_shot_hist_b": (_P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _P),
    # pts, valid, ids, neg, ids_out, crd, n, tile, k, with_coords, exclude_self, stream
    "tc_knn_window": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last nvcc run


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise DeviceError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                          "cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libthreecrate_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # build under unique names, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp_dir, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        stderr = [p.communicate()[1] for p in procs]
        failed = [f"{p.args[-1]}: {err}" for p, err in zip(procs, stderr)
                  if p.returncode != 0]
        if failed:
            raise DeviceError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmp_dir, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise DeviceError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def on_card(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device is refused."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type == "cuda"
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise DeviceError(f"{name} launch failed: CUDA error {err}")
