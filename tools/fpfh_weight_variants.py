#!/usr/bin/env python3
"""Time design variants of the FPFH weighted-sum kernels on one card.

    python3 tools/fpfh_weight_variants.py

Each variant is ``threecrate_tpu_torch/csrc/fpfh.cu`` with one design
choice of the stage-2 kernel changed by a text substitution (the
culling chunk, no culling, the SPFH payload as 33 scalar rows instead of
9 float4 planes, queries a thread, the payload of the whole window
staged at once instead of one segment at a time, no cap of 64 registers
a thread), compiled alone into a
shared library (one ``nvcc`` per variant, all started together, with
``-Xptxas -v``) and launched through its ``tc_fpfh_weight_a`` and
``tc_fpfh_weight_b`` on the phase-3 inputs of ``chip_smoke.py``: the
registration target's 1M sorted points with the kernels' SPFH, tile
256, at r = 0.5 (``RegistrationModel``'s radius) and r = 0.25 (the
default FPFH's stage 2). Every variant's 34 rows must equal the
committed source's on every query. Times are CUDA-event medians of 10
launches, taken in two rounds over all variants within the one call;
each variant's registers and spills come from ptxas. The last line is
one JSON object with the card and every variant's numbers. Needs one
CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TILE = 256
RADII = (0.5, 0.25)
# the payload helpers of the committed source, and the scalar-row layout
# that the planes replaced: 33 rows of tile floats, one LDS.32 a bin
PAYLOAD = ("// Stage the SPFH payload of window segments", "// One candidate of the sweep")
SCALAR_PAYLOAD = """// 33 scalar SPFH rows per staged segment, as before the planes.
__device__ __forceinline__ void stage_payload(const float* __restrict__ packed, int n,
                                              int tile, int s0, float4* plane) {
  float* rows = reinterpret_cast<float*>(plane);
  const int n_t = n / tile;
  const int stride = kPlaneSegments * tile;
  const int t0 = static_cast<int>(blockIdx.x) - 1 + s0;
  for (int j = threadIdx.x; j < stride; j += blockDim.x) {
    const int ct = t0 + j / tile;
    if (ct < 0 || ct >= n_t) continue;
    const float* spfh = packed + 4L * n + static_cast<long>(t0) * tile + j;
    for (int b = 0; b < kHist; ++b) rows[b * stride + j] = spfh[b * static_cast<long>(n)];
  }
}

__device__ __forceinline__ void weigh(const float4* __restrict__ plane, int stride, int j,
                                      float w, float* acc) {
  const float* rows = reinterpret_cast<const float*>(plane);
#pragma unroll
  for (int b = 0; b < kHist; ++b) acc[b] = fmaf(w, rows[b * stride + j], acc[b]);
}

"""


def variants(source: str):
    """name -> (committed text, replacement) pairs applied to fpfh.cu."""
    start = source.index(PAYLOAD[0])
    payload = source[start:source.index(PAYLOAD[1], start)]
    return {
        "committed": [],
        "8-column chunks": [("kWeightChunk = 16;", "kWeightChunk = 8;")],
        "32-column chunks": [("kWeightChunk = 16;", "kWeightChunk = 32;")],
        "no culling": [("        if (beyond) continue;\n", "")],
        "scalar payload rows": [(payload, SCALAR_PAYLOAD)],
        "2 queries a thread": [("kWeightQueries = 1;", "kWeightQueries = 2;")],
        "whole-window payload": [("kPlaneSegments = 1;", "kPlaneSegments = 3;")],
        "no register cap": [("kWeightBlocks = 4;", "kWeightBlocks = 1;")],
    }


def build(tmp: Path):
    """{variant: (loaded library, ptxas lines of its weight kernels)}."""
    from threecrate_tpu_torch.kernels import _build

    csrc = ROOT / "threecrate_tpu_torch" / "csrc"
    source = (csrc / "fpfh.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(variants(source).items()):
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old[:60]!r} not found once in the source")
            text = text.replace(old, new)
        d = tmp / f"v{i}"
        d.mkdir()
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "fpfh.cu").write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / "fpfh.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("tc_fpfh_weight_a", "tc_fpfh_weight_b"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, ptxas_summary(log))
    return libs


def ptxas_summary(log: str):
    """'pass: N registers, S bytes spilled' for the two weight kernels in a
    ptxas -v log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        if entry is None or "fpfh_weight_kernel" not in entry:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            body = "B" if "ILb1E" in entry else "A"
            out.append(f"{body}: {m.group(1)} registers, {spill} bytes spilled")
            entry = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fpfh_weight_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from threecrate_tpu_torch.kernels import fpfh
    from threecrate_tpu_torch.utils.profiling import median_time

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    pa, pb, pos_b = chip_smoke.fpfh_inputs(dev)
    r2 = chip_smoke.FPFH_RADIUS ** 2
    p2a, p2b = chip_smoke.stage2_inputs(pa, pb, pos_b, fpfh.spfh_a_tiles(pa, r2, TILE),
                                        fpfh.spfh_b_tiles(pb, pos_b, r2, TILE))
    n = p2a.shape[1]
    out = torch.empty((34, n), device=dev)
    # (name, pass B, radius) of every timed configuration
    runs = [(f"{p} r={r}", p == "B", r) for r in RADII for p in ("A", "B")]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))

        def launch(lib, pass_b, radius):
            stream = torch.cuda.current_stream().cuda_stream
            r2 = radius * radius      # rounded to fp32 by ctypes, as the wrapper does
            if pass_b:
                err = lib.tc_fpfh_weight_b(p2b.data_ptr(), pos_b.data_ptr(), out.data_ptr(),
                                           n, TILE, r2, stream)
            else:
                err = lib.tc_fpfh_weight_a(p2a.data_ptr(), out.data_ptr(), n, TILE, r2, stream)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")

        ref = {}
        for rname, pass_b, radius in runs:
            launch(libs["committed"][0], pass_b, radius)
            torch.cuda.synchronize()
            ref[rname] = out.clone()
        report = {}
        for name, (lib, regs) in libs.items():
            equal = []
            for rname, pass_b, radius in runs:
                launch(lib, pass_b, radius)
                torch.cuda.synchronize()
                equal.append(bool(torch.equal(out, ref[rname])))
            report[name] = {"rows_equal_committed": equal, "ptxas": regs,
                            "ms": {rname: [] for rname, _, _ in runs}}
        for _ in range(2):
            for name, (lib, _) in libs.items():
                for rname, pass_b, radius in runs:
                    t = median_time(lambda lib=lib, b=pass_b, r=radius: launch(lib, b, r),
                                    warmup=1, iters=10)
                    report[name]["ms"][rname].append(1e3 * t)
    ok = True
    for name, r in report.items():
        ok &= all(r["rows_equal_committed"])
        times = ", ".join(f"{rname} {ms[0]:.4f} / {ms[1]:.4f}" for rname, ms in r["ms"].items())
        print(f"{name}: {times} ms; rows equal to committed {r['rows_equal_committed']}; "
              f"{'; '.join(r['ptxas'])}", flush=True)
    print(json.dumps({"card": card, "tile": TILE, "n": n, "variants": report}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
