#!/usr/bin/env python3
"""Time design variants of the FPFH weighted-sum kernels on one card.

    python3 tools/fpfh_weight_variants.py

Each variant is ``threecrate_tpu_torch/csrc/fpfh.cu`` with one design
choice of the stage-2 kernel changed by a text substitution (the
culling chunk, no culling, the SPFH payload as 33 scalar rows instead of
9 float4 planes, queries a thread, the payload of the whole window
staged at once instead of one segment at a time, no cap of 64 registers
a thread), built and timed as ``tools/kernel_variants.py`` says and
launched through its ``tc_fpfh_weight_a`` and ``tc_fpfh_weight_b`` on
the phase-3 inputs of ``chip_smoke.py``: the registration target's 1M
sorted points with the kernels' SPFH, tile 256, at r = 0.5
(``RegistrationModel``'s radius) and r = 0.25 (the default FPFH's stage
2). Every variant's 34 rows must equal the committed source's on every
query. The last line is one JSON object with the card and every
variant's numbers. Needs one CUDA card and ``nvcc``; exits non-zero
without them.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

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


def label(entry: str):
    """The pass of a stage-2 kernel entry, else None."""
    if "fpfh_weight_kernel" not in entry:
        return None
    return "B" if "ILb1E" in entry else "A"


def main() -> int:
    if not torch.cuda.is_available():
        print("fpfh_weight_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from threecrate_tpu_torch.kernels import fpfh

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    pa, pb, pos_b, _ = chip_smoke.fpfh_inputs(dev)
    r2 = chip_smoke.FPFH_RADIUS ** 2
    p2a, p2b = chip_smoke.stage2_inputs(pa, pb, pos_b, fpfh.spfh_a_tiles(pa, r2, TILE),
                                        fpfh.spfh_b_tiles(pb, pos_b, r2, TILE))
    n = p2a.shape[1]
    out = torch.empty((34, n), device=dev)
    # timing name -> (pass B, radius)
    runs = {f"{p} r={r}": (p == "B", r) for r in RADII for p in ("A", "B")}

    def launch(lib, run):
        pass_b, radius = runs[run]
        stream = torch.cuda.current_stream().cuda_stream
        r2 = radius * radius      # rounded to fp32 by ctypes, as the wrapper does
        if pass_b:
            err = lib.tc_fpfh_weight_b(p2b.data_ptr(), pos_b.data_ptr(), out.data_ptr(), n,
                                       TILE, r2, stream)
        else:
            err = lib.tc_fpfh_weight_a(p2a.data_ptr(), out.data_ptr(), n, TILE, r2, stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    source = (kernel_variants.CSRC / "fpfh.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "fpfh.cu", variants(source),
                                     ("tc_fpfh_weight_a", "tc_fpfh_weight_b"), label)
        report = kernel_variants.compare_and_time(libs, runs, launch, out)
    return kernel_variants.print_report(card, report, tile=TILE, n=n)


if __name__ == "__main__":
    sys.exit(main())
