#!/usr/bin/env python3
"""Time design variants of the SPFH histogram kernels on one card.

    python3 tools/spfh_variants.py

Each variant is ``threecrate_tpu_torch/csrc/fpfh.cu`` with one design
choice of the stage-1 kernel changed by a text substitution: a per-lane
mask loop over 32-column chunks in place of the warp's ring of selected pairs, no
culling, one int vote counter a word instead of two 16-bit ones, 128
threads a block, no register cap, and 1/sqrt as ``__frcp_rn`` of the
square root (the same bits). Each is built and timed as
``tools/kernel_variants.py`` says, launched through its ``tc_spfh_a``
and ``tc_spfh_b`` on the phase-3 inputs of ``chip_smoke.py``: the
registration target's 1M sorted points with the port's normals, tile
256, at r = 0.5 (``RegistrationModel``'s radius) and r = 0.25. Every
variant's 34 rows must equal the committed source's on every query. The
last line is one JSON object with the card and every variant's numbers.
An earlier source is timed by running ``chip_smoke.py`` from a
``git archive`` of it beside one of this tree, in one call.
Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

TILE = 256
RADII = (0.5, 0.25)
# the sweep of one chunk in the committed source
SWEEP = ("// The sweep over columns c0",
         "template <bool kPassB>\n__global__ void __launch_bounds__(kSpfhThreads")
MASK_SWEEP = r'''// The per-lane sweep: each lane gathers its selections of the chunk in a
// mask and votes them itself into its own counters, with no atomics; the
// warp runs as many bodies as its busiest lane selects.
template <bool kPassB>
__device__ __forceinline__ void sweep_chunk(PairQueue& pq, int c0, int chunk,
                                            const float4* __restrict__ win,
                                            const float4* __restrict__ nrm, float4 q,
                                            int tile_q, bool active, float r2, int self0,
                                            float th_scale, int& cnt) {
  const int lane = threadIdx.x % kWarp;
  unsigned mask = 0u;
#pragma unroll 4
  for (int c = c0; c < c0 + chunk; ++c) {
    const float4 b = win[c];
    const int tag = __float_as_int(b.w);
    const float d2 = tc::sq_dist(q.x, q.y, q.z, b.x, b.y, b.z);
    bool sel = active && tag >= 0 && d2 <= r2 && d2 > 1e-12f;
    if (kPassB) sel = sel && static_cast<unsigned>(tag - tile_q + 1) > 2u;
    mask |= static_cast<unsigned>(sel) << (c - c0);
  }
  cnt += __popc(mask);
  if (mask == 0u) return;
  const float4 qn = nrm[self0 + lane];
  const QueryFrame f{qn.x, qn.y, qn.z, th_scale, 0.5f * kBins};
  while (mask != 0u) {
    const int c = c0 + __ffs(mask) - 1;
    mask &= mask - 1u;
    const float4 b = win[c];
    const float dx = __fsub_rn(b.x, q.x);
    const float dy = __fsub_rn(b.y, q.y);
    const float dz = __fsub_rn(b.z, q.z);
    const float4 cn = nrm[c];
    const int3 bins = pair_bins(dx, dy, dz, dot3(dx, dy, dz, dx, dy, dz), f, cn.x, cn.y, cn.z);
    pq.votes[bins.x / kVotesPerWord * kVoteStride + lane] += 1u << (kVoteBits * (bins.x % kVotesPerWord));
    pq.votes[bins.y / kVotesPerWord * kVoteStride + lane] += 1u << (kVoteBits * (bins.y % kVotesPerWord));
    pq.votes[bins.z / kVotesPerWord * kVoteStride + lane] += 1u << (kVoteBits * (bins.z % kVotesPerWord));
  }
}

'''
FRCP = '''__device__ __forceinline__ float rsqrt_rn(float x) {
  return __frcp_rn(__fsqrt_rn(fmaxf(x, 1e-24f)));
}'''


def _region(source: str, marks) -> str:
    start = source.index(marks[0])
    return source[start:source.index(marks[1], start)]


def variants(source: str):
    """name -> (committed text, replacement) pairs applied to fpfh.cu."""
    sweep = _region(source, SWEEP)
    return {
        "committed": [],
        "per-lane mask loop": [(sweep, MASK_SWEEP), ("kSpfhChunk = 16;", "kSpfhChunk = 32;")],
        "no culling": [("      if (__all_sync(~0u, beyond)) continue;\n", "")],
        "int vote counters": [("kVotesPerWord = 2;", "kVotesPerWord = 1;")],
        "128 threads": [("kSpfhThreads = 256;", "kSpfhThreads = 128;"),
                        ("kSpfhBlocks = 4;", "kSpfhBlocks = 8;")],
        "no register cap": [("kSpfhBlocks = 4;", "kSpfhBlocks = 1;")],
        "1/sqrt by __frcp_rn": [("using tc::rsqrt_rn;", FRCP)],
    }


def label(entry: str):
    """The pass of a stage-1 kernel entry, else None."""
    if "spfh_kernel" not in entry:
        return None
    return "B" if "ILb1E" in entry else "A"


def main() -> int:
    if not torch.cuda.is_available():
        print("spfh_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    pa, pb, pos_b, _ = chip_smoke.fpfh_inputs(dev)
    n = pa.shape[1]
    out = torch.empty((34, n), device=dev)
    # timing name -> (pass B, radius)
    runs = {f"{p} r={r}": (p == "B", r) for r in RADII for p in ("A", "B")}

    def launch(lib, run):
        pass_b, radius = runs[run]
        stream = torch.cuda.current_stream().cuda_stream
        r2 = radius * radius      # rounded to fp32 by ctypes, as the wrapper does
        if pass_b:
            err = lib.tc_spfh_b(pb.data_ptr(), pos_b.data_ptr(), out.data_ptr(), n, TILE, r2,
                                stream)
        else:
            err = lib.tc_spfh_a(pa.data_ptr(), out.data_ptr(), n, TILE, r2, stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    source = (kernel_variants.CSRC / "fpfh.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "fpfh.cu", variants(source),
                                     ("tc_spfh_a", "tc_spfh_b"), label)
        report = kernel_variants.compare_and_time(libs, runs, launch, out)
    return kernel_variants.print_report(card, report, tile=TILE, n=n)


if __name__ == "__main__":
    sys.exit(main())
