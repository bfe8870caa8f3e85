#!/usr/bin/env python3
"""Time design variants of descriptor matching's kernel on one card.

    python3 tools/match_variants.py

Each variant is ``threecrate_tpu_torch/csrc/match.cu`` with one design
choice changed by a text substitution: the grid's target of resident-block
waves (4 or 64 instead of 16, so other database splits of the forward
pass), no register cap (one block an SM), and each dimension's operands
read from shared memory one step ahead into registers (with and without
the cap). Each is built and timed as ``tools/kernel_variants.py`` says,
launched through its ``tc_match_nearest`` on FPFH-shaped rows
(``chip_smoke.fpfh_like``): the relocalize cell's two directions,
16,384 x 2^20 and 2^20 x 16,384 at D = 33, and SHOT's D = 352 at
16,384 x 131,072. Every variant's packed words must equal the committed
source's on every query (the atomicMin order does not change them). The
last line is one JSON object with the card and every variant's numbers.
Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

RUNS = {"forward": (16_384, 1 << 20, 33), "mutual": (1 << 20, 16_384, 33),
        "shot": (16_384, 131_072, 352)}
UNCAPPED = ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")
STEP = """    auto step = [&](int k) {
      const float* ra = s_a + k * kTile;
      const float* rb = s_b + k * kTile;
      const float4 a0 = *reinterpret_cast<const float4*>(ra + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ra + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(rb + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(rb + 64 + tx * 4);
"""
AHEAD = """    float4 a0, a1, b0, b1;
    auto fetch = [&](int k, float4& x0, float4& x1, float4& y0, float4& y1) {
      const float* ra = s_a + min(k, klen - 1) * kTile;
      const float* rb = s_b + min(k, klen - 1) * kTile;
      x0 = *reinterpret_cast<const float4*>(ra + ty * 4);
      x1 = *reinterpret_cast<const float4*>(ra + 64 + ty * 4);
      y0 = *reinterpret_cast<const float4*>(rb + tx * 4);
      y1 = *reinterpret_cast<const float4*>(rb + 64 + tx * 4);
    };
    fetch(0, a0, a1, b0, b1);
    auto step = [&](int k) {
      float4 n0, n1, m0, m1;
      fetch(k + 1, n0, n1, m0, m1);
"""
AHEAD_TAIL = ("        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);\n    };",
              "        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);\n"
              "      a0 = n0; a1 = n1; b0 = m0; b1 = m1;\n    };")
VARIANTS = {
    "committed": [],
    "4 waves": [("kWaves = 16;", "kWaves = 4;")],
    "64 waves": [("kWaves = 16;", "kWaves = 64;")],
    "no register cap": [UNCAPPED],
    "operands a step ahead": [(STEP, AHEAD), AHEAD_TAIL],
    "operands a step ahead, no register cap": [(STEP, AHEAD), AHEAD_TAIL, UNCAPPED],
}


def label(entry: str):
    return "match_nearest"


def main() -> int:
    if not torch.cuda.is_available():
        print("match_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from threecrate_tpu_torch.kernels import match

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    inputs = {}
    for run, (q, n, d) in RUNS.items():
        rows = chip_smoke.fpfh_like(max(q, n), gen, dev)
        if d != 33:
            rows = torch.rand((max(q, n), d), generator=gen, device=dev)
        queries = rows[:q] + torch.rand((q, d), generator=gen, device=dev)
        db, valid = rows[:n], torch.rand(n, generator=gen, device=dev) > 0.02
        ldq, ldn = -(-q // 128) * 128, -(-n // 128) * 128
        inputs[run] = (q, ldq, ldn, d, match._layout(queries, ldq),
                       match._norms(queries, None, ldq), match._layout(db, ldn),
                       match._norms(db, valid, ldn))
    out = torch.empty(max(q for q, _, _ in RUNS.values()), dtype=torch.int64, device=dev)

    def launch(lib, run):
        q, ldq, ldn, d, at, qn, bt, pn = inputs[run]
        out[:q].fill_(match.SENTINEL)
        err = lib.tc_match_nearest(at.data_ptr(), qn.data_ptr(), bt.data_ptr(), pn.data_ptr(),
                                   out.data_ptr(), q, ldq, ldn, d,
                                   torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "match.cu", VARIANTS, ("tc_match_nearest",),
                                     label)
        report = kernel_variants.compare_and_time(libs, list(inputs), launch, out)
    return kernel_variants.print_report(card, report, runs=RUNS)


if __name__ == "__main__":
    sys.exit(main())
