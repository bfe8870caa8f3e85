#!/usr/bin/env python3
"""Time design variants of the ICP correspondence kernel on one card.

    python3 tools/icp_match_variants.py

Each variant is ``threecrate_tpu_torch/csrc/icp_match.cu`` with one
design choice of the records body changed by a text substitution: 2 or
4 points a thread instead of 1, no culling, and the chunks swept from
the window's middle tile on, or in column order, instead of by their
box distance to the warp's centroid. Each is built and timed
as ``tools/kernel_variants.py`` says, launched through its
``tc_icp_match`` on the phase-3 inputs of ``chip_smoke.py``: the 1M
scan's target Morton-sorted with sentinels, the shifted source sorted in
its frame, tile 128, w_tiles 3, at E = 0 and E = 3 payload rows. Every
variant's rows must equal the committed source's on every point. The
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

TILE, W_TILES, EXTRAS = 128, 3, (0, 3)
VARIANTS = {
    "committed": [],
    "2 points a thread": [("kIcpQueries = 1;", "kIcpQueries = 2;")],
    "4 points a thread": [("kIcpQueries = 1;", "kIcpQueries = 4;")],
    "no culling": [("    if (cull) {\n", "    if (false) {\n")],
    "middle tile first": [("kWarpOrder = true;", "kWarpOrder = false;")],
    "column-order sweep": [("kWarpOrder = true;", "kWarpOrder = false;"),
                           ("const int ch0 = ((w_tiles - 1) / 2) * tile / kChunk;",
                            "const int ch0 = 0;")],
}


def label(entry: str):
    """The body of an icp_match kernel entry."""
    return "rows" if "rows_kernel" in entry else "records"


def main() -> int:
    if not torch.cuda.is_available():
        print("icp_match_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    inputs = {f"E={e}": chip_smoke.icp_inputs(dev, e, W_TILES, TILE) for e in EXTRAS}
    ns = inputs["E=0"][0].shape[1]
    out = torch.empty((4 + max(EXTRAS), ns), device=dev)

    def launch(lib, run):
        src, tgt, blk = inputs[run]
        rows = tgt.shape[0]
        err = lib.tc_icp_match(src.data_ptr(), tgt.data_ptr(), blk.data_ptr(), out.data_ptr(),
                               ns, tgt.shape[1], rows, TILE, W_TILES,
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "icp_match.cu", VARIANTS, ("tc_icp_match",),
                                     label)
        report = kernel_variants.compare_and_time(libs, list(inputs), launch, out)
    return kernel_variants.print_report(card, report, tile=TILE, w_tiles=W_TILES, n=ns)


if __name__ == "__main__":
    sys.exit(main())
