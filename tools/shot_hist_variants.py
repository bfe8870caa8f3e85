#!/usr/bin/env python3
"""Time design variants of the SHOT/USC histogram kernels on one card.

    python3 tools/shot_hist_variants.py

Each variant is ``threecrate_tpu_torch/csrc/shot.cu`` with one design
choice of the histogram kernels changed by a text substitution: 8 or 32
lanes a SHOT query instead of 16, 16 or 32 lanes a USC query instead of
8 (the queries a warp follow), the candidates read through L1 instead
of staged in shared memory, 2, 8 or 16 warps a block instead of 4, and
in add mode the rows added to read at the end instead of copied into
shared memory (``cp.async``) while the warp votes, and the rows stored
with streaming (``__stcs``) or write-through (``__stwt``) stores. Each is built and timed as
``tools/kernel_variants.py`` says, launched through ``tc_shot_hist_a`` /
``tc_shot_hist_b`` on the phase-3 inputs of ``chip_smoke.py`` (the 1M
registration target sorted twice, frames from its moments; r = 0.25,
band 32, tile 256) as ``_shot_fused`` runs them: pass B written at each
position's input row, pass A added at its own, and pass A alone at rows
0 … N−1, for SHOT and USC. Against the committed source's rows: USC bit
for bit, and where the lanes a query change (the SHOT vote order with
them), the SHOT count column bit-equal and every vote within 1e-5 of
its query's count; bit for bit otherwise. The last line is one JSON
object with the card and every variant's numbers. An earlier source is
timed by running ``chip_smoke.py`` from a ``git archive`` of it beside
one of this tree, in one call. Needs one CUDA card and ``nvcc``; exits
non-zero without them.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

# the row store of the histogram kernels
_STORE = "dst[j] = accumulate ? __fadd_rn(prefetch ? old[j] : dst[j], src[j]) : src[j];"
VARIANTS = {
    "committed": [],
    "SHOT 8 lanes": [("kShotGroup = 16;", "kShotGroup = 8;")],
    "SHOT 32 lanes": [("kShotGroup = 16;", "kShotGroup = 32;")],
    "USC 16 lanes": [("kUscGroup = 8;", "kUscGroup = 16;")],
    "USC 32 lanes": [("kUscGroup = 8;", "kUscGroup = 32;")],
    "read through L1": [("kHistStage = true;", "kHistStage = false;")],
    "2 warps a block": [("kHistWarps = 4;", "kHistWarps = 2;")],
    "8 warps a block": [("kHistWarps = 4;", "kHistWarps = 8;")],
    "16 warps a block": [("kHistWarps = 4;", "kHistWarps = 16;")],
    "no prefetch": [("kHistPrefetch = true;", "kHistPrefetch = false;")],
    "streaming stores": [(_STORE, _STORE.replace("dst[j] = ", "__stcs(dst + j, ")[:-1] + ");")],
    "write-through stores": [(_STORE,
                              _STORE.replace("dst[j] = ", "__stwt(dst + j, ")[:-1] + ");")],
}
# (variant, pass, mode) of each timed run; mode "write" places at the
# pass's input rows, "add" adds there, "alone" writes rows 0 … N−1
RUNS = {f"{v} {p} {m}": (v, p, m) for v in ("shot", "usc")
        for p, m in (("b", "write"), ("a", "add"), ("a", "alone"))}
DIM = {"shot": 352, "usc": 128}


def rows_of(buf, variant):
    """The (N, dim + 1) query-major rows of ``variant`` at the start of
    the shared buffer ``buf``."""
    n = buf.shape[0]
    return buf.view(-1)[:n * (DIM[variant] + 1)].view(n, DIM[variant] + 1)


def label(entry: str):
    """The pass and variant of a histogram kernel entry, None for others."""
    if "shot_hist_kernel" not in entry:
        return None
    # template arguments <kPassB, kUsc, kStage> appear mangled as Lb0/Lb1
    flags = [c for c in entry.split("shot_hist_kernel")[1] if c in "01"][:3]
    pass_b, usc, stage = (f == "1" for f in flags)
    return (f"hist {'b' if pass_b else 'a'} {'usc' if usc else 'shot'}"
            f"{' staged' if stage else ''}")


def main() -> int:
    if not torch.cuda.is_available():
        print("shot_hist_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from threecrate_tpu_torch.kernels import shot
    from threecrate_tpu_torch.kernels.fpfh import _r2_f32

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    r2, band, tile = chip_smoke.SHOT_RADIUS ** 2, chip_smoke.SHOT_BAND, chip_smoke.FPFH_TILE
    pa, pb, pos_b, perm_a = chip_smoke.fpfh_inputs(dev)
    _, mom = chip_smoke.merged_moments("tiles", *chip_smoke.shot_moment_inputs(pa, pb, pos_b))
    args, rows = chip_smoke.shot_hist_inputs(pa, pb, pos_b, perm_a, mom)
    del mom
    n = pa.shape[1]
    out = torch.empty((n, DIM["shot"] + 1), device=dev)
    inv_r = shot._inv_radius_f32(r2)

    def launch(lib, run):
        variant, pass_, mode = RUNS[run]
        kname = f"shot_hist_{pass_}"
        packed, frames = args[kname]
        dest = rows_of(out, variant)
        err = getattr(lib, "tc_" + kname)(
            packed.data_ptr(), frames.data_ptr(), dest.data_ptr(),
            None if mode == "alone" else rows[kname].data_ptr(), n, band, _r2_f32(r2),
            inv_r, int(variant == "usc"), int(mode == "add"),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    def same(run, got, ref):
        variant = RUNS[run][0]
        g, r = rows_of(got, variant), rows_of(ref, variant)
        if variant == "usc":
            return torch.equal(g, r)
        cnt_eq, _, vote = chip_smoke.hist_agreement(g, r, DIM[variant])
        return cnt_eq and vote <= chip_smoke.SHOT_REL_TOL

    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "shot.cu", VARIANTS,
                                     ("tc_shot_hist_a", "tc_shot_hist_b"), label)
        report = kernel_variants.compare_and_time(libs, list(RUNS), launch, out, same)
    return kernel_variants.print_report(card, report, r=chip_smoke.SHOT_RADIUS, band=band,
                                        tile=tile, n=n)


if __name__ == "__main__":
    sys.exit(main())
