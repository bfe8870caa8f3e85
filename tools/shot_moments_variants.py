#!/usr/bin/env python3
"""Time design variants of the SHOT/USC moment kernels on one card.

    python3 tools/shot_moments_variants.py [--parent DIR]

Each variant is ``threecrate_tpu_torch/csrc/shot.cu`` with one design
choice of the moment kernels changed by a text substitution: 256 threads
a block instead of 128, per-lane masks of 32 offsets (the body looped
over each lane's set bits, so a warp pays its busiest lane's count
rather than every offset where any lane selects), two adjacent queries a
thread (one record read serves both; uncapped), the candidates read
through L1 instead of staged in shared memory, the first port's kernel
(uncapped, as it was), no
register cap and caps of 64 and 32 instead of 40 (1, 8 and 16 blocks an
SM instead of 12), pass B placed by scattering
into (14, N) columns instead of 64-byte query-major rows, and a probe
whose body only counts. Each is built and timed as
``tools/kernel_variants.py`` says, launched through ``tc_shot_moments_a``
/ ``tc_shot_moments_b`` on the phase-3 inputs of ``chip_smoke.py`` (the
1M registration target sorted twice; r = 0.25, band 32, tile 256):
each pass alone, pass B placed at each position's pass-A row, and pass A
adding those rows (``plus``), as ``_shot_fused`` runs them. Against the
committed source's output: the count row bit-equal and every sum within
1e-5 of Σw·R^k (the bits are reported too); the placed modes through the
merged (14, N) rows, each variant's pass A reading its own pass B's
placement.

With ``--parent DIR`` (an unpacked tree of another commit), the host
syncs of one default ``extract_shot_features`` and
``extract_usc_features`` call on the 1M registration target, the index
kernels (gathers and scatters) in its device profile and the moment
kernels' device times there are counted for that tree's package and for
this one, each in a process of its own.

The last line is one JSON object with the card and every number. Needs
one CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

_SRC = (kernel_variants.CSRC / "shot.cu").read_text()
# the committed kernel's sweep of a query's candidates
_SWEEP = """#pragma unroll 4
  for (int k = 0; k <= 2 * band; ++k) {
    float dx, dy, dz, d2;
    if (moment_candidate<kPassB>(record(t + k), qx, qy, qz, q_pa, band_f, r2, dx, dy, dz,
                                 d2)) {
      add_moments(acc, dx, dy, dz, d2, radius);
    }
  }
"""
MASK_SWEEP = """  // a lane tests 32 offsets into a mask, then runs the body over its set
  // bits in ascending order: the warp pays its busiest lane's count
  const int width = 2 * band + 1;
  for (int k0 = 0; k0 < width; k0 += 32) {
    unsigned mask = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (k0 + 32 <= width || k0 + i < width) {
        float dx, dy, dz, d2;
        mask |= static_cast<unsigned>(moment_candidate<kPassB>(
                    record(t + k0 + i), qx, qy, qz, q_pa, band_f, r2, dx, dy, dz, d2))
                << i;
      }
    }
    while (mask != 0u) {
      const int i = __ffs(mask) - 1;
      mask &= mask - 1u;
      float dx, dy, dz, d2;
      moment_candidate<kPassB>(record(t + k0 + i), qx, qy, qz, q_pa, band_f, r2, dx, dy, dz,
                               d2);
      add_moments(acc, dx, dy, dz, d2, radius);
    }
  }
"""
# the committed kernel's body from its first query to its rows
_BODY = _SRC[_SRC.index("  const int q0 = static_cast<int>(blockIdx.x) * kMomentQueries;\n"):
             _SRC.index("\n}\n\n// One SHOT/USC vote")]
PAIR_BODY = """  // two adjacent queries a thread: one record read serves offset k of the
  // first and k - 1 of the second
  constexpr int kPer = 2;
  const int q0 = static_cast<int>(blockIdx.x) * kMomentQueries * kPer;
  if (kStage) {
    stage_span<kPassB>(packed, n, q0 - band, kMomentQueries * kPer + 2 * band, kPosRow, recs,
                       nullptr);
    __syncthreads();
  }
  const int base = kPer * static_cast<int>(threadIdx.x);
  const int p0 = q0 + base;
  if (p0 >= n) return;
  const auto record = [&](int i) {
    return kStage ? recs[i]
                  : column_record<kPassB>(packed, nl, static_cast<long>(q0) - band + i,
                                          kPosRow);
  };
  const float band_f = static_cast<float>(band);
  const int width = 2 * band + 1;
  float qx[kPer], qy[kPer], qz[kPer], q_pa[kPer], acc[kPer][kMoments];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = min(p0 + j, n - 1);
    qx[j] = packed[p], qy[j] = packed[nl + p], qz[j] = packed[2 * nl + p];
    q_pa[j] = kPassB ? packed[kPosRow * nl + p] : 0.f;
#pragma unroll
    for (int m = 0; m < kMoments; ++m) acc[j][m] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < width + kPer - 1; ++k) {
    const float4 c = record(base + k);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      float dx, dy, dz, d2;
      if (k >= j && k - j < width &&
          moment_candidate<kPassB>(c, qx[j], qy[j], qz[j], q_pa[j], band_f, r2, dx, dy, dz,
                                   d2)) {
        add_moments(acc[j], dx, dy, dz, d2, radius);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j;
    if (p >= n) break;
    if (!kPassB && plus != nullptr) add_plus(plus, p, acc[j]);
    if (kPassB && rows != nullptr) {
      store_placed(out, rows[p], acc[j]);
    } else {
#pragma unroll
      for (int m = 0; m < kMoments; ++m) out[m * nl + p] = acc[j][m];
    }
  }"""
# the first port's kernel (before the redesign): each thread reads its
# candidates' rows straight from device memory, validity first
PARENT_BODY = """  const int p = static_cast<int>(blockIdx.x) * kMomentQueries + static_cast<int>(threadIdx.x);
  if (p >= n) return;
  const float qx = packed[p], qy = packed[nl + p], qz = packed[2 * nl + p];
  const float q_pa = kPassB ? packed[4 * nl + p] : 0.f;
  const float band_f = static_cast<float>(band);
  float acc[kMoments];
#pragma unroll
  for (int m = 0; m < kMoments; ++m) acc[m] = 0.f;
  const int lo = max(p - band, 0);
  const int hi = min(p + band, n - 1);
  for (int c = lo; c <= hi; ++c) {
    if (!(packed[3 * nl + c] > 0.5f)) continue;
    if (kPassB && !(fabsf(__fsub_rn(packed[4 * nl + c], q_pa)) > band_f)) continue;
    const float dx = __fsub_rn(packed[c], qx);
    const float dy = __fsub_rn(packed[nl + c], qy);
    const float dz = __fsub_rn(packed[2 * nl + c], qz);
    const float d2 = dot3(dx, dy, dz, dx, dy, dz);
    if (d2 <= r2 && d2 > 1e-18f) add_moments(acc, dx, dy, dz, d2, radius);
  }
  if (!kPassB && plus != nullptr) add_plus(plus, p, acc);
  if (kPassB && rows != nullptr) {
    store_placed(out, rows[p], acc);
  } else {
#pragma unroll
    for (int m = 0; m < kMoments; ++m) out[m * nl + p] = acc[m];
  }"""
_CAP = "kMomentMinBlocks = 12;"   # the committed cap's text
VARIANTS = {
    "committed": [],
    "the parent's kernel": [(_BODY, PARENT_BODY), ("kMomentStage = true;",
                                                   "kMomentStage = false;"),
                            (_CAP, "kMomentMinBlocks = 1;")],
    # the same 40-register cap at 256 threads (6 blocks an SM)
    "256 threads": [("kMomentQueries = 128;", "kMomentQueries = 256;"),
                    (_CAP, "kMomentMinBlocks = 6;")],
    "per-lane masks": [(_SWEEP, MASK_SWEEP)],
    "two queries a thread": [
        (_BODY, PAIR_BODY),
        ("const int blocks = (n + kMomentQueries - 1) / kMomentQueries;",
         "const int blocks = (n + 2 * kMomentQueries - 1) / (2 * kMomentQueries);"),
        ("sizeof(float4) * (kMomentQueries + 2 *", "sizeof(float4) * (2 * kMomentQueries + 2 *"),
        (_CAP, "kMomentMinBlocks = 1;")],   # its 28 accumulators do not fit 40
    "read through L1": [("kMomentStage = true;", "kMomentStage = false;")],
    "no register cap": [(_CAP, "kMomentMinBlocks = 1;")],
    "cap 64 registers": [(_CAP, "kMomentMinBlocks = 8;")],
    "cap 32 registers": [(_CAP, "kMomentMinBlocks = 16;")],
    "placed as (14, n) columns": [
        ("store_placed(out, rows[p], acc);",
         "for (int m = 0; m < kMoments; ++m) out[m * nl + rows[p]] = acc[m];"),
        ("add_plus(plus, p, acc);",
         "for (int m = 0; m < kMoments; ++m) acc[m] = __fadd_rn(acc[m], plus[m * nl + p]);")],
    kernel_variants.PROBE + "count only": [("add_moments(acc, dx, dy, dz, d2, radius);",
                                           "acc[10] += 1.f;")],
}
RUNS = ("a", "b", "b placed", "a plus")

# counted in a process of its own for each tree: host syncs of one call
# (chip_smoke.host_syncs of this tree) and the index kernels of its
# device profile, for SHOT and USC at their defaults on the 1M target
_COUNT = """
import importlib.util, json, sys
sys.path.insert(0, {tree!r})
spec = importlib.util.spec_from_file_location("cs", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import threecrate_tpu_torch as tt
from threecrate_tpu_torch.utils.profiling import device_profile
assert tt.__file__.startswith({tree!r}), tt.__file__
_, tgt, _ = cs.registration_pair()
pc = tt.PointCloud.from_numpy(tgt, device="cuda")
out = {{}}
for fn in (tt.extract_shot_features, tt.extract_usc_features):
    wall, busy, entries = device_profile(lambda fn=fn: fn(pc), top=1000)
    index = [(ms, c) for name, ms, c in entries if "index" in name.lower()]
    out[fn.__name__] = {{"host_syncs": cs.host_syncs(lambda fn=fn: fn(pc)),
                        "index_launches": sum(c for _, c in index),
                        "index_ms": sum(ms for ms, _ in index), "busy_ms": busy,
                        "moments_ms": [ms for name, ms, _ in entries
                                       if "shot_moments_kernel" in name]}}
print(json.dumps(out))
"""


def label(entry: str):
    """The pass and access of a moments kernel entry, None for others."""
    if "shot_moments_kernel" not in entry:
        return None
    # template arguments <kPassB, kStage> appear mangled as Lb0/Lb1
    pass_b, stage = (c == "1" for c in
                     [c for c in entry.split("shot_moments_kernel")[1] if c in "01"][:2])
    return f"moments {'b' if pass_b else 'a'}{' staged' if stage else ''}"


def tree_counts(tree: Path):
    """The host syncs and index kernels of SHOT and USC (``_COUNT``) with
    the package of ``tree``."""
    smoke = kernel_variants.ROOT / "chip_smoke.py"
    proc = subprocess.run([sys.executable, "-c", _COUNT.format(tree=str(tree),
                                                              smoke=str(smoke))],
                          cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"counting in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="an unpacked tree to count syncs of")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("shot_moments_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from threecrate_tpu_torch.kernels import shot
    from threecrate_tpu_torch.kernels.fpfh import _r2_f32

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    r2, band, tile = chip_smoke.SHOT_RADIUS ** 2, chip_smoke.SHOT_BAND, chip_smoke.FPFH_TILE
    pa, pb, pos_b, _ = chip_smoke.fpfh_inputs(dev)
    packed, rows = chip_smoke.shot_moment_inputs(pa, pb, pos_b)
    del pa, pb, pos_b
    n = rows.shape[0]
    out = torch.empty((shot.N_MOMENTS, n), device=dev)
    placed = torch.empty((n, shot.MOMENT_ROW), device=dev)   # either layout fits
    radius = shot._radius_f32(r2)

    def launch(lib, run):
        # "b placed" writes the variant's placement, which its "a plus"
        # (the next run) reads: out holds the passes alone and the merge
        if run.startswith("a"):
            err = lib.tc_shot_moments_a(
                packed["shot_moments_a"].data_ptr(),
                placed.data_ptr() if run == "a plus" else None, out.data_ptr(), n, band,
                _r2_f32(r2), radius, torch.cuda.current_stream().cuda_stream)
        else:
            err = lib.tc_shot_moments_b(
                packed["shot_moments_b"].data_ptr(),
                placed.data_ptr() if run == "b placed" else out.data_ptr(),
                rows.data_ptr() if run == "b placed" else None, n, band, _r2_f32(r2),
                radius, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    bits = {}

    def same(run, got, ref):
        cnt_eq, rel = chip_smoke.moment_agreement(got, ref)
        bits.setdefault(run, []).append(torch.equal(got, ref))
        return cnt_eq and rel <= chip_smoke.SHOT_REL_TOL

    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "shot.cu", VARIANTS,
                                     ("tc_shot_moments_a", "tc_shot_moments_b"), label)
        report = kernel_variants.compare_and_time(libs, list(RUNS), launch, out, same)
    for i, name in enumerate(report):       # compared variant by variant, in order
        report[name]["bit_equal_committed"] = [bits[run][i] for run in RUNS]
    meta = dict(r=chip_smoke.SHOT_RADIUS, band=band, tile=tile, n=n)
    if opts.parent is not None:
        del packed, rows, out, placed
        torch.cuda.empty_cache()
        meta["counts"] = {"this tree": tree_counts(kernel_variants.ROOT),
                          "parent": tree_counts(opts.parent.resolve())}
        print(f"host syncs and index kernels: {json.dumps(meta['counts'])}", flush=True)
    return kernel_variants.print_report(card, report, **meta)


if __name__ == "__main__":
    sys.exit(main())
