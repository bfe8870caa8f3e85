#!/usr/bin/env python3
"""Time design variants of the banded SPFH kernels on one card.

    python3 tools/spfh_band_variants.py

Each variant is ``threecrate_tpu_torch/csrc/fpfh.cu`` with one design
choice of the banded stage-1 kernel changed by a text substitution: 1,
2, 4 or 16 offsets a step instead of 8; per-lane masks of 32 offsets
appended lane after lane through a shuffle prefix; bound checks in every
step, not only the last; 8-bit vote counters (4 a word; a count is at
most 2 * band + 1 < 255 on every rung of the ladder, 16-64); a
column-major sweep over the warp's 32 + 2 * band span columns past the
16-column chunks whose box lies beyond r2 for all its queries; 128
threads a block; no register cap, or 5 or 6 blocks an SM; 1/sqrt as
``__frcp_rn`` of the root (the same bits); and the parent's kernel (one
query a thread over three staged 7-8-row segments, voting at every
offset where it selects). Three probes leave out part of the work to
time the rest (their rows differ): no votes (the drains only advance the
ring), no atomics (racing adds) and no pair features (a stand-in bin).
Each is built and timed as ``tools/kernel_variants.py`` says, launched
through its ``tc_spfh_band_a`` and ``tc_spfh_band_b`` on the phase-3
inputs of ``chip_smoke.py``: the registration target's 1M sorted points
with the port's normals, tile 256, r = 0.25, at band 48 (the rung the
default FPFH resolves there) and 16. Every variant's 34 rows must equal
the committed source's on every query. The last line is one JSON object
with the card and every variant's numbers. An earlier source is timed
by running ``chip_smoke.py`` from a ``git archive`` of it beside one of
this tree, in one call. Needs one CUDA card and ``nvcc``; exits non-zero
without them.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import kernel_variants

TILE, RADIUS, BANDS = 256, 0.25, (48, 16)
# the committed kernel's sweep, and the pointers, staging and
# shared-memory size that the culled sweep extends
SWEEP = ("    // the query's span columns qi",
         "    drain<kBandQueue>(pq, static_cast<int>(pq.tail - pq.head)")
POINTERS = "  unsigned* votes = reinterpret_cast<unsigned*>(nrm + span);\n"
STAGED = "  stage_span<kPassB>(packed, n, tile, band, win, nrm);\n  __syncthreads();\n"
SMEM = "      2 * static_cast<size_t>(tile + 2 * band) * sizeof(float4) +\n"
BOX_POINTERS = '''  float4* box = nrm + span;
  unsigned* votes = reinterpret_cast<unsigned*>(box + 2 * tc::n_chunks(span, kSpfhChunk));
'''
BOX_STAGED = STAGED + '''  for (int ch = threadIdx.x; ch * kSpfhChunk < span; ch += blockDim.x) {
    float4 lo = make_float4(tc::kInf, tc::kInf, tc::kInf, 0.f);
    float4 hi = make_float4(-tc::kInf, -tc::kInf, -tc::kInf, 0.f);
    for (int c = ch * kSpfhChunk; c < min(ch * kSpfhChunk + kSpfhChunk, span); ++c) {
      const float4 b = win[c];
      if (b.w != b.w) continue;  // not valid: never selected
      lo = make_float4(fminf(lo.x, b.x), fminf(lo.y, b.y), fminf(lo.z, b.z), 0.f);
      hi = make_float4(fmaxf(hi.x, b.x), fmaxf(hi.y, b.y), fmaxf(hi.z, b.z), 0.f);
    }
    box[2 * ch] = lo;
    box[2 * ch + 1] = hi;
  }
  __syncthreads();
'''
BOX_SMEM = ("      (2 * static_cast<size_t>(tile + 2 * band) +\n"
            "       2 * tc::n_chunks(tile + 2 * band, kSpfhChunk)) * sizeof(float4) +\n")
MASK_SWEEP = '''    // kWarp offsets at a time: lane l tests span columns qi + j0 ... (its
    // query's offsets j0 - band ...), the warp's 32 lanes 32 consecutive
    // records a step, and keeps its selections as bits of a mask
    for (int j0 = 0; j0 <= 2 * band; j0 += kWarp) {
      const int steps = min(kWarp, 2 * band + 1 - j0);
      unsigned mask = 0u;
#pragma unroll 4
      for (int k = 0; k < steps; ++k) {
        const float4 b = win[qi + j0 + k];
        const float d2 = tc::sq_dist(q.x, q.y, q.z, b.x, b.y, b.z);
        const bool cand = kPassB ? fabsf(__fsub_rn(b.w, q_pa)) > band_f : b.w == 0.f;
        mask |= static_cast<unsigned>(cand && d2 <= r2 && d2 > 1e-12f) << k;
      }
      if (!active) mask = 0u;
      queue_mask(pq, mask, (qi + j0) * kWarp + lane, win, nrm, self0, th_scale);
    }
'''
# the queue of the mask sweep, ahead of the kernel
QUEUE_MASK = '''// Append a lane's selections (bit k of mask: ring entry e0 + k * kWarp)
// to the warp's ring, lane after lane (an exclusive prefix sum of the
// lanes' counts gives each its first position), and drain a warp of
// pairs whenever the ring holds that many. A lane writes an entry only
// where the ring has room (position - head < kBandQueue), so the writes and
// drains take turns until fewer than a warp of pairs are left.
__device__ __forceinline__ void queue_mask(PairQueue& pq, unsigned mask, int e0,
                                           const float4* __restrict__ win,
                                           const float4* __restrict__ nrm, int self0,
                                           float th_scale) {
  const int lane = threadIdx.x % kWarp;
  const int own = __popc(mask);
  int incl = own;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int t = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += t;
  }
  unsigned pos = pq.tail + static_cast<unsigned>(incl - own);
  pq.tail += static_cast<unsigned>(__shfl_sync(~0u, incl, kWarp - 1));
  for (;;) {
    for (; mask != 0u && pos - pq.head < kBandQueue; ++pos, mask &= mask - 1u) {
      pq.ring[pos % kBandQueue] = e0 + (__ffs(mask) - 1) * kWarp;
    }
    if (pq.tail - pq.head < kWarp) return;
    drain<kBandQueue>(pq, kWarp, win, nrm, self0, th_scale);
  }
}

'''
BOX_SWEEP = '''    // column by column over the warp's span, past the chunks beyond r2
    // for all its queries; a lane selects only its query's +-band columns
    const unsigned below = (1u << lane) - 1u;
    const int w0 = base + warp * kWarp;
    const int w1 = min(w0 + kWarp + 2 * band, span);
    for (int c0 = w0; c0 < w1; c0 += kSpfhChunk) {
      const bool beyond =
          !active || tc::chunk_beyond<false>(box, c0 / kSpfhChunk, q.x, q.y, q.z, r2);
      if (__all_sync(~0u, beyond)) continue;
      for (int c = c0; c < min(c0 + kSpfhChunk, w1); ++c) {
        const float4 b = win[c];
        const float d2 = tc::sq_dist(q.x, q.y, q.z, b.x, b.y, b.z);
        const bool cand = kPassB ? fabsf(__fsub_rn(b.w, q_pa)) > band_f : b.w == 0.f;
        const bool sel = active && static_cast<unsigned>(c - qi) <= 2u * band && cand &&
                         d2 <= r2 && d2 > 1e-12f;
        const unsigned ballot = __ballot_sync(~0u, sel);
        if (ballot == 0u) continue;
        if (sel) pq.ring[(pq.tail + __popc(ballot & below)) % kBandQueue] = c * kWarp + lane;
        pq.tail += __popc(ballot);
        if (pq.tail - pq.head >= kWarp) drain<kBandQueue>(pq, kWarp, win, nrm, self0, th_scale);
      }
    }
'''
# the sweep's full steps, without and with the checks of the last step
FULL_STEPS = ("    for (; c0 + kBandSteps - 1 <= last; c0 += kBandSteps) {\n"
              "      band_step<kPassB, true>(")
CHECKED_STEPS = ("    for (; c0 + kBandSteps - 1 <= last; c0 += kBandSteps) {\n"
                 "      band_step<kPassB, false>(")
# probes, timed but not equal to the committed rows: the drains only
# advance the ring (no pair is voted), the votes added without atomics
# (racing lanes lose some), the bins of a pair a stand-in of its columns
DRAIN_CALL = ("  while (pq.tail - pq.head >= kWarp) drain<kBandQueue>(pq, kWarp, win, nrm, self0,"
              " th_scale);\n")
SKIP_DRAIN = ("  while (pq.tail - pq.head >= kWarp) {\n    __syncwarp();\n"
              "    pq.head += kWarp;\n  }\n")
LAST_DRAIN = ("    drain<kBandQueue>(pq, static_cast<int>(pq.tail - pq.head), win, nrm, self0,"
              " th_scale);\n")
SKIP_LAST_DRAIN = "    __syncwarp();\n"
ATOMIC = ("  atomicAdd(&votes[bin / kVotesPerWord * kVoteStride + lane],\n"
          "            1u << (kVoteBits * (bin % kVotesPerWord)));")
PLAIN_ADD = ("  votes[bin / kVotesPerWord * kVoteStride + lane] +=\n"
             "      1u << (kVoteBits * (bin % kVotesPerWord));")
PAIR_BINS = ("    const int3 bins = pair_bins(dx, dy, dz, dot3(dx, dy, dz, dx, dy, dz),\n"
             "                                QueryFrame{qn.x, qn.y, qn.z, th_scale, 0.5f * kBins}, cn.x,\n"
             "                                cn.y, cn.z);\n")
FAKE_BINS = ("    const int bin0 = static_cast<int>(dx + dy + dz + qn.x + cn.x) & 7;\n"
             "    const int3 bins = make_int3(bin0, kBins + bin0, 2 * kBins + bin0);\n")
KERNEL_HEAD = "template <bool kPassB>\n__global__ void __launch_bounds__(kBandThreads, kBandBlocks)"
# the committed banded kernel and its launch
KERNEL = ("// Banded stage 1 (spfh_band_a/b, _spfh_band_body)",
          "// ---------------------------------------------------------------------------\n"
          "// Stage 2")
PARENT = r'''// The parent's banded kernel: a block of tile threads, one query a
// thread, stages the prev, self and next tiles' 7-8 rows in turn and votes
// each selected neighbour inline into an int histogram (33, tile).
__device__ __forceinline__ void load_segment(const float* __restrict__ packed, int n, int rows,
                                             int ct, float* seg) {
  const int tile = blockDim.x;
  const long col = static_cast<long>(ct) * tile + threadIdx.x;
  for (int r = 0; r < rows; ++r) seg[r * tile + threadIdx.x] = packed[r * static_cast<long>(n) + col];
}

template <bool kPassB>
__global__ void spfh_band_kernel(const float* __restrict__ packed,
                                 float* __restrict__ out, int n, int band, float r2) {
  constexpr int kRows = kPassB ? 8 : 7;
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int i = threadIdx.x;
  const int n_t = n / tile;
  float* seg = smem;
  int* hist = reinterpret_cast<int*>(smem + 8 * tile);
  const long col = static_cast<long>(blockIdx.x) * tile + i;
  const float qx = packed[col], qy = packed[n + col], qz = packed[2L * n + col];
  const float q_pa = kPassB ? packed[7L * n + col] : 0.f;
  const float band_f = static_cast<float>(band);
  const QueryFrame f{packed[4L * n + col], packed[5L * n + col], packed[6L * n + col],
                     theta_scale(), 0.5f * kBins};
  for (int b = 0; b < kHist; ++b) hist[b * tile + i] = 0;
  int cnt = 0;
  for (int s = 0; s < 3; ++s) {
    const int ct = static_cast<int>(blockIdx.x) - 1 + s;
    if (ct < 0 || ct >= n_t) continue;
    __syncthreads();
    load_segment(packed, n, kRows, ct, seg);
    __syncthreads();
    const int lo = max(0, i - band + (1 - s) * tile);
    const int hi = min(tile - 1, i + band + (1 - s) * tile);
    for (int c = lo; c <= hi; ++c) {
      if (!(seg[3 * tile + c] > 0.5f)) continue;
      if (kPassB && !(fabsf(__fsub_rn(seg[7 * tile + c], q_pa)) > band_f)) continue;
      const float dx = __fsub_rn(seg[c], qx);
      const float dy = __fsub_rn(seg[tile + c], qy);
      const float dz = __fsub_rn(seg[2 * tile + c], qz);
      const float d2 = dot3(dx, dy, dz, dx, dy, dz);
      if (!(d2 <= r2 && d2 > 1e-12f)) continue;
      const int3 b = pair_bins(dx, dy, dz, d2, f, seg[4 * tile + c], seg[5 * tile + c],
                               seg[6 * tile + c]);
      ++hist[b.x * tile + i];
      ++hist[b.y * tile + i];
      ++hist[b.z * tile + i];
      ++cnt;
    }
  }
  for (int b = 0; b < kHist; ++b) {
    out[b * static_cast<long>(n) + col] = static_cast<float>(hist[b * tile + i]);
  }
  out[kHist * static_cast<long>(n) + col] = static_cast<float>(cnt);
}

template <bool kPassB>
cudaError_t launch_band(const float* packed, float* out, int n, int tile, int band, float r2,
                        void* stream) {
  const size_t smem = static_cast<size_t>(8 + kHist) * tile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spfh_band_kernel<kPassB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  spfh_band_kernel<kPassB><<<n / tile, tile, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, out, n, band, r2);
  return cudaGetLastError();
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
    mask = [(_region(source, SWEEP), MASK_SWEEP), (KERNEL_HEAD, QUEUE_MASK + KERNEL_HEAD)]
    return {
        "committed": [],
        "masks of 32 offsets": mask,
        "bound checks at every step": [(FULL_STEPS, CHECKED_STEPS)],
        "one offset a step": [("kBandSteps = 8;", "kBandSteps = 1;"),
                              ("kBandQueue = 512;", "kBandQueue = 64;")],
        "two offsets a step": [("kBandSteps = 8;", "kBandSteps = 2;"),
                               ("kBandQueue = 512;", "kBandQueue = 128;")],
        "four offsets a step": [("kBandSteps = 8;", "kBandSteps = 4;"),
                                ("kBandQueue = 512;", "kBandQueue = 256;")],
        "sixteen offsets a step": [("kBandSteps = 8;", "kBandSteps = 16;"),
                                   ("kBandQueue = 512;", "kBandQueue = 1024;")],
        "probe: no votes": [(DRAIN_CALL, SKIP_DRAIN), (LAST_DRAIN, SKIP_LAST_DRAIN)],
        "probe: no atomics": [(ATOMIC, PLAIN_ADD)],
        "probe: no pair features": [(PAIR_BINS, FAKE_BINS)],
        "8-bit vote counters": [("kVotesPerWord = 2;", "kVotesPerWord = 4;")],
        "box culling": [(_region(source, SWEEP), BOX_SWEEP), (POINTERS, BOX_POINTERS),
                        (STAGED, BOX_STAGED), (SMEM, BOX_SMEM)],
        "128 threads": [("kBandThreads = 256;", "kBandThreads = 128;"),
                        ("kBandBlocks = 4;", "kBandBlocks = 8;")],
        "no register cap": [("kBandBlocks = 4;", "kBandBlocks = 1;")],
        "5 blocks an SM": [("kBandBlocks = 4;", "kBandBlocks = 5;")],
        "6 blocks an SM": [("kBandBlocks = 4;", "kBandBlocks = 6;")],
        "1/sqrt by __frcp_rn": [("using tc::rsqrt_rn;", FRCP)],
        "parent kernel": [(_region(source, KERNEL), PARENT)],
    }


def label(entry: str):
    """The pass of a banded kernel entry, else None."""
    if "spfh_band_kernel" not in entry:
        return None
    return "B" if "ILb1E" in entry else "A"


def main() -> int:
    if not torch.cuda.is_available():
        print("spfh_band_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    dev = torch.device("cuda:0")
    pa, pb, pos_b, _ = chip_smoke.fpfh_inputs(dev)
    rows = {"A": pa, "B": torch.cat([pb, pos_b.to(torch.float32)]).contiguous()}
    del pb
    n = pa.shape[1]
    out = torch.empty((34, n), device=dev)
    # timing name -> (pass, band)
    runs = {f"{p} band={b}": (p, b) for b in BANDS for p in ("A", "B")}

    def launch(lib, run):
        pass_, band = runs[run]
        fn = lib.tc_spfh_band_b if pass_ == "B" else lib.tc_spfh_band_a
        # r2 rounded to fp32 by ctypes, as the wrapper does
        err = fn(rows[pass_].data_ptr(), out.data_ptr(), n, TILE, band, RADIUS * RADIUS,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")

    source = (kernel_variants.CSRC / "fpfh.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = kernel_variants.build(Path(tmp), "fpfh.cu", variants(source),
                                     ("tc_spfh_band_a", "tc_spfh_band_b"), label)
        report = kernel_variants.compare_and_time(libs, runs, launch, out)
    print(f"SM clock after timing: {chip_smoke.sm_clock()}", flush=True)
    return kernel_variants.print_report(card, report, tile=TILE, n=n, radius=RADIUS)


if __name__ == "__main__":
    sys.exit(main())
