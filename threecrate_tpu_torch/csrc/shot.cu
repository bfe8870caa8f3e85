// Fused band-window SHOT/USC kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels shot_moments_a_tiles, shot_moments_b_tiles,
// shot_hist_a_tiles and shot_hist_b_tiles of
// threecrate_tpu/kernels/shot_pallas.py (bodies _moments_body and
// _hist_body, with _band_mats and _window_pack). The caller
// (ops/features.py, _shot_fused) Morton-sorts the cloud twice and pads it
// to a multiple of the Pallas tile. The tile only chose which window the
// +-band positions were drawn from: with band <= tile and the edge tiles
// invalidated, the candidates of sorted position p are exactly the
// positions p - band ... p + band that lie in [0, n).
//
// Layout: packed rows (R, n) row-major in sorted order: moments R = 4
// ([x, y, z, valid]) or 5 (pass B: + the pass-A position as fp32);
// histograms R = 7 ([x, y, z, valid, nx, ny, nz]) or 8 (+ posA); the
// query frames lrf (9, n) [x axis (3), y axis (3), z axis (3)]. Outputs:
// moments (14, n) row-major, or pass B placed: each query's 14 sums and
// two zeros as one 64-byte row of out (n_rows, 16) at row rows[p], and
// pass A with each query's pass-B row added (plus, row p of such a
// buffer); histograms query-major, dim + 1 floats a query
// (dim = 352 SHOT, 128 USC, then the count) as one row of out
// (n_rows, dim + 1) at row rows[p] (p where rows is null), written or,
// with accumulate, added to what the row holds. _shot_fused has pass B
// write each query's row at its input row and pass A add to it, so the
// descriptors come out in input order with no gather; pass B of the
// moments writes each query's row at its pass-A position and pass A adds
// it, so the merged moments come out in pass-A order with no gather
// either.
//
// Selection, per candidate: valid & d2 <= r2 & d2 > 1e-18, and in pass B
// |posA_c - posA_q| > band, in fp32 as the Pallas body compares it, on
// every fp32 value of the posA row (negative, fractional or NaN too).
// Both kinds of kernel read a candidate as a (x, y, z, tag) record
// (column_record): tag is NaN where the column is not valid or lies
// outside [0, n), else 0 (pass A) or the column's posA (pass B), so the
// candidate side of the test is tag == 0 or |tag - posA_q| > band, both
// false for NaN. A query's own x, y, z and posA are its column's: every
// query is served, valid or not.
//   moments: one query a thread, the block's span of candidates staged
//            once as 16-byte records (see "The moments" below); w =
//            max(R - |d|, 0) with R = sqrt(r2) rounded to fp32 by the
//            wrapper (jnp.sqrt of the fp32 r2); rows [sum w, sum w*d (3),
//            sum w*d_i*d_j (xx, yy, zz, xy, xz, yz), count, sum w*|d|^2*d
//            (3)] in 14 register accumulators, in candidate order;
//   histograms: the displacement in the query's frame, azimuth from the
//            reproduced _atan2_approx into 8 sectors, 2 elevation halves;
//            SHOT: 2 radial shells (d2 >= r2/4) and the soft vote of
//            cos(candidate normal, query z) into 11 bins (lo with weight
//            1 - frac, lo + 1 with frac; the whole vote at lo = 10); USC:
//            8 radial shells of |d| * rsqrt(r2), one vote each.
//
// Every operation that decides a selection or a bin is rounded on its own
// (the _rn intrinsics keep nvcc from contracting into FMAs) in the order of
// the plain PyTorch versions (kernels/shot.py), so counts and bin ids equal
// theirs: the USC rows bit for bit, the SHOT votes up to summation order,
// which is fixed (lane-ordered rounds, no float atomics), so two calls give
// the same bits.
//
// What bounds the histograms: their output. 353 floats per query and pass
// are 1.41 GB at 1M points, 0.42 ms at 3.35 TB/s (pass A's add reads them
// too), against ~65 candidates of ~60 fp32 operations each. The first
// port gave each query a thread and a 352-float shared column, 90 KB for a
// 64-query block: 4 warps an SM, too few to hide the candidate loads and
// the 353 stores a query. Here kShotGroup (kUscGroup) lanes share a query
// (its 2*band+1 candidates in rounds), a query's histogram is one 1.4 KB
// row of shared memory (11 KB for a 128-thread SHOT block, so occupancy is
// set by registers), the block's candidate span is staged once as 16-byte
// records (kHistStage), a warp stores each row in 128-byte runs, and where
// it adds, the rows it adds to are copied into shared memory (cp.async)
// while it votes (kHistPrefetch).
// tools/shot_hist_variants.py times the alternatives.
//
// The moments (shot_moments_a/b). A block of kMomentQueries threads, one
// query each, stages its span, the columns q0 - band ... q0 +
// kMomentQueries + band - 1, once as 16-byte records in one coalesced
// pass and one __syncthreads. A thread then sweeps its query's 2 * band +
// 1 records in candidate order: one LDS.128 an offset (the warp's 32
// lanes read 32 consecutive records, 4 wavefronts), an unfused d2, the
// three tests, and the ~28-instruction body where the query selects. The
// columns outside [0, n) are NaN records, so no step checks a bound. The
// sums stay in candidate order in registers, with no atomics: two calls
// give the same bits, and the same bits as the first port's kernel,
// which read each candidate's rows straight from device memory (4 loads,
// 5 in pass B, two 128-byte lines a warp each, at every offset). Placed,
// pass B writes each query's 14 sums and two zeros as one 64-byte row at
// rows[p] (two full sectors), and pass A adds row p of that buffer to its
// own sums (__fadd_rn: the bits of mom_a + mom_b gathered into pass-A
// order) before it writes its (14, n) rows, so the LRF solve reads
// contiguous columns.
//
// What bounds them: instruction issue. On the 1M registration target at
// r = 0.25 and band 32 a query selects 12.55 (A) and 7.19 (B) of its 65
// candidates, but a warp's queries are Morton neighbours and select
// together, so the body runs at most offsets. A probe whose body only
// counts takes about half the time (0.058 / 0.062 ms of 0.113 / 0.102):
// the sweep, ~15 instructions a query and offset, and the staging; the
// body the rest. Timed on the H100 at tile 256 (tools/shot_moments_variants.py,
// see PERF.md): 128 threads (256: 0-4% slower); one query a thread (two
// adjacent ones sharing each record read, 72 registers: 9-17% slower);
// the body under the selection (per-lane masks of 32 offsets with the
// body over each lane's set bits: 7-10% slower); a cap of 40 registers,
// 12 blocks an SM (uncapped, 46-52 registers: 0-6% slower; 64: the
// same; 32: spills); staged records
// (each record's five rows read through L1 where it is needed: 1.33x (A)
// and 1.80x (B)); pass B placed as 64-byte rows (scattered into (14, n)
// columns: 26% slower, while pass A's add from columns is 1% faster). The
// tool also times the first port's kernel beside this one.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

using tc::atan2_approx;
using tc::dot3;
using tc::kPi;

constexpr int kMoments = 14;
constexpr int kShotDim = 352;
constexpr int kUscDim = 128;
constexpr int kCos = 11;
constexpr int kMomentQueries = 128;  // threads (one query each) of a moments block
constexpr int kMomentMinBlocks = 12; // blocks an SM the launch bounds ask for: 40 registers
constexpr bool kMomentStage = true;  // stage the block's span in shared memory
constexpr int kMomentRow = 16;       // floats of a placed row: 14 sums and 2 zeros
constexpr int kHistWarps = 4;        // warps of a histogram block
constexpr int kShotGroup = 16;       // lanes that share one SHOT query: 32, 16 or 8
constexpr int kUscGroup = 8;         // lanes that share one USC query: 32, 16 or 8
constexpr bool kHistStage = true;    // stage the block's candidate span in shared memory
constexpr bool kHistPrefetch = true; // copy the rows to add to into shared memory early
constexpr size_t kMaxStageBytes = 200 * 1024;  // of the 227 KB a block may use
constexpr float kAzScale = 1.2732394933700562f;  // float32(8 / (2 pi))

// The shape of a histogram block: kGroup lanes a query, kWarpQueries
// queries a warp, kQueries a block; kRow floats of a query's row in shared
// memory (dim votes and the count, rounded up to whole float4s).
template <bool kUsc>
struct HistShape {
  static constexpr int kDim = kUsc ? kUscDim : kShotDim;
  static constexpr int kGroup = kUsc ? kUscGroup : kShotGroup;
  static constexpr int kWarpQueries = 32 / kGroup;
  static constexpr int kQueries = kHistWarps * kWarpQueries;
  static constexpr int kRow = (kDim + 4) / 4 * 4;
};

// Candidate column col of packed rows (rows, n) as an (x, y, z, tag)
// record: tag NaN where the column is not valid or lies outside [0, n)
// (nothing is read there), else 0 in pass A and row pos_row (posA) in
// pass B.
template <bool kPassB>
__device__ __forceinline__ float4 column_record(const float* __restrict__ packed, long n,
                                                long col, int pos_row) {
  const float nan = __int_as_float(0x7fc00000);
  if (col < 0 || col >= n) return make_float4(0.f, 0.f, 0.f, nan);
  const bool valid = packed[3 * n + col] > 0.5f;
  return make_float4(packed[col], packed[n + col], packed[2 * n + col],
                     valid ? (kPassB ? packed[pos_row * n + col] : 0.f) : nan);
}

// Stage columns c0 ... c0 + span - 1 as column_record's records and, where
// nrms is given, their (nx, ny, nz, 0) from rows 4-6 (zeros outside [0, n)).
template <bool kPassB>
__device__ __forceinline__ void stage_span(const float* __restrict__ packed, int n, int c0,
                                           int span, int pos_row, float4* recs, float4* nrms) {
  const long nl = n;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long c = static_cast<long>(c0) + i;
    recs[i] = column_record<kPassB>(packed, nl, c, pos_row);
    if (nrms != nullptr) {
      nrms[i] = c >= 0 && c < nl ? make_float4(packed[4 * nl + c], packed[5 * nl + c],
                                               packed[6 * nl + c], 0.f)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The candidate side of the selection on a record's tag: pass A a tag of 0,
// pass B |tag - posA_q| > band in fp32; false for a NaN tag.
template <bool kPassB>
__device__ __forceinline__ bool tag_selects(float tag, float q_pa, float band_f) {
  return kPassB ? fabsf(__fsub_rn(tag, q_pa)) > band_f : tag == 0.f;
}

// d = c - q and d2 = |d|^2, unfused; true when the record is selected.
template <bool kPassB>
__device__ __forceinline__ bool moment_candidate(float4 c, float qx, float qy, float qz,
                                                 float q_pa, float band_f, float r2,
                                                 float& dx, float& dy, float& dz, float& d2) {
  dx = __fsub_rn(c.x, qx);
  dy = __fsub_rn(c.y, qy);
  dz = __fsub_rn(c.z, qz);
  d2 = dot3(dx, dy, dz, dx, dy, dz);
  return tag_selects<kPassB>(c.w, q_pa, band_f) && d2 <= r2 && d2 > 1e-18f;
}

// A selected candidate's terms added to the query's 14 sums.
__device__ __forceinline__ void add_moments(float* acc, float dx, float dy, float dz, float d2,
                                            float radius) {
  const float w = fmaxf(__fsub_rn(radius, __fsqrt_rn(d2)), 0.f);
  const float wx = w * dx, wy = w * dy, wz = w * dz, wd2 = w * d2;
  acc[0] += w;
  acc[1] += wx;
  acc[2] += wy;
  acc[3] += wz;
  acc[4] += wx * dx;
  acc[5] += wy * dy;
  acc[6] += wz * dz;
  acc[7] += wx * dy;
  acc[8] += wx * dz;
  acc[9] += wy * dz;
  acc[10] += 1.f;
  acc[11] += wd2 * dx;
  acc[12] += wd2 * dy;
  acc[13] += wd2 * dz;
}

// Pass B placed: a query's 14 sums and two zeros as the 64-byte row `row`
// of out.
__device__ __forceinline__ void store_placed(float* __restrict__ out, long row,
                                             const float* acc) {
  float4* dst = reinterpret_cast<float4*>(out + row * kMomentRow);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  dst[2] = make_float4(acc[8], acc[9], acc[10], acc[11]);
  dst[3] = make_float4(acc[12], acc[13], 0.f, 0.f);
}

// Pass A merged: row p of plus (pass B's sums, placed as store_placed
// places them) added to query p's own sums.
__device__ __forceinline__ void add_plus(const float* __restrict__ plus, long p, float* acc) {
  const float4* src = reinterpret_cast<const float4*>(plus + p * kMomentRow);
  float b[kMomentRow];
#pragma unroll
  for (int j = 0; j < kMomentRow / 4; ++j) {
    const float4 v = src[j];
    b[4 * j] = v.x, b[4 * j + 1] = v.y, b[4 * j + 2] = v.z, b[4 * j + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < kMoments; ++j) acc[j] = __fadd_rn(acc[j], b[j]);
}

// Moments: thread t of the block serves query p = q0 + t, whose
// candidates are span entries t ... t + 2 * band (span entry i is column
// q0 - band + i). kStage: the span is staged in shared memory; else each
// record is read from device memory where it is needed (the wide bands
// beyond kMaxStageBytes). Pass A with plus adds the query's pass-B row;
// pass B with rows places its sums (store_placed); else both write (14,
// n) rows.
template <bool kPassB, bool kStage>
__global__ void __launch_bounds__(kMomentQueries, kMomentMinBlocks)
    shot_moments_kernel(const float* __restrict__ packed, const float* __restrict__ plus,
                        float* __restrict__ out, const int* __restrict__ rows, int n, int band,
                        float r2, float radius) {
  constexpr int kPosRow = 4;
  extern __shared__ float4 recs[];
  const long nl = n;
  const int q0 = static_cast<int>(blockIdx.x) * kMomentQueries;
  if (kStage) {
    stage_span<kPassB>(packed, n, q0 - band, kMomentQueries + 2 * band, kPosRow, recs,
                       nullptr);
    __syncthreads();
  }
  const int t = static_cast<int>(threadIdx.x);
  const int p = q0 + t;
  if (p >= n) return;
  const auto record = [&](int i) {
    return kStage ? recs[i]
                  : column_record<kPassB>(packed, nl, static_cast<long>(q0) - band + i,
                                          kPosRow);
  };
  const float qx = packed[p], qy = packed[nl + p], qz = packed[2 * nl + p];
  const float q_pa = kPassB ? packed[kPosRow * nl + p] : 0.f;
  const float band_f = static_cast<float>(band);
  float acc[kMoments];
#pragma unroll
  for (int m = 0; m < kMoments; ++m) acc[m] = 0.f;
#pragma unroll 4
  for (int k = 0; k <= 2 * band; ++k) {
    float dx, dy, dz, d2;
    if (moment_candidate<kPassB>(record(t + k), qx, qy, qz, q_pa, band_f, r2, dx, dy, dz,
                                 d2)) {
      add_moments(acc, dx, dy, dz, d2, radius);
    }
  }
  if (!kPassB && plus != nullptr) add_plus(plus, p, acc);
  if (kPassB && rows != nullptr) {
    store_placed(out, rows[p], acc);
  } else {
#pragma unroll
    for (int m = 0; m < kMoments; ++m) out[m * nl + p] = acc[m];
  }
}

// One SHOT/USC vote: v added to h[bin] by every lane that has one, where
// lanes share a bin in ascending lane order (rank by rank), elsewhere in
// parallel. key names the bin's shared-memory slot (the group's row and
// bin), so lanes of different queries never wait for each other. A fixed
// order, not float atomics: two calls give the same bits.
__device__ __forceinline__ void vote_in_lane_order(float* h, int key, int bin, float v,
                                                   bool on, int lane) {
  const unsigned voters = __ballot_sync(0xffffffffu, on);
  if (voters == 0) return;
  const unsigned peers = __match_any_sync(0xffffffffu, on ? key : -1) & voters;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int last = __reduce_max_sync(0xffffffffu, on ? rank : 0);
  for (int r = 0; r <= last; ++r) {
    if (on && rank == r) h[bin] += v;
    __syncwarp();
  }
}

// Histograms: kGroup lanes serve one query, kWarpQueries queries a warp
// (HistShape). The lanes take the query's candidates p - band + k (k = 0
// ... 2*band) in rounds of kGroup, lane s the k = round * kGroup + s, and
// vote into
// the query's row of kRow floats in shared memory: in a round, the lower
// bins (the USC bin) in lane order, then the SHOT upper bins in lane order,
// so each bin sums its votes in candidate order. kStage: the block's span of
// candidate columns [q0 - band, q0 + kQueries + band) is first staged as
// column_record's (x, y, z, tag) records and, for SHOT, an (nx, ny, nz, 0)
// plane (stage_span); otherwise the lanes read their records from device
// memory through L1.
// The query's dim + 1 floats are then written, or added to what is there
// (accumulate), as one contiguous row of out (n_rows, dim + 1) at row
// rows[p] (p where rows is null), 32 lanes a store.
template <bool kPassB, bool kUsc, bool kStage>
__global__ void __launch_bounds__(kHistWarps * 32)
    shot_hist_kernel(const float* __restrict__ packed, const float* __restrict__ lrf,
                     float* __restrict__ out, const int* __restrict__ rows, int n, int band,
                     float r2, float inv_r, bool accumulate) {
  using Shape = HistShape<kUsc>;
  constexpr int kDim = Shape::kDim, kRow = Shape::kRow, kGroup = Shape::kGroup;
  constexpr int kWarpQueries = Shape::kWarpQueries, kQueries = Shape::kQueries;
  extern __shared__ float4 smem[];
  const long nl = n;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int sub = lane % kGroup;
  const int slot = warp * kWarpQueries + lane / kGroup;  // query of the block
  const int q0 = static_cast<int>(blockIdx.x) * kQueries;
  const int p = q0 + slot;
  const int span = kQueries + 2 * band;
  float4* recs = smem;
  float4* nrms = smem + span;
  float* hist = reinterpret_cast<float*>(smem + (kStage ? (kUsc ? 1 : 2) * span : 0));
  float* prev = hist + kQueries * kRow;  // accumulate: the rows added to
  const bool prefetch = kHistPrefetch && accumulate;
  if (prefetch) {  // in flight while the warp votes
    for (int g = 0; g < kWarpQueries; ++g) {
      const int q = q0 + warp * kWarpQueries + g;
      if (q >= n) break;
      const float* src = out + (rows ? static_cast<long>(rows[q]) : static_cast<long>(q)) *
                                   (kDim + 1);
      float* dst = prev + (warp * kWarpQueries + g) * kRow;
      for (int j = lane; j <= kDim; j += 32) __pipeline_memcpy_async(dst + j, src + j, 4);
    }
    __pipeline_commit();
  }
  if (kStage) stage_span<kPassB>(packed, n, q0 - band, span, 7, recs, kUsc ? nullptr : nrms);
  for (int i = threadIdx.x; i < kQueries * kRow / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(hist)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  float* h = hist + slot * kRow;
  const bool live = p < n;
  const int pq = live ? p : n - 1;
  const float qx = packed[pq], qy = packed[nl + pq], qz = packed[2 * nl + pq];
  const float q_pa = kPassB ? packed[7 * nl + pq] : 0.f;
  const float band_f = static_cast<float>(band);
  const float r2_quarter = 0.25f * r2;  // exact: a power of two
  float f[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) f[r] = lrf[r * nl + pq];
  int cnt = 0;
  const int width = 2 * band + 1;
  for (int k0 = 0; k0 < width; k0 += kGroup) {
    const int k = k0 + sub;
    const int c = p - band + k;
    bool sel = false, split = false;
    int bin = 0;
    float v_lo = 0.f, v_hi = 0.f;
    float4 rec = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7fc00000));
    if (live && k < width) {
      rec = kStage ? recs[slot + k] : column_record<kPassB>(packed, nl, c, 7);
    }
    float dx = 0.f, dy = 0.f, dz = 0.f, d2 = 0.f;
    if (tag_selects<kPassB>(rec.w, q_pa, band_f)) {
      dx = __fsub_rn(rec.x, qx);
      dy = __fsub_rn(rec.y, qy);
      dz = __fsub_rn(rec.z, qz);
      d2 = dot3(dx, dy, dz, dx, dy, dz);
      sel = d2 <= r2 && d2 > 1e-18f;
    }
    if (sel) {
      ++cnt;
      const float lx = dot3(dx, dy, dz, f[0], f[1], f[2]);
      const float ly = dot3(dx, dy, dz, f[3], f[4], f[5]);
      const float lz = dot3(dx, dy, dz, f[6], f[7], f[8]);
      const float az = atan2_approx(ly, lx);
      const int az_bin =
          min(max(static_cast<int>(__fmul_rn(__fadd_rn(az, kPi), kAzScale)), 0), 7);
      const int el_bin = lz >= 0.f ? 1 : 0;
      v_lo = 1.f;
      if (kUsc) {
        const float scaled = __fmul_rn(__fmul_rn(__fsqrt_rn(d2), inv_r), 8.f);
        const int rad_bin = min(max(static_cast<int>(scaled), 0), 7);
        bin = (az_bin * 2 + el_bin) * 8 + rad_bin;
      } else {
        float nx, ny, nz;
        if (kStage) {
          const float4 nrm = nrms[slot + k];
          nx = nrm.x, ny = nrm.y, nz = nrm.z;
        } else {
          nx = packed[4 * nl + c], ny = packed[5 * nl + c], nz = packed[6 * nl + c];
        }
        const int rad_bin = d2 >= r2_quarter ? 1 : 0;
        const int vol = (az_bin * 2 + el_bin) * 2 + rad_bin;
        const float cosn = dot3(nx, ny, nz, f[6], f[7], f[8]);
        const float pos = fminf(
            fmaxf(__fsub_rn(__fmul_rn(__fadd_rn(cosn, 1.f), 0.5f * kCos), 0.5f), 0.f),
            static_cast<float>(kCos - 1));
        const int lo_bin = static_cast<int>(pos);
        bin = vol * kCos + lo_bin;
        if (lo_bin != kCos - 1) {  // the whole vote to lo at the top bin
          const float frac = __fsub_rn(pos, static_cast<float>(lo_bin));
          v_lo = __fsub_rn(1.f, frac);
          v_hi = frac;
          split = true;
        }
      }
    }
    vote_in_lane_order(h, slot * kRow + bin, bin, v_lo, sel, lane);
    if (!kUsc) vote_in_lane_order(h, slot * kRow + bin + 1, bin + 1, v_hi, split, lane);
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (sub == 0) h[kDim] = static_cast<float>(cnt);
  if (prefetch) __pipeline_wait_prior(0);
  __syncwarp();
  for (int g = 0; g < kWarpQueries; ++g) {
    const int q = q0 + warp * kWarpQueries + g;
    if (q >= n) break;
    const float* src = hist + (warp * kWarpQueries + g) * kRow;
    const float* old = prev + (warp * kWarpQueries + g) * kRow;
    float* dst = out + (rows ? static_cast<long>(rows[q]) : static_cast<long>(q)) * (kDim + 1);
    for (int j = lane; j <= kDim; j += 32) {
      dst[j] = accumulate ? __fadd_rn(prefetch ? old[j] : dst[j], src[j]) : src[j];
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem, void* stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

template <bool kPassB, bool kUsc>
cudaError_t launch_hist(const float* packed, const float* lrf, float* out, const int* rows,
                        int n, int band, float r2, float inv_r, int accumulate,
                        void* stream) {
  using Shape = HistShape<kUsc>;
  // the block's histogram rows, and in add mode the rows they add to
  const size_t row_bytes =
      sizeof(float) * Shape::kQueries * Shape::kRow * (kHistPrefetch && accumulate ? 2 : 1);
  const size_t stage_bytes = sizeof(float4) * (kUsc ? 1 : 2) * (Shape::kQueries + 2 * band);
  const int blocks = (n + Shape::kQueries - 1) / Shape::kQueries;
  // a band too wide to stage (beyond ShotConfig's shapes) reads through L1
  if (kHistStage && row_bytes + stage_bytes <= kMaxStageBytes) {
    return launch(shot_hist_kernel<kPassB, kUsc, true>, blocks, kHistWarps * 32,
                  row_bytes + stage_bytes, stream, packed, lrf, out, rows, n, band, r2,
                  inv_r, accumulate != 0);
  }
  return launch(shot_hist_kernel<kPassB, kUsc, false>, blocks, kHistWarps * 32, row_bytes,
                stream, packed, lrf, out, rows, n, band, r2, inv_r, accumulate != 0);
}

template <bool kPassB>
cudaError_t launch_hist(const float* packed, const float* lrf, float* out, const int* rows,
                        int n, int band, float r2, float inv_r, int usc, int accumulate,
                        void* stream) {
  if (usc) {
    return launch_hist<kPassB, true>(packed, lrf, out, rows, n, band, r2, inv_r, accumulate,
                                     stream);
  }
  return launch_hist<kPassB, false>(packed, lrf, out, rows, n, band, r2, inv_r, accumulate,
                                    stream);
}

template <bool kPassB>
cudaError_t launch_moments(const float* packed, const float* plus, float* out, const int* rows,
                           int n, int band, float r2, float radius, void* stream) {
  const int blocks = (n + kMomentQueries - 1) / kMomentQueries;
  const size_t stage_bytes = sizeof(float4) * (kMomentQueries + 2 * static_cast<size_t>(band));
  // a band too wide to stage (beyond ShotConfig's shapes) reads through L1
  if (kMomentStage && stage_bytes <= kMaxStageBytes) {
    return launch(shot_moments_kernel<kPassB, true>, blocks, kMomentQueries, stage_bytes,
                  stream, packed, plus, out, rows, n, band, r2, radius);
  }
  return launch(shot_moments_kernel<kPassB, false>, blocks, kMomentQueries, 0, stream, packed,
                plus, out, rows, n, band, r2, radius);
}

}  // namespace

// The wrappers (kernels/shot.py) check shapes, dtypes and devices, that
// n > 0 and 0 <= band <= tile with tile dividing n, and a placement's
// buffers (out and rows, plus: contiguous, on the card, every row in
// range); r2 arrives rounded to fp32, radius = sqrt(r2) and inv_r = 1 /
// sqrt(r2) rounded as the Pallas bodies round them. plus and rows may be
// null: then the moments write their (14, n) rows alone.
extern "C" int tc_shot_moments_a(const float* packed, const float* plus, float* out, int n,
                                 int band, float r2, float radius, void* stream) {
  return launch_moments<false>(packed, plus, out, nullptr, n, band, r2, radius, stream);
}

extern "C" int tc_shot_moments_b(const float* packed, float* out, const int* rows, int n,
                                 int band, float r2, float radius, void* stream) {
  return launch_moments<true>(packed, nullptr, out, rows, n, band, r2, radius, stream);
}

extern "C" int tc_shot_hist_a(const float* packed, const float* lrf, float* out,
                              const int* rows, int n, int band, float r2, float inv_r, int usc,
                              int accumulate, void* stream) {
  return launch_hist<false>(packed, lrf, out, rows, n, band, r2, inv_r, usc, accumulate,
                            stream);
}

extern "C" int tc_shot_hist_b(const float* packed, const float* lrf, float* out,
                              const int* rows, int n, int band, float r2, float inv_r, int usc,
                              int accumulate, void* stream) {
  return launch_hist<true>(packed, lrf, out, rows, n, band, r2, inv_r, usc, accumulate,
                           stream);
}
