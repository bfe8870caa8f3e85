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
// moments (14, n); histograms query-major, dim + 1 floats a query
// (dim = 352 SHOT, 128 USC, then the count) as one row of out
// (n_rows, dim + 1) at row rows[p] (p where rows is null), written or,
// with accumulate, added to what the row holds. _shot_fused has pass B
// write each query's row at its input row and pass A add to it, so the
// descriptors come out in input order with no gather.
//
// Selection, per candidate: valid & d2 <= r2 & d2 > 1e-18, and in pass B
// |posA_c - posA_q| > band, in fp32 as the Pallas body compares it.
//   moments: one query a thread (kMomentQueries a block), candidates read
//            straight from device memory; w = max(R - |d|, 0) with
//            R = sqrt(r2) rounded to fp32 by the wrapper (jnp.sqrt of the
//            fp32 r2); rows [sum w, sum w*d (3), sum w*d_i*d_j (xx, yy,
//            zz, xy, xz, yz), count, sum w*|d|^2*d (3)] in 14 register
//            accumulators;
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
constexpr int kMomentQueries = 128;  // threads (queries) of a moments block
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

// d = c - q of candidate column c of the moments' rows and d2 = |d|^2,
// unfused; false when the candidate is not selected.
template <bool kPassB>
__device__ __forceinline__ bool take_candidate(const float* __restrict__ packed, long n,
                                               int c, float qx, float qy, float qz,
                                               float q_pa, float band_f, float r2,
                                               float& dx, float& dy, float& dz, float& d2) {
  if (!(packed[3 * n + c] > 0.5f)) return false;
  if (kPassB && !(fabsf(__fsub_rn(packed[4 * n + c], q_pa)) > band_f)) return false;
  dx = __fsub_rn(packed[c], qx);
  dy = __fsub_rn(packed[n + c], qy);
  dz = __fsub_rn(packed[2 * n + c], qz);
  d2 = dot3(dx, dy, dz, dx, dy, dz);
  return d2 <= r2 && d2 > 1e-18f;
}

template <bool kPassB>
__global__ void __launch_bounds__(kMomentQueries)
    shot_moments_kernel(const float* __restrict__ packed, float* __restrict__ out, int n,
                        int band, float r2, float radius) {
  const int p = static_cast<int>(blockIdx.x) * kMomentQueries + static_cast<int>(threadIdx.x);
  if (p >= n) return;
  const long nl = n;
  const float qx = packed[p], qy = packed[nl + p], qz = packed[2 * nl + p];
  const float q_pa = kPassB ? packed[4 * nl + p] : 0.f;
  const float band_f = static_cast<float>(band);
  float acc[kMoments];
#pragma unroll
  for (int j = 0; j < kMoments; ++j) acc[j] = 0.f;
  const int lo = max(p - band, 0);
  const int hi = min(p + band, n - 1);
  for (int c = lo; c <= hi; ++c) {
    float dx, dy, dz, d2;
    if (!take_candidate<kPassB>(packed, nl, c, qx, qy, qz, q_pa, band_f, r2, dx, dy, dz,
                                d2)) {
      continue;
    }
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
#pragma unroll
  for (int j = 0; j < kMoments; ++j) out[j * nl + p] = acc[j];
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
// (x, y, z, tag) records (tag: pass B's pass-A position, 0 in pass A, -1
// where invalid or outside [0, n)) and, for SHOT, an (nx, ny, nz, 0) plane;
// otherwise the lanes read their columns from device memory through L1.
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
  if (kStage) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const int c = q0 - band + i;
      float4 rec = make_float4(0.f, 0.f, 0.f, -1.f);
      float4 nrm = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c >= 0 && c < n) {
        const bool valid = packed[3 * nl + c] > 0.5f;
        rec = make_float4(packed[c], packed[nl + c], packed[2 * nl + c],
                          valid ? (kPassB ? packed[7 * nl + c] : 0.f) : -1.f);
        if (!kUsc) nrm = make_float4(packed[4 * nl + c], packed[5 * nl + c], packed[6 * nl + c], 0.f);
      }
      recs[i] = rec;
      if (!kUsc) nrms[i] = nrm;
    }
  }
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
    float cx = 0.f, cy = 0.f, cz = 0.f, tag = -1.f;
    if (live && k < width) {
      if (kStage) {
        const float4 rec = recs[slot + k];
        cx = rec.x, cy = rec.y, cz = rec.z, tag = rec.w;
      } else if (c >= 0 && c < n && packed[3 * nl + c] > 0.5f) {
        cx = packed[c], cy = packed[nl + c], cz = packed[2 * nl + c];
        tag = kPassB ? packed[7 * nl + c] : 0.f;
      }
    }
    float dx = 0.f, dy = 0.f, dz = 0.f, d2 = 0.f;
    if (tag >= 0.f && (!kPassB || fabsf(__fsub_rn(tag, q_pa)) > band_f)) {
      dx = __fsub_rn(cx, qx);
      dy = __fsub_rn(cy, qy);
      dz = __fsub_rn(cz, qz);
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

}  // namespace

// The wrappers (kernels/shot.py) check shapes, dtypes and devices, that
// n > 0 and 0 <= band <= tile with tile dividing n; r2 arrives rounded to
// fp32, radius = sqrt(r2) and inv_r = 1 / sqrt(r2) rounded as the Pallas
// bodies round them.
extern "C" int tc_shot_moments_a(const float* packed, float* out, int n, int band, float r2,
                                 float radius, void* stream) {
  return launch(shot_moments_kernel<false>, (n + kMomentQueries - 1) / kMomentQueries,
                kMomentQueries, 0, stream, packed, out, n, band, r2, radius);
}

extern "C" int tc_shot_moments_b(const float* packed, float* out, int n, int band, float r2,
                                 float radius, void* stream) {
  return launch(shot_moments_kernel<true>, (n + kMomentQueries - 1) / kMomentQueries,
                kMomentQueries, 0, stream, packed, out, n, band, r2, radius);
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
