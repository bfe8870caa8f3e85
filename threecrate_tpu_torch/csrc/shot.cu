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
// positions p - band ... p + band that lie in [0, n). So a block here
// serves fewer queries than a tile (kMomentQueries, kHistQueries), one
// thread each, and reads its candidates straight from device memory:
// neighbouring threads read neighbouring columns, and the 2*band + 1
// columns a thread reads are read again by its neighbours from L1/L2.
//
// Layout: packed rows (R, n) row-major in sorted order: moments R = 4
// ([x, y, z, valid]) or 5 (pass B: + the pass-A position as fp32);
// histograms R = 7 ([x, y, z, valid, nx, ny, nz]) or 8 (+ posA); the
// query frames lrf (9, n) [x axis (3), y axis (3), z axis (3)]. Outputs
// (14, n) and (dim + 1, n) float32, dim = 352 (SHOT) or 128 (USC).
//
// Selection, per candidate: valid & d2 <= r2 & d2 > 1e-18, and in pass B
// |posA_c - posA_q| > band, in fp32 as the Pallas body compares it.
//   moments: w = max(R - |d|, 0) with R = sqrt(r2) rounded to fp32 by the
//            wrapper (jnp.sqrt of the fp32 r2); rows [sum w, sum w*d (3),
//            sum w*d_i*d_j (xx, yy, zz, xy, xz, yz), count,
//            sum w*|d|^2*d (3)] in 14 register accumulators;
//   histograms: the displacement in the query's frame, azimuth from the
//            reproduced _atan2_approx into 8 sectors, 2 elevation halves;
//            SHOT: 2 radial shells (d2 >= r2/4) and the soft vote of
//            cos(candidate normal, query z) into 11 bins (lo with weight
//            1 - frac, lo + 1 with frac; the whole vote at lo = 10); USC:
//            8 radial shells of |d| * rsqrt(r2), one vote each. The
//            histogram of each query lives in shared memory as column i of
//            hist[b * kHistQueries + i] (a thread's column stays in one
//            bank), and row b is written coalesced across the block.
//
// Every operation that decides a selection or a bin is rounded on its own
// (the _rn intrinsics keep nvcc from contracting into FMAs) in the order of
// the plain PyTorch versions (kernels/shot.py), so counts and bin ids equal
// theirs: the USC rows bit for bit, the SHOT votes up to summation order.
//
// What bounds it: the histogram outputs. 353 floats per query and pass are
// 1.41 GB at 1M points, 0.42 ms at 3.35 TB/s, against ~65 candidates of
// ~60 fp32 operations each; a 64-query block holds a 90 KB SHOT histogram,
// so two blocks fit an SM and occupancy, not bandwidth, limits this first
// version. Register or warp-shared histograms and more queries per block
// are later work.

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
constexpr int kHistQueries = 64;     // threads (queries) of a histogram block
constexpr float kAzScale = 1.2732394933700562f;  // float32(8 / (2 pi))

// d = c - q of candidate column c and d2 = |d|^2, unfused; false when the
// candidate is not selected.
template <bool kPassB>
__device__ __forceinline__ bool take_candidate(const float* __restrict__ packed, long n,
                                               int c, int pos_row, float qx, float qy,
                                               float qz, float q_pa, float band_f, float r2,
                                               float& dx, float& dy, float& dz, float& d2) {
  if (!(packed[3 * n + c] > 0.5f)) return false;
  if (kPassB && !(fabsf(__fsub_rn(packed[pos_row * n + c], q_pa)) > band_f)) return false;
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
    if (!take_candidate<kPassB>(packed, nl, c, 4, qx, qy, qz, q_pa, band_f, r2, dx, dy,
                                dz, d2)) {
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

template <bool kPassB, bool kUsc>
__global__ void __launch_bounds__(kHistQueries)
    shot_hist_kernel(const float* __restrict__ packed, const float* __restrict__ lrf,
                     float* __restrict__ out, int n, int band, float r2, float inv_r) {
  constexpr int kDim = kUsc ? kUscDim : kShotDim;
  extern __shared__ float hist[];  // (kDim, kHistQueries)
  const int p = static_cast<int>(blockIdx.x) * kHistQueries + static_cast<int>(threadIdx.x);
  if (p >= n) return;  // no barrier below: each thread owns its column
  float* h = hist + threadIdx.x;
  for (int b = 0; b < kDim; ++b) h[b * kHistQueries] = 0.f;
  const long nl = n;
  const float qx = packed[p], qy = packed[nl + p], qz = packed[2 * nl + p];
  const float q_pa = kPassB ? packed[7 * nl + p] : 0.f;
  const float band_f = static_cast<float>(band);
  const float r2_quarter = 0.25f * r2;  // exact: a power of two
  float f[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) f[r] = lrf[r * nl + p];
  int cnt = 0;
  const int lo = max(p - band, 0);
  const int hi = min(p + band, n - 1);
  for (int c = lo; c <= hi; ++c) {
    float dx, dy, dz, d2;
    if (!take_candidate<kPassB>(packed, nl, c, 7, qx, qy, qz, q_pa, band_f, r2, dx, dy,
                                dz, d2)) {
      continue;
    }
    ++cnt;
    const float lx = dot3(dx, dy, dz, f[0], f[1], f[2]);
    const float ly = dot3(dx, dy, dz, f[3], f[4], f[5]);
    const float lz = dot3(dx, dy, dz, f[6], f[7], f[8]);
    const float az = atan2_approx(ly, lx);
    const int az_bin =
        min(max(static_cast<int>(__fmul_rn(__fadd_rn(az, kPi), kAzScale)), 0), 7);
    const int el_bin = lz >= 0.f ? 1 : 0;
    if (kUsc) {
      const float scaled = __fmul_rn(__fmul_rn(__fsqrt_rn(d2), inv_r), 8.f);
      const int rad_bin = min(max(static_cast<int>(scaled), 0), 7);
      h[((az_bin * 2 + el_bin) * 8 + rad_bin) * kHistQueries] += 1.f;
    } else {
      const int rad_bin = d2 >= r2_quarter ? 1 : 0;
      const int vol = (az_bin * 2 + el_bin) * 2 + rad_bin;
      const float cosn = dot3(packed[4 * nl + c], packed[5 * nl + c], packed[6 * nl + c],
                              f[6], f[7], f[8]);
      const float pos = fminf(
          fmaxf(__fsub_rn(__fmul_rn(__fadd_rn(cosn, 1.f), 0.5f * kCos), 0.5f), 0.f),
          static_cast<float>(kCos - 1));
      const int lo_bin = static_cast<int>(pos);
      float* slot = h + (vol * kCos + lo_bin) * kHistQueries;
      if (lo_bin == kCos - 1) {
        slot[0] += 1.f;
      } else {
        const float frac = __fsub_rn(pos, static_cast<float>(lo_bin));
        slot[0] += __fsub_rn(1.f, frac);
        slot[kHistQueries] += frac;
      }
    }
  }
  for (int b = 0; b < kDim; ++b) out[b * nl + p] = h[b * kHistQueries];
  out[kDim * nl + p] = static_cast<float>(cnt);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int n, void* stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(n + threads - 1) / threads, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return cudaGetLastError();
}

template <bool kPassB>
cudaError_t launch_hist(const float* packed, const float* lrf, float* out, int n, int band,
                        float r2, float inv_r, int usc, void* stream) {
  if (usc) {
    return launch(shot_hist_kernel<kPassB, true>, kHistQueries,
                  sizeof(float) * kUscDim * kHistQueries, n, stream, packed, lrf, out, n,
                  band, r2, inv_r);
  }
  return launch(shot_hist_kernel<kPassB, false>, kHistQueries,
                sizeof(float) * kShotDim * kHistQueries, n, stream, packed, lrf, out, n,
                band, r2, inv_r);
}

}  // namespace

// The wrappers (kernels/shot.py) check shapes, dtypes and devices, that
// n > 0 and 0 <= band <= tile with tile dividing n; r2 arrives rounded to
// fp32, radius = sqrt(r2) and inv_r = 1 / sqrt(r2) rounded as the Pallas
// bodies round them.
extern "C" int tc_shot_moments_a(const float* packed, float* out, int n, int band, float r2,
                                 float radius, void* stream) {
  return launch(shot_moments_kernel<false>, kMomentQueries, 0, n, stream, packed, out, n,
                band, r2, radius);
}

extern "C" int tc_shot_moments_b(const float* packed, float* out, int n, int band, float r2,
                                 float radius, void* stream) {
  return launch(shot_moments_kernel<true>, kMomentQueries, 0, n, stream, packed, out, n,
                band, r2, radius);
}

extern "C" int tc_shot_hist_a(const float* packed, const float* lrf, float* out, int n,
                              int band, float r2, float inv_r, int usc, void* stream) {
  return launch_hist<false>(packed, lrf, out, n, band, r2, inv_r, usc, stream);
}

extern "C" int tc_shot_hist_b(const float* packed, const float* lrf, float* out, int n,
                              int band, float r2, float inv_r, int usc, void* stream) {
  return launch_hist<true>(packed, lrf, out, n, band, r2, inv_r, usc, stream);
}
