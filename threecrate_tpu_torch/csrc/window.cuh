// The staged 3-tile window that the window kernels share: 16-byte
// candidate records and the bounding boxes of their column chunks, with
// the test that lets a sweep pass over a chunk beyond its threshold.
#pragma once

#include "common.cuh"

namespace tc {

// The factor that keeps a box's fp32 distance bound below every fp32 d2
// it covers (both carry ~5 roundings of 2^-24).
constexpr float kCullMargin = 1.f - 1.f / 32768.f;

// Chunks of `chunk` columns in a 3-tile window.
__host__ __device__ __forceinline__ int n_chunks(int tile, int chunk) {
  return (3 * tile + chunk - 1) / chunk;
}

// Stage the prev/self/next tiles as (x, y, z, tag) records; tile 0 has no
// prev and the last tile no next, staged as not valid and never read from
// device memory. pts holds x, y, z in rows of stride n. The tag is >= 0
// exactly where the column is valid: with pos (pass B) it stores the tile
// of the column's pass-A position there (its complement where not valid,
// so that both stay readable as tag ^ (tag >> 31)), else 0 (-1).
__device__ inline void stage_records(const float* __restrict__ pts,
                                     const float* __restrict__ valid,
                                     const int* __restrict__ pos, int n, int tile,
                                     int shift, float4* win) {
  const int t = blockIdx.x;
  const int n_t = n / tile;
  for (int j = threadIdx.x; j < 3 * tile; j += blockDim.x) {
    const int seg = j >> shift;
    const bool ok = seg == 1 || (seg == 0 && t > 0) || (seg == 2 && t < n_t - 1);
    float4 r = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
    if (ok) {
      const long col = static_cast<long>(t - 1) * tile + j;
      const int tl =
          pos == nullptr ? 0 : static_cast<int>(static_cast<unsigned>(pos[col]) >> shift);
      r = make_float4(pts[col], pts[n + col], pts[2L * n + col],
                      __int_as_float(valid[col] > 0.5f ? tl : ~tl));
    }
    win[j] = r;
  }
}

// Bounding boxes of the valid columns of each `chunk`-column chunk of the
// staged window, as (min, max) record pairs; a chunk without a valid
// column gets min = +inf, max = -inf.
__device__ inline void stage_boxes(const float4* __restrict__ win, int tile, int chunk,
                                   float4* box) {
  const int w3 = 3 * tile;
  for (int ch = threadIdx.x; ch * chunk < w3; ch += blockDim.x) {
    float4 lo = make_float4(kInf, kInf, kInf, 0.f);
    float4 hi = make_float4(-kInf, -kInf, -kInf, 0.f);
    for (int c = ch * chunk; c < min(ch * chunk + chunk, w3); ++c) {
      const float4 b = win[c];
      if (__float_as_int(b.w) < 0) continue;
      lo = make_float4(fminf(lo.x, b.x), fminf(lo.y, b.y), fminf(lo.z, b.z), 0.f);
      hi = make_float4(fmaxf(hi.x, b.x), fmaxf(hi.y, b.y), fmaxf(hi.z, b.z), 0.f);
    }
    box[2 * ch] = lo;
    box[2 * ch + 1] = hi;
  }
}

// True where no column of chunk ch can have d2 < thr (STRICT) or
// d2 <= thr (!STRICT) from the query: its box's squared distance, shrunk
// by kCullMargin, already reaches thr. Above 1e-30 no term underflows, so
// the roundings of the bound and of every d2 stay relative.
template <bool STRICT>
__device__ __forceinline__ bool chunk_beyond(const float4* __restrict__ box, int ch, float qx,
                                             float qy, float qz, float thr) {
  const float4 lo = box[2 * ch];
  const float4 hi = box[2 * ch + 1];
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)), 0.f);
  const float lb = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz)),
      kCullMargin);
  const float t = fmaxf(thr, 1e-30f);
  return STRICT ? lb >= t : lb > t;
}

}  // namespace tc
