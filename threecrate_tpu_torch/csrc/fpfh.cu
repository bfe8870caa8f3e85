// Fused FPFH window kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels spfh_a_tiles, spfh_b_tiles,
// fpfh_weight_a_tiles, fpfh_weight_b_tiles, spfh_band_a_tiles and
// spfh_band_b_tiles of threecrate_tpu/kernels/fpfh_pallas.py (bodies
// _pair_hist with _atan2_approx, _weight_body and _spfh_band_body; the
// banded kernels see the same prev/self/next segments but scan only the
// +-band sorted positions around each query). The caller (ops/features.py,
// _fpfh_fused) Morton-sorts the cloud twice and pads it to a multiple of
// the tile; each block then serves one tile of queries against the
// prev/self/next tiles of the sorted order.
//
// Layout: packed rows (R, n) row-major, R = 7 for stage 1 ([x, y, z,
// valid, nx, ny, nz]) and 37 for stage 2 ([x, y, z, valid, spfh(33)]);
// pass-A positions (n) int32; outputs (34, n) row-major, all in sorted
// order.
//
// Per query (one thread each, one block per tile), over the 3*tile
// window candidates with valid & d2 <= r2 & d2 > 1e-12 (pass B: and the
// candidate's pass-A tile more than one tile from the query's):
//   stage 1: the PCL pair features (theta, cos phi, cos alpha) binned
//            into 3 x 11 vote counters kept in shared memory, plus the
//            count;
//   stage 2: sum of (1/d) * spfh(candidate) into 33 register
//            accumulators, plus the count.
// The window is staged one tile-wide segment at a time (prev, self,
// next), so a block needs (8 + 33) * tile floats of shared memory in
// stage 1 and 38 * tile in stage 2: 42 KB and 39 KB at tile 256.
//
// Every operation of the features and of the selection is rounded on its
// own (the _rn intrinsics keep nvcc from contracting products into FMAs,
// and 1/sqrt is a correctly rounded division of a correctly rounded
// square root), in the order the plain PyTorch versions (kernels/fpfh.py)
// evaluate them, so the vote and count rows equal theirs bit for bit.
// _atan2_approx is reproduced (tc::atan2_approx in common.cuh), not
// atan2f: its ~5e-3 rad error moves votes across bin edges.
//
// What bounds it: fp32 ALU. Stage 1 evaluates ~100 unfused operations
// for each in-radius pair and ~12 for each other candidate; stage 2 a
// distance and, in radius, 33 FMAs with broadcast shared-memory reads.
// Device memory traffic is ~(4 * R * 3 + 136) bytes per query. Register
// tiling across queries and tensor cores for the stage-2 sum are later
// work.

#include "common.cuh"

namespace {

using tc::atan2_approx;
using tc::dot3;
using tc::kPi;
using tc::kTwoPi;
using tc::rsqrt_rn;

constexpr int kBins = 11;
constexpr int kHist = 3 * kBins;

// a*b - c*d, each operation rounded on its own.
__device__ __forceinline__ float mul_sub(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// Scaled feature -> bin: truncation toward zero, clipped to [0, 10].
__device__ __forceinline__ int bin_of(float scaled) {
  return min(max(static_cast<int>(scaled), 0), kBins - 1);
}

struct Query {
  float x, y, z;
  int tile_a;  // pass-A tile of the query (pass B only)
};

// Stage rows [0, rows) of the sorted columns of candidate tile ct into
// seg (rows x tile), and their pass-A positions into pos when given.
// Columns of a tile outside [0, n_t) are never read (the caller skips
// the segment).
__device__ __forceinline__ void load_segment(const float* __restrict__ packed,
                                             const int* __restrict__ pos_a,
                                             int n, int rows, int ct,
                                             float* seg, int* pos) {
  const int tile = blockDim.x;
  const long col = static_cast<long>(ct) * tile + threadIdx.x;
  for (int r = 0; r < rows; ++r) seg[r * tile + threadIdx.x] = packed[r * static_cast<long>(n) + col];
  if (pos_a != nullptr) pos[threadIdx.x] = pos_a[col];
}

// d2 of candidate c of the staged segment, or -1 when it is not
// selected: invalid, inside the query's pass-A window (pass B), out of
// radius, or a duplicate of the query.
template <bool kPassB>
__device__ __forceinline__ float select_d2(const float* seg, const int* pos, int c,
                                           const Query& q, int shift, float r2,
                                           float& dx, float& dy, float& dz) {
  const int tile = blockDim.x;
  if (!(seg[3 * tile + c] > 0.5f)) return -1.f;
  if (kPassB) {
    const int dt = static_cast<int>(static_cast<unsigned>(pos[c]) >> shift) - q.tile_a;
    if (dt >= -1 && dt <= 1) return -1.f;
  }
  dx = __fsub_rn(seg[c], q.x);
  dy = __fsub_rn(seg[tile + c], q.y);
  dz = __fsub_rn(seg[2 * tile + c], q.z);
  const float d2 = dot3(dx, dy, dz, dx, dy, dz);
  return (d2 <= r2 && d2 > 1e-12f) ? d2 : -1.f;
}

template <bool kPassB>
__device__ __forceinline__ Query load_query(const float* __restrict__ packed,
                                            const int* __restrict__ pos_a, int n,
                                            long col, int shift) {
  Query q;
  q.x = packed[col];
  q.y = packed[n + col];
  q.z = packed[2L * n + col];
  q.tile_a = kPassB ? static_cast<int>(static_cast<unsigned>(pos_a[col]) >> shift) : 0;
  return q;
}

// The query's normal and the bin scales of stage 1.
struct QueryFrame {
  float n0, n1, n2;
  float theta_scale, cos_scale;
};

__device__ __forceinline__ QueryFrame load_frame(const float* __restrict__ packed,
                                                 int n, long col) {
  return QueryFrame{packed[4L * n + col], packed[5L * n + col], packed[6L * n + col],
                    __fdiv_rn(static_cast<float>(kBins), kTwoPi), 0.5f * kBins};
}

// One selected pair's three votes into the query's column i of hist
// (33, tile): the PCL pair features of d = c - q (|d|^2 = d2) and the
// normals of query (f) and candidate (cn0..2).
__device__ __forceinline__ void vote_pair(int* hist, int i, float dx, float dy,
                                          float dz, float d2, const QueryFrame& f,
                                          float cn0, float cn1, float cn2) {
  const int tile = blockDim.x;
  const float inv_d = rsqrt_rn(d2);
  float ux = __fmul_rn(dx, inv_d);
  float uy = __fmul_rn(dy, inv_d);
  float uz = __fmul_rn(dz, inv_d);
  const float qn0 = f.n0, qn1 = f.n1, qn2 = f.n2;
  const float a1 = dot3(qn0, qn1, qn2, ux, uy, uz);
  const float a2 = dot3(cn0, cn1, cn2, ux, uy, uz);
  // anchor the frame at the point whose normal is better aligned with
  // the connecting line
  const bool swap = fabsf(a1) < fabsf(a2);
  const float nsx = swap ? cn0 : qn0, nsy = swap ? cn1 : qn1, nsz = swap ? cn2 : qn2;
  const float ntx = swap ? qn0 : cn0, nty = swap ? qn1 : cn1, ntz = swap ? qn2 : cn2;
  if (swap) {
    ux = -ux;
    uy = -uy;
    uz = -uz;
  }
  const float f3 = dot3(nsx, nsy, nsz, ux, uy, uz);
  float vx = mul_sub(uy, nsz, uz, nsy);
  float vy = mul_sub(uz, nsx, ux, nsz);
  float vz = mul_sub(ux, nsy, uy, nsx);
  const float inv_v = rsqrt_rn(dot3(vx, vy, vz, vx, vy, vz));
  vx = __fmul_rn(vx, inv_v);
  vy = __fmul_rn(vy, inv_v);
  vz = __fmul_rn(vz, inv_v);
  const float wx = mul_sub(nsy, vz, nsz, vy);
  const float wy = mul_sub(nsz, vx, nsx, vz);
  const float wz = mul_sub(nsx, vy, nsy, vx);
  const float f2 = dot3(vx, vy, vz, ntx, nty, ntz);
  const float f1 = atan2_approx(dot3(wx, wy, wz, ntx, nty, ntz),
                                dot3(nsx, nsy, nsz, ntx, nty, ntz));
  ++hist[bin_of(__fmul_rn(__fadd_rn(f1, kPi), f.theta_scale)) * tile + i];
  ++hist[(kBins + bin_of(__fmul_rn(__fadd_rn(f2, 1.f), f.cos_scale))) * tile + i];
  ++hist[(2 * kBins + bin_of(__fmul_rn(__fadd_rn(f3, 1.f), f.cos_scale))) * tile + i];
}

__device__ __forceinline__ void store_votes(const int* hist, int cnt,
                                            float* __restrict__ out, int n, long col) {
  const int tile = blockDim.x;
  for (int b = 0; b < kHist; ++b) {
    out[b * static_cast<long>(n) + col] = static_cast<float>(hist[b * tile + threadIdx.x]);
  }
  out[kHist * static_cast<long>(n) + col] = static_cast<float>(cnt);
}

// Stage 1: rows [theta bins(11), cos phi bins(11), cos alpha bins(11),
// count].
template <bool kPassB>
__global__ void spfh_kernel(const float* __restrict__ packed,
                            const int* __restrict__ pos_a,
                            float* __restrict__ out, int n, float r2) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int i = threadIdx.x;
  const int n_t = n / tile;
  float* seg = smem;                                        // (7, tile)
  int* pos = reinterpret_cast<int*>(smem + 7 * tile);       // (tile)
  int* hist = reinterpret_cast<int*>(smem + 8 * tile);      // (33, tile)
  const int shift = __ffs(tile) - 1;  // log2(tile): tile is a power of two
  const long col = static_cast<long>(blockIdx.x) * tile + i;
  const Query q = load_query<kPassB>(packed, pos_a, n, col, shift);
  const QueryFrame f = load_frame(packed, n, col);
  for (int b = 0; b < kHist; ++b) hist[b * tile + i] = 0;
  int cnt = 0;

  for (int s = 0; s < 3; ++s) {
    const int ct = static_cast<int>(blockIdx.x) - 1 + s;
    if (ct < 0 || ct >= n_t) continue;  // block-uniform
    __syncthreads();  // the previous segment is no longer read
    load_segment(packed, pos_a, n, 7, ct, seg, pos);
    __syncthreads();
    for (int c = 0; c < tile; ++c) {
      float dx, dy, dz;
      const float d2 = select_d2<kPassB>(seg, pos, c, q, shift, r2, dx, dy, dz);
      if (d2 < 0.f) continue;
      vote_pair(hist, i, dx, dy, dz, d2, f, seg[4 * tile + c], seg[5 * tile + c],
                seg[6 * tile + c]);
      ++cnt;
    }
  }
  store_votes(hist, cnt, out, n, col);
}

// Banded stage 1 (_spfh_band_body): the candidates are the sorted
// positions p - band ... p + band of query p (band <= tile, so they lie
// in the prev/self/next tiles; the segments outside [0, n) are skipped).
// Pass B reads each column's pass-A position from packed row 7 (fp32,
// exact below 2^24 rows) and drops |posA_c - posA_q| <= band, compared
// in fp32 as the Pallas body does. Rows as spfh_kernel.
template <bool kPassB>
__global__ void spfh_band_kernel(const float* __restrict__ packed,
                                 float* __restrict__ out, int n, int band, float r2) {
  constexpr int kRows = kPassB ? 8 : 7;
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int i = threadIdx.x;
  const int n_t = n / tile;
  float* seg = smem;                                        // (kRows, tile)
  int* hist = reinterpret_cast<int*>(smem + 8 * tile);      // (33, tile)
  const long col = static_cast<long>(blockIdx.x) * tile + i;
  const float qx = packed[col], qy = packed[n + col], qz = packed[2L * n + col];
  const float q_pa = kPassB ? packed[7L * n + col] : 0.f;
  const float band_f = static_cast<float>(band);
  const QueryFrame f = load_frame(packed, n, col);
  for (int b = 0; b < kHist; ++b) hist[b * tile + i] = 0;
  int cnt = 0;

  for (int s = 0; s < 3; ++s) {
    const int ct = static_cast<int>(blockIdx.x) - 1 + s;
    if (ct < 0 || ct >= n_t) continue;  // block-uniform
    __syncthreads();
    load_segment(packed, nullptr, n, kRows, ct, seg, nullptr);
    __syncthreads();
    // window column s*tile + c holds offset s*tile + c - (tile + i)
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
      vote_pair(hist, i, dx, dy, dz, d2, f, seg[4 * tile + c], seg[5 * tile + c],
                seg[6 * tile + c]);
      ++cnt;
    }
  }
  store_votes(hist, cnt, out, n, col);
}

// Stage 2: rows [sum (1/d) * spfh(33), count].
template <bool kPassB>
__global__ void fpfh_weight_kernel(const float* __restrict__ packed,
                                   const int* __restrict__ pos_a,
                                   float* __restrict__ out, int n, float r2) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int n_t = n / tile;
  float* seg = smem;                                         // (37, tile)
  int* pos = reinterpret_cast<int*>(smem + (4 + kHist) * tile);
  const int shift = __ffs(tile) - 1;
  const long col = static_cast<long>(blockIdx.x) * tile + threadIdx.x;
  const Query q = load_query<kPassB>(packed, pos_a, n, col, shift);
  float acc[kHist];
#pragma unroll
  for (int j = 0; j < kHist; ++j) acc[j] = 0.f;
  int cnt = 0;

  for (int s = 0; s < 3; ++s) {
    const int ct = static_cast<int>(blockIdx.x) - 1 + s;
    if (ct < 0 || ct >= n_t) continue;  // block-uniform
    __syncthreads();
    load_segment(packed, pos_a, n, 4 + kHist, ct, seg, pos);
    __syncthreads();
    for (int c = 0; c < tile; ++c) {
      float dx, dy, dz;
      const float d2 = select_d2<kPassB>(seg, pos, c, q, shift, r2, dx, dy, dz);
      if (d2 < 0.f) continue;
      const float w = rsqrt_rn(d2);
      const float* spfh = seg + 4 * tile + c;
#pragma unroll
      for (int j = 0; j < kHist; ++j) acc[j] = fmaf(w, spfh[j * tile], acc[j]);
      ++cnt;
    }
  }
#pragma unroll
  for (int j = 0; j < kHist; ++j) out[j * static_cast<long>(n) + col] = acc[j];
  out[kHist * static_cast<long>(n) + col] = static_cast<float>(cnt);
}

// One block of tile threads per query tile, with smem_rows * tile floats
// of dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem_rows, int n, int tile, void* stream,
                   Args... args) {
  const size_t smem = static_cast<size_t>(smem_rows) * tile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n / tile, tile, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

constexpr int kSpfhSmemRows = 8 + kHist;        // segment (7 or 8) + pos + votes
constexpr int kWeightSmemRows = 4 + kHist + 1;  // segment (37) + pos

}  // namespace

// The wrappers (kernels/fpfh.py) check shapes, dtypes and devices, that
// tile is a power of two <= 1024 dividing n, 0 <= band <= tile, and the
// shared-memory size; r2 arrives rounded to fp32.
extern "C" int tc_spfh_a(const float* packed, float* out, int n, int tile, float r2,
                         void* stream) {
  return launch(spfh_kernel<false>, kSpfhSmemRows, n, tile, stream, packed,
                static_cast<const int*>(nullptr), out, n, r2);
}

extern "C" int tc_spfh_b(const float* packed, const int* pos_a, float* out, int n,
                         int tile, float r2, void* stream) {
  return launch(spfh_kernel<true>, kSpfhSmemRows, n, tile, stream, packed, pos_a, out,
                n, r2);
}

extern "C" int tc_fpfh_weight_a(const float* packed, float* out, int n, int tile,
                                float r2, void* stream) {
  return launch(fpfh_weight_kernel<false>, kWeightSmemRows, n, tile, stream, packed,
                static_cast<const int*>(nullptr), out, n, r2);
}

extern "C" int tc_fpfh_weight_b(const float* packed, const int* pos_a, float* out,
                                int n, int tile, float r2, void* stream) {
  return launch(fpfh_weight_kernel<true>, kWeightSmemRows, n, tile, stream, packed,
                pos_a, out, n, r2);
}

extern "C" int tc_spfh_band_a(const float* packed, float* out, int n, int tile, int band,
                              float r2, void* stream) {
  return launch(spfh_band_kernel<false>, kSpfhSmemRows, n, tile, stream, packed, out, n,
                band, r2);
}

extern "C" int tc_spfh_band_b(const float* packed, float* out, int n, int tile, int band,
                              float r2, void* stream) {
  return launch(spfh_band_kernel<true>, kSpfhSmemRows, n, tile, stream, packed, out, n,
                band, r2);
}
