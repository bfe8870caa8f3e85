// Union-window normal sums for Hopper (sm_90a).
//
// Replaces the Pallas kernels window_union_a_tiles and
// window_union_b_tiles of threecrate_tpu/kernels/knn_pallas.py (bodies
// _union_a_kernel and _union_b_kernel, selection _band_bound). The
// caller (ops/normals.py, _union_window_sums) Morton-sorts the cloud and
// pads it to a multiple of the tile; each block then serves one tile of
// queries against the prev/self/next tiles of the sorted order.
//
// Layout: coordinates (3, n) row-major, validity (n), pass-A positions
// (n) int32, outputs (11, n) row-major, all in sorted order.
//
// Per query (one thread each, one block per tile, the 3-tile window
// staged in shared memory):
//   1. the k-th smallest squared distance among the +-band sorted
//      neighbours, kept as a sorted register array;
//   2. 6 bisection rounds of that radius against the count over the
//      whole window (each round one sweep over 3*tile candidates);
//   3. one last sweep accumulating count, S1 = sum(c - q) and
//      S2 = sum((c - q)(c - q)^T) over the selected candidates.
// The Pallas kernel gets the same sums from a tile-centred moments
// matmul shifted to the query; accumulating around the query directly
// is the same quantity with less cancellation and needs no matmul.
//
// What bounds it: fp32 ALU. Each query makes 8 sweeps of 3*tile
// candidates (~10 flops each) from shared memory while it reads 16-20
// bytes and writes 44 bytes of device memory, so memory traffic is
// negligible and the shared-memory reads are warp-wide broadcasts.
// wgmma/TMA have no role in these per-query scans; a faster version
// (fewer sweeps, candidate reuse across queries) is later work.

#include "common.cuh"

namespace {

using tc::kInf;
// Largest finite radius: a query with fewer than k valid band candidates
// keeps hi = inf, and inf <= inf would select invalid candidates.
constexpr float kHiClamp = 3.4e38f;

struct Window {
  float* x;
  float* y;
  float* z;
  float* v;
  int* pos;  // pass-A positions (pass B only)
};

// Stage the prev/self/next tiles of the sorted arrays. Tile 0 has no prev
// and the last tile no next: those columns are staged as invalid.
__device__ void load_window(const float* __restrict__ pts,
                            const float* __restrict__ valid,
                            const int* __restrict__ pos, int n, Window w) {
  const int tile = blockDim.x;
  const int t = blockIdx.x;
  const int n_t = n / tile;
  for (int j = threadIdx.x; j < 3 * tile; j += tile) {
    const int seg = j / tile;
    const bool ok = seg == 1 || (seg == 0 && t > 0) || (seg == 2 && t < n_t - 1);
    const long col = static_cast<long>(t - 1) * tile + j;
    w.x[j] = ok ? pts[col] : 0.f;
    w.y[j] = ok ? pts[n + col] : 0.f;
    w.z[j] = ok ? pts[2L * n + col] : 0.f;
    w.v[j] = ok ? valid[col] : 0.f;
    if (pos != nullptr) w.pos[j] = ok ? pos[col] : 0;
  }
}

// Squared distance to window column c, +inf for an invalid column.
__device__ __forceinline__ float window_d2(const Window& w, int c, float qx,
                                           float qy, float qz) {
  return w.v[c] > 0.5f ? tc::sq_dist(qx, qy, qz, w.x[c], w.y[c], w.z[c]) : kInf;
}

// Selection radius of the query in column tile + threadIdx.x: an upper
// bound with count(d2 <= hi) >= k, within r_band / 2^6 of the k-th
// smallest window distance.
template <int KMAX>
__device__ float band_bound(const Window& w, int k, int band, float qx,
                            float qy, float qz) {
  const int tile = blockDim.x;
  const int i = threadIdx.x;
  float best[KMAX];  // ascending; best[k-1] is the k-th smallest
#pragma unroll
  for (int j = 0; j < KMAX; ++j) best[j] = kInf;
  for (int off = -band; off <= band; ++off) {
    float v = window_d2(w, tile + i + off, qx, qy, qz);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const float lo = fminf(best[j], v);
      v = fmaxf(best[j], v);
      best[j] = lo;
    }
  }
  float r2 = kInf;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j == k - 1) r2 = best[j];
  }
  float lo = 0.f;
  float hi = r2;
  for (int round = 0; round < 6; ++round) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
    for (int c = 0; c < 3 * tile; ++c) cnt += window_d2(w, c, qx, qy, qz) <= mid;
    if (cnt >= k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return fminf(hi, kHiClamp);
}

__device__ __forceinline__ void accumulate(float* s, float dx, float dy,
                                           float dz) {
  s[0] += 1.f;
  s[1] += dx;
  s[2] += dy;
  s[3] += dz;
  s[4] += dx * dx;
  s[5] += dy * dy;
  s[6] += dz * dz;
  s[7] += dx * dy;
  s[8] += dx * dz;
  s[9] += dy * dz;
}

__device__ __forceinline__ void store(float* __restrict__ out, int n,
                                      const float* s, float last) {
  const long col = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
#pragma unroll
  for (int r = 0; r < 10; ++r) out[r * static_cast<long>(n) + col] = s[r];
  out[10L * n + col] = last;
}

// Pass A: rows [cnt, S1(3), S2(6), hiA].
template <int KMAX>
__global__ void union_a_kernel(const float* __restrict__ pts,
                               const float* __restrict__ valid,
                               float* __restrict__ out, int n, int k, int band) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  Window w{smem, smem + 3 * tile, smem + 6 * tile, smem + 9 * tile, nullptr};
  load_window(pts, valid, nullptr, n, w);
  __syncthreads();

  const int q = tile + threadIdx.x;
  const float qx = w.x[q], qy = w.y[q], qz = w.z[q];
  const float hi = band_bound<KMAX>(w, k, band, qx, qy, qz);
  float s[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < 3 * tile; ++c) {
    if (window_d2(w, c, qx, qy, qz) <= hi) {
      accumulate(s, w.x[c] - qx, w.y[c] - qy, w.z[c] - qz);
    }
  }
  store(out, n, s, hi);
}

// Pass B over the shifted-lattice order. Where hiB < hiA (pass A's
// window was poor) it emits the full pass-B window sums at hiB, to be
// used alone; otherwise the sums within hiA over candidates OUTSIDE the
// query's pass-A window (|posA tile - query posA tile| > 1), which add
// to pass A's sums. Rows [S_out(10), use_b].
template <int KMAX>
__global__ void union_b_kernel(const float* __restrict__ pts,
                               const float* __restrict__ valid,
                               const int* __restrict__ pos_a,
                               const float* __restrict__ hi_a,
                               float* __restrict__ out, int n, int k, int band) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  Window w{smem, smem + 3 * tile, smem + 6 * tile, smem + 9 * tile,
           reinterpret_cast<int*>(smem + 12 * tile)};
  load_window(pts, valid, pos_a, n, w);
  __syncthreads();

  const int q = tile + threadIdx.x;
  const float qx = w.x[q], qy = w.y[q], qz = w.z[q];
  const float hib = band_bound<KMAX>(w, k, band, qx, qy, qz);
  const float hia = hi_a[static_cast<long>(blockIdx.x) * tile + threadIdx.x];
  const bool use_b = hib < hia;
  const int shift = __ffs(tile) - 1;  // log2(tile): tile is a power of two
  const int tile_q = static_cast<int>(static_cast<unsigned>(w.pos[q]) >> shift);
  float s[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < 3 * tile; ++c) {
    const float d = window_d2(w, c, qx, qy, qz);
    bool sel;
    if (use_b) {
      sel = d <= hib;
    } else {
      const int dt =
          static_cast<int>(static_cast<unsigned>(w.pos[c]) >> shift) - tile_q;
      sel = d <= hia && (dt < -1 || dt > 1);
    }
    if (sel) accumulate(s, w.x[c] - qx, w.y[c] - qy, w.z[c] - qz);
  }
  store(out, n, s, use_b ? 1.f : 0.f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int KMAX>
cudaError_t launch_a(const float* pts, const float* valid, float* out, int n,
                     int tile, int k, int band, cudaStream_t stream) {
  const size_t smem = 12 * static_cast<size_t>(tile) * sizeof(float);
  cudaError_t err = allow_smem(union_a_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  union_a_kernel<KMAX><<<n / tile, tile, smem, stream>>>(pts, valid, out, n, k, band);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_b(const float* pts, const float* valid, const int* pos_a,
                     const float* hi_a, float* out, int n, int tile, int k,
                     int band, cudaStream_t stream) {
  const size_t smem = 15 * static_cast<size_t>(tile) * sizeof(float);
  cudaError_t err = allow_smem(union_b_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  union_b_kernel<KMAX><<<n / tile, tile, smem, stream>>>(pts, valid, pos_a, hi_a,
                                                         out, n, k, band);
  return cudaGetLastError();
}

}  // namespace

// The wrappers (kernels/knn.py) check shapes, dtypes and devices, that
// tile is a power of two <= 1024 dividing n, band <= tile and k <= 64.
extern "C" int tc_union_window_a(const float* pts, const float* valid, float* out,
                                 int n, int tile, int k, int band, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16) return launch_a<16>(pts, valid, out, n, tile, k, band, s);
  if (k <= 32) return launch_a<32>(pts, valid, out, n, tile, k, band, s);
  if (k <= 64) return launch_a<64>(pts, valid, out, n, tile, k, band, s);
  return cudaErrorInvalidValue;
}

extern "C" int tc_union_window_b(const float* pts, const float* valid,
                                 const int* pos_a, const float* hi_a, float* out,
                                 int n, int tile, int k, int band, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16) return launch_b<16>(pts, valid, pos_a, hi_a, out, n, tile, k, band, s);
  if (k <= 32) return launch_b<32>(pts, valid, pos_a, hi_a, out, n, tile, k, band, s);
  if (k <= 64) return launch_b<64>(pts, valid, pos_a, hi_a, out, n, tile, k, band, s);
  return cudaErrorInvalidValue;
}
