// Union-window normal sums and fused window normals for Hopper (sm_90a).
//
// Replaces the Pallas kernels window_union_a_tiles and
// window_union_b_tiles of threecrate_tpu/kernels/knn_pallas.py (bodies
// _union_a_kernel and _union_b_kernel, selection _band_bound), and
// window_normals_tiles (bodies _moments_kernel and _moments_band_kernel,
// eigensolve _normal_from_cov_lanes; see its section below). The callers
// (ops/normals.py: _union_window_sums, _estimate_window_moments)
// Morton-sort the cloud and pad it to a multiple of the tile; each block
// then serves one tile of queries against the prev/self/next tiles of the
// sorted order.
//
// Layout: coordinates (3, n) row-major, validity (n), pass-A positions
// (n) int32, outputs (11, n) row-major, all in sorted order.
//
// Union passes, per query (one thread each, one block per tile, the
// 3-tile window staged in shared memory):
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
                            const int* __restrict__ pos, int n, int tile, Window w) {
  const int t = blockIdx.x;
  const int n_t = n / tile;
  for (int j = threadIdx.x; j < 3 * tile; j += blockDim.x) {
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

// Selection radius of the query in window column tile + i: an upper
// bound with count(d2 <= hi) >= k, within r_band / 2^6 of the k-th
// smallest window distance.
template <int KMAX>
__device__ float band_bound(const Window& w, int tile, int i, int k, int band,
                            float qx, float qy, float qz) {
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
  load_window(pts, valid, nullptr, n, tile, w);
  __syncthreads();

  const int q = tile + threadIdx.x;
  const float qx = w.x[q], qy = w.y[q], qz = w.z[q];
  const float hi = band_bound<KMAX>(w, tile, threadIdx.x, k, band, qx, qy, qz);
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
  load_window(pts, valid, pos_a, n, tile, w);
  __syncthreads();

  const int q = tile + threadIdx.x;
  const float qx = w.x[q], qy = w.y[q], qz = w.z[q];
  const float hib = band_bound<KMAX>(w, tile, threadIdx.x, k, band, qx, qy, qz);
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

// ---------------------------------------------------------------------------
// Fused window normals (window_normals_tiles): selection, covariance and
// the Jacobi eigensolve of each query in one kernel, output rows
// [nx, ny, nz, curvature, count, k-th] (6, n).
//
// A block serves one tile with kNormalThreads threads (fewer for a smaller
// tile), each thread every kNormalThreads-th query, so the exact body's
// register list never limits the tile. Two selection bodies, as the Pallas
// kernel's:
//   band == 0 (_moments_kernel): the k nearest valid window columns, ties
//     to the lowest column, by one sweep that inserts each candidate into a
//     best-first register list before the first strictly smaller entry (the
//     order of the Pallas max-extraction rounds); query-centred sums over
//     the selected; the k-th row is the k-th -d^2 (-inf below k valid).
//   band > 0 (_moments_band_kernel): the union passes' band bound, every
//     window column within it selected; raw moments [1, c, c c^T] in the
//     frame of the tile centre (the mean of the tile's valid queries), the
//     covariance E[cc] - E[c]E[c]; the k-th row is -hi.
// The sums are accumulated in double and rounded once to fp32 (the plain
// version does the same in another order), so they, and everything after
// them, have the plain version's bits except where a double sum lands
// within 2^-53 of an fp32 rounding boundary. Every fp32 operation after
// the sums is rounded on its own in the Pallas body's order.
//
// What bounds it: fp32 ALU, as the union passes. The band body makes the
// union pass's 8 sweeps of 3*tile candidates plus ~560 operations of
// eigensolve per query; the exact body one sweep with a list insertion
// (~KMAX compare-selects) for each candidate that beats the current k-th.
// Device memory traffic is 16 bytes read and 24 written per query.

constexpr int kNormalThreads = 128;

struct Rot {
  float t, c, s;
};

// The annihilating rotation of _normal_from_cov_lanes' rot().
__device__ __forceinline__ Rot jacobi_rot(float apq, float theta_den) {
  const float theta = __fdiv_rn(theta_den, __fmul_rn(2.f, apq == 0.f ? 1.f : apq));
  const float sgn = theta >= 0.f ? 1.f : -1.f;
  float t = __fdiv_rn(
      sgn, __fadd_rn(fabsf(theta), __fsqrt_rn(__fadd_rn(__fmul_rn(theta, theta), 1.f))));
  if (!(fabsf(apq) > 1e-30f)) t = 0.f;
  const float c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(t, t), 1.f)));
  return {t, c, __fmul_rn(t, c)};
}

// (x, y) <- (c x - s y, s x + c y)
__device__ __forceinline__ void turn(float& x, float& y, const Rot& r) {
  const float nx = __fsub_rn(__fmul_rn(r.c, x), __fmul_rn(r.s, y));
  const float ny = __fadd_rn(__fmul_rn(r.s, x), __fmul_rn(r.c, y));
  x = nx;
  y = ny;
}

// Smallest eigenpair of a symmetric 3x3 covariance: 4 cyclic Jacobi sweeps
// of 3 rotations on the trace-scaled matrix, as _normal_from_cov_lanes of
// knn_pallas.py. Returns (nx, ny, nz, curvature = lambda0 / sum lambda).
__device__ __forceinline__ float4 jacobi_normal(float cxx, float cyy, float czz, float cxy,
                                float cxz, float cyz) {
  const float trace = fmaxf(__fadd_rn(__fadd_rn(cxx, cyy), czz), 1e-12f);
  float a00 = __fdiv_rn(cxx, trace), a11 = __fdiv_rn(cyy, trace);
  float a22 = __fdiv_rn(czz, trace), a01 = __fdiv_rn(cxy, trace);
  float a02 = __fdiv_rn(cxz, trace), a12 = __fdiv_rn(cyz, trace);
  float v00 = 1.f, v01 = 0.f, v02 = 0.f;
  float v10 = 0.f, v11 = 1.f, v12 = 0.f;
  float v20 = 0.f, v21 = 0.f, v22 = 1.f;
  for (int sweep = 0; sweep < 4; ++sweep) {
    Rot r = jacobi_rot(a01, __fsub_rn(a11, a00));  // pivot (0, 1)
    float ta = __fmul_rn(r.t, a01);
    a00 = __fsub_rn(a00, ta);
    a11 = __fadd_rn(a11, ta);
    a01 = 0.f;
    turn(a02, a12, r);
    turn(v00, v01, r);
    turn(v10, v11, r);
    turn(v20, v21, r);
    r = jacobi_rot(a02, __fsub_rn(a22, a00));  // pivot (0, 2)
    ta = __fmul_rn(r.t, a02);
    a00 = __fsub_rn(a00, ta);
    a22 = __fadd_rn(a22, ta);
    a02 = 0.f;
    turn(a01, a12, r);
    turn(v00, v02, r);
    turn(v10, v12, r);
    turn(v20, v22, r);
    r = jacobi_rot(a12, __fsub_rn(a22, a11));  // pivot (1, 2)
    ta = __fmul_rn(r.t, a12);
    a11 = __fsub_rn(a11, ta);
    a22 = __fadd_rn(a22, ta);
    a12 = 0.f;
    turn(a01, a02, r);
    turn(v01, v02, r);
    turn(v11, v12, r);
    turn(v21, v22, r);
  }
  const bool m0 = a00 <= a11 && a00 <= a22;
  const bool m1 = !m0 && a11 <= a22;
  const float lam = m0 ? a00 : (m1 ? a11 : a22);
  const float vx = m0 ? v00 : (m1 ? v01 : v02);
  const float vy = m0 ? v10 : (m1 ? v11 : v12);
  const float vz = m0 ? v20 : (m1 ? v21 : v22);
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(fmaxf(tc::dot3(vx, vy, vz, vx, vy, vz), 1e-30f)));
  return make_float4(__fmul_rn(vx, inv), __fmul_rn(vy, inv), __fmul_rn(vz, inv),
                     fmaxf(lam, 0.f));
}

// Covariance E[dd] - E[d]E[d] from the 10 double sums [count, S1(3), S2(6)]
// (xx, yy, zz, xy, xz, yz), each sum rounded once to fp32, then the normal;
// stores the 6 output rows of the query in column col.
__device__ __forceinline__ void emit_normal(const double* g, float last, float* __restrict__ out,
                            int n, long col) {
  const float cnt = static_cast<float>(g[0]);
  const float nn = fmaxf(cnt, 1e-12f);
  const float ex = __fdiv_rn(static_cast<float>(g[1]), nn);
  const float ey = __fdiv_rn(static_cast<float>(g[2]), nn);
  const float ez = __fdiv_rn(static_cast<float>(g[3]), nn);
  const auto cov = [&](int r, float a, float b) {
    return __fsub_rn(__fdiv_rn(static_cast<float>(g[r]), nn), __fmul_rn(a, b));
  };
  const float4 nrm = jacobi_normal(cov(4, ex, ex), cov(5, ey, ey), cov(6, ez, ez),
                                   cov(7, ex, ey), cov(8, ex, ez), cov(9, ey, ez));
  out[col] = nrm.x;
  out[static_cast<long>(n) + col] = nrm.y;
  out[2L * n + col] = nrm.z;
  out[3L * n + col] = nrm.w;
  out[4L * n + col] = cnt;
  out[5L * n + col] = last;
}

__device__ __forceinline__ void add_moments(double* g, float x, float y, float z) {
  g[0] += 1.0;
  g[1] += x;
  g[2] += y;
  g[3] += z;
  g[4] += __fmul_rn(x, x);
  g[5] += __fmul_rn(y, y);
  g[6] += __fmul_rn(z, z);
  g[7] += __fmul_rn(x, y);
  g[8] += __fmul_rn(x, z);
  g[9] += __fmul_rn(y, z);
}

// band == 0: the exact window k-NN of each query.
template <int KMAX>
__global__ void __launch_bounds__(kNormalThreads)
window_normals_exact_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
                            float* __restrict__ out, int n, int tile, int k) {
  extern __shared__ float smem[];
  Window w{smem, smem + 3 * tile, smem + 6 * tile, smem + 9 * tile, nullptr};
  load_window(pts, valid, nullptr, n, tile, w);
  __syncthreads();

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int q = tile + i;
    const float qx = w.x[q], qy = w.y[q], qz = w.z[q];
    float best[KMAX];  // -d^2, best first
    int bcol[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      best[j] = -kInf;
      bcol[j] = 0;
    }
    for (int c = 0; c < 3 * tile; ++c) {
      if (!(w.v[c] > 0.5f)) continue;
      float v = -tc::sq_dist(qx, qy, qz, w.x[c], w.y[c], w.z[c]);
      if (!(v > best[KMAX - 1])) continue;
      int cc = c;
      bool moved = false;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (moved || v > best[j]) {
          const float tv = best[j];
          const int tcol = bcol[j];
          best[j] = v;
          bcol[j] = cc;
          v = tv;
          cc = tcol;
          moved = true;
        }
      }
    }
    double g[10] = {0., 0., 0., 0., 0., 0., 0., 0., 0., 0.};
    float kth = -kInf;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        kth = best[j];
        if (best[j] > -kInf) {
          const int c = bcol[j];
          add_moments(g, __fsub_rn(w.x[c], qx), __fsub_rn(w.y[c], qy),
                      __fsub_rn(w.z[c], qz));
        }
      }
    }
    emit_normal(g, kth, out, n, static_cast<long>(blockIdx.x) * tile + i);
  }
}

// band > 0: every window column within the band bound, in the tile-centre
// frame.
template <int KMAX>
__global__ void __launch_bounds__(kNormalThreads)
window_normals_band_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
                           float* __restrict__ out, int n, int tile, int k, int band) {
  extern __shared__ float smem[];
  double* part = reinterpret_cast<double*>(smem);  // (4, blockDim.x) partial sums
  float* f = reinterpret_cast<float*>(part + 4 * kNormalThreads);
  Window w{f, f + 3 * tile, f + 6 * tile, f + 9 * tile, nullptr};
  load_window(pts, valid, nullptr, n, tile, w);
  __syncthreads();

  // tile centre: the mean of the tile's valid queries, each sum in double
  // (in thread order, then over the threads) rounded once to fp32
  double s[4] = {0., 0., 0., 0.};
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const float v = w.v[tile + i];
    s[0] += __fmul_rn(w.x[tile + i], v);
    s[1] += __fmul_rn(w.y[tile + i], v);
    s[2] += __fmul_rn(w.z[tile + i], v);
    s[3] += v;
  }
  for (int r = 0; r < 4; ++r) part[r * kNormalThreads + threadIdx.x] = s[r];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int r = 0; r < 4; ++r) {
      double tot = 0.;
      for (int j = 0; j < blockDim.x; ++j) tot += part[r * kNormalThreads + j];
      part[r * kNormalThreads] = tot;
    }
  }
  __syncthreads();
  const float nq = fmaxf(static_cast<float>(part[3 * kNormalThreads]), 1.f);
  const float tcx = __fdiv_rn(static_cast<float>(part[0]), nq);
  const float tcy = __fdiv_rn(static_cast<float>(part[kNormalThreads]), nq);
  const float tcz = __fdiv_rn(static_cast<float>(part[2 * kNormalThreads]), nq);

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int q = tile + i;
    const float qx = w.x[q], qy = w.y[q], qz = w.z[q];
    const float hi = band_bound<KMAX>(w, tile, i, k, band, qx, qy, qz);
    double g[10] = {0., 0., 0., 0., 0., 0., 0., 0., 0., 0.};
    for (int c = 0; c < 3 * tile; ++c) {
      if (window_d2(w, c, qx, qy, qz) <= hi) {
        add_moments(g, __fsub_rn(w.x[c], tcx), __fsub_rn(w.y[c], tcy),
                    __fsub_rn(w.z[c], tcz));
      }
    }
    emit_normal(g, -hi, out, n, static_cast<long>(blockIdx.x) * tile + i);
  }
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

template <int KMAX>
cudaError_t launch_normals(const float* pts, const float* valid, float* out, int n,
                           int tile, int k, int band, cudaStream_t stream) {
  const int threads = tile < kNormalThreads ? tile : kNormalThreads;
  const size_t win = 12 * static_cast<size_t>(tile) * sizeof(float);
  cudaError_t err;
  if (band == 0) {
    err = allow_smem(window_normals_exact_kernel<KMAX>, win);
    if (err != cudaSuccess) return err;
    window_normals_exact_kernel<KMAX><<<n / tile, threads, win, stream>>>(pts, valid, out,
                                                                          n, tile, k);
  } else {
    const size_t smem = win + 4 * kNormalThreads * sizeof(double);
    err = allow_smem(window_normals_band_kernel<KMAX>, smem);
    if (err != cudaSuccess) return err;
    window_normals_band_kernel<KMAX><<<n / tile, threads, smem, stream>>>(
        pts, valid, out, n, tile, k, band);
  }
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

// band 0 runs the exact body; band > 0 the band body at max(band, k), as the
// wrapper passes it (kernels/knn.py checks as for the union passes).
extern "C" int tc_window_normals(const float* pts, const float* valid, float* out, int n,
                                 int tile, int k, int band, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16) return launch_normals<16>(pts, valid, out, n, tile, k, band, s);
  if (k <= 32) return launch_normals<32>(pts, valid, out, n, tile, k, band, s);
  if (k <= 64) return launch_normals<64>(pts, valid, out, n, tile, k, band, s);
  return cudaErrorInvalidValue;
}
