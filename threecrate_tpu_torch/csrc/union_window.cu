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
// Union passes. A block stages its 3-tile window once in shared memory
// as 16-byte records (x, y, z, tag), so one LDS.128 broadcast gives a
// whole warp a candidate's coordinates and validity (pass B: also its
// pass-A tile). Each thread serves Q = 2 queries of the tile (i and
// i + T for T threads) and tests each candidate it loads against both.
// Per query:
//   1. r2, the k-th smallest squared distance among the +-band sorted
//      neighbours, in a sorted register list;
//   2. the selection sweep: the list restarts as k copies of the float
//      just above r2, and one sweep over the window inserts each
//      candidate that beats the current k-th. The band columns are
//      window columns, so at least k of them lie at or below r2 and the
//      list ends as the window's k smallest: its last entry d_(k).
//      Pallas' bisection asks count(d2 <= mid) >= k, which is exactly
//      d_(k) <= mid for every mid (inf, ties and invalid columns
//      included), so its 6 fp32 halvings of [0, r2] run here in
//      registers against d_(k), with no sweep, and give its radius bit
//      for bit;
//   3. the sums sweep: count, S1 = sum(c - q) and
//      S2 = sum((c - q)(c - q)^T) over the candidates at or below the
//      radius (pass B: with the pass-A tile test).
// The Pallas kernel gets the same sums from a tile-centred moments
// matmul shifted to the query; accumulating around the query directly
// is the same quantity with less cancellation and needs no matmul.
// Distances are formed unfused (tc::sq_dist's order), so radii, counts
// and use_b equal the plain version's; the sums differ in order only.
//
// What bounds it: instruction issue. The first design ran 7 sweeps of
// 3*tile candidates per query (6 bisection counts and the sums), each
// candidate 4 scalar shared loads and ~11 ALU operations: ~15 issued
// instructions per candidate per query, on the SM's one shared-load
// pipe as much as on its ALUs. Now each query makes 2 sweeps of ~12
// issued instructions per candidate (the d2 of 8 unfused operations, a
// compare, and the branch around the list insertion or the sums), and
// the candidate's load and loop overhead are shared by Q queries. On
// top come the list insertions (2 operations per list entry) and the
// sums of selected candidates (10 operations), each in a minority of a
// warp's steps but paid by the whole warp where its queries diverge.
// Q = 2 at every list size: at KMAX 16, Q = 4 needs 96 registers a
// thread against Q = 2's 61, and on the H100 the warps that Q = 2 keeps
// in flight hide the latency of each query's d2 chain better than
// wider sharing saves issue (Q = 4 and Q = 8 ran slower at k = 10).
// The lists come in 12, 16, 32 and 64 entries (12 serves the default
// k = 10: its insertions cost 24 operations, not 32); at 64 a thread
// holds 128 list registers, and kUnionThreads = 128 threads a block
// keep a block's registers within the SM's at any tile. Device memory
// moves 16-24 bytes in and 44 out per query, and the window (12 KB at
// tile 256) is read from shared memory, not device memory: wgmma and
// TMA have no role in these per-query scans.

#include "common.cuh"

namespace {

using tc::kInf;
// Largest finite radius: a query with fewer than k valid band candidates
// keeps hi = inf, and inf <= inf would select invalid candidates.
constexpr float kHiClamp = 3.4e38f;

// Window, load_window, window_d2 and band_bound serve kernel 4 only; they go with its redesign.
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

// Threads of a union block, and the queries each serves per round: a block
// holds kUnionThreads * kUnionQueries queries at a time and loops over
// larger tiles.
constexpr int kUnionThreads = 128;
constexpr int kUnionQueries = 2;

// Stage the prev/self/next tiles as (x, y, z, tag) records; tile 0 has no
// prev and the last tile no next, staged as not valid. The tag is >= 0
// exactly where the column is valid: pass B stores the tile of the
// column's pass-A position there (its complement where not valid, so
// that both stay readable as tag ^ (tag >> 31)), pass A 0 (-1).
__device__ void stage_records(const float* __restrict__ pts,
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

// Insert v into the ascending list b, dropping its largest entry. Every
// entry is computed from the old list, so the 2 * KMAX operations carry
// no dependency chain.
template <int KMAX>
__device__ __forceinline__ void insert_sorted(float* b, float v) {
#pragma unroll
  for (int m = KMAX - 1; m > 0; --m) b[m] = fminf(b[m], fmaxf(b[m - 1], v));
  b[0] = fminf(b[0], v);
}

// Union pass A (PASS_B false): rows [cnt, S1(3), S2(6), hiA].
// Union pass B (PASS_B true) over the shifted-lattice order. Where
// hiB < hiA (pass A's window was poor) it emits the full pass-B window
// sums at hiB, to be used alone; otherwise the sums within hiA over
// candidates OUTSIDE the query's pass-A window (|posA tile - query posA
// tile| > 1), which add to pass A's sums. Rows [S_out(10), use_b].
//
// The register list of each query is right-aligned: KMAX - k entries of
// -inf ahead of the k smallest distances, so that its last entry is the
// k-th smallest for any k <= KMAX.
template <int KMAX, bool PASS_B>
__global__ void __launch_bounds__(kUnionThreads)
union_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
             const int* __restrict__ pos_a, const float* __restrict__ hi_a,
             float* __restrict__ out, int n, int tile, int k, int band) {
  constexpr int Q = kUnionQueries;
  extern __shared__ float4 win[];
  const int shift = __ffs(tile) - 1;  // log2(tile): tile is a power of two
  stage_records(pts, valid, PASS_B ? pos_a : nullptr, n, tile, shift, win);
  __syncthreads();

  const int w3 = 3 * tile;
  for (int base = 0; base < tile; base += blockDim.x * Q) {
    int qi[Q];
    float qx[Q], qy[Q], qz[Q], r2[Q];
    float best[Q][KMAX];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      // a thread past the tile's end (tile < Q) repeats its last query
      qi[j] = min(base + static_cast<int>(threadIdx.x) + j * static_cast<int>(blockDim.x),
                  tile - 1);
      const float4 r = win[tile + qi[j]];
      qx[j] = r.x;
      qy[j] = r.y;
      qz[j] = r.z;
#pragma unroll
      for (int m = 0; m < KMAX; ++m) best[j][m] = m < KMAX - k ? -kInf : kInf;
      // 1. r2: the k-th smallest over the +-band sorted neighbours
      for (int c = tile + qi[j] - band; c <= tile + qi[j] + band; ++c) {
        const float4 b = win[c];
        const float d = __float_as_int(b.w) >= 0
                            ? tc::sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z)
                            : kInf;
        insert_sorted<KMAX>(best[j], d);
      }
      r2[j] = best[j][KMAX - 1];
      const float seed = nextafterf(r2[j], kInf);
#pragma unroll
      for (int m = 0; m < KMAX; ++m) {
        if (m >= KMAX - k) best[j][m] = seed;
      }
    }

    // 2. the selection sweep: best[j] ends as the window's k smallest
#pragma unroll 2
    for (int c = 0; c < w3; ++c) {
      const float4 b = win[c];
      const bool ok = __float_as_int(b.w) >= 0;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float d = tc::sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z);
        if (ok && d < best[j][KMAX - 1]) insert_sorted<KMAX>(best[j], d);
      }
    }
    float hi[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      // the 6 bisection rounds: count(d2 <= mid) >= k  <=>  d_(k) <= mid
      const float dk = best[j][KMAX - 1];
      float lo = 0.f;
      float h = r2[j];
      for (int round = 0; round < 6; ++round) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, h));
        if (dk <= mid) {
          h = mid;
        } else {
          lo = mid;
        }
      }
      hi[j] = fminf(h, kHiClamp);
    }

    // 3. the sums sweep
    float thr[Q];
    int tile_q[Q];
    bool use_b[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      thr[j] = hi[j];
      use_b[j] = true;
      tile_q[j] = 0;
      if constexpr (PASS_B) {
        const float hia = hi_a[static_cast<long>(blockIdx.x) * tile + qi[j]];
        use_b[j] = hi[j] < hia;
        thr[j] = use_b[j] ? hi[j] : hia;
        const int tq = __float_as_int(win[tile + qi[j]].w);
        tile_q[j] = tq ^ (tq >> 31);
      }
    }
    float s[Q][10];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
#pragma unroll
      for (int r = 0; r < 10; ++r) s[j][r] = 0.f;
    }
#pragma unroll 2
    for (int c = 0; c < w3; ++c) {
      const float4 b = win[c];
      const int tag = __float_as_int(b.w);
      const bool ok = tag >= 0;
      const int tile_c = tag ^ (tag >> 31);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float dx = __fsub_rn(b.x, qx[j]);
        const float dy = __fsub_rn(b.y, qy[j]);
        const float dz = __fsub_rn(b.z, qz[j]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        bool sel = (ok ? d2 : kInf) <= thr[j];
        if constexpr (PASS_B) {
          // outside the query's pass-A window: |tile_c - tile_q| > 1
          sel = sel && (use_b[j] || static_cast<unsigned>(tile_c - tile_q[j] + 1) > 2u);
        }
        if (sel) accumulate(s[j], dx, dy, dz);
      }
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int i = base + static_cast<int>(threadIdx.x) + j * static_cast<int>(blockDim.x);
      if (i >= tile) continue;
      const long col = static_cast<long>(blockIdx.x) * tile + i;
#pragma unroll
      for (int r = 0; r < 10; ++r) out[r * static_cast<long>(n) + col] = s[j][r];
      out[10L * n + col] = PASS_B ? (use_b[j] ? 1.f : 0.f) : hi[j];
    }
  }
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
//   band > 0 (_moments_band_kernel): band_bound (the union passes' radius
//     by 6 bisection sweeps, as the Pallas kernel computes it), every
//     window column within it selected; raw moments [1, c, c c^T] in the
//     frame of the tile centre (the mean of the tile's valid queries), the
//     covariance E[cc] - E[c]E[c]; the k-th row is -hi.
// The sums are accumulated in double and rounded once to fp32 (the plain
// version does the same in another order), so they, and everything after
// them, have the plain version's bits except where a double sum lands
// within 2^-53 of an fp32 rounding boundary. Every fp32 operation after
// the sums is rounded on its own in the Pallas body's order.
//
// What bounds it: instruction issue. The band body makes band_bound's 7
// sweeps and a sums sweep of 3*tile candidates plus ~560 operations of
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

template <int KMAX, bool PASS_B>
cudaError_t launch_union(const float* pts, const float* valid, const int* pos_a,
                         const float* hi_a, float* out, int n, int tile, int k, int band,
                         cudaStream_t stream) {
  int threads = tile / kUnionQueries;
  threads = threads < 1 ? 1 : (threads > kUnionThreads ? kUnionThreads : threads);
  const size_t smem = 3 * static_cast<size_t>(tile) * sizeof(float4);
  cudaError_t err = allow_smem(union_kernel<KMAX, PASS_B>, smem);
  if (err != cudaSuccess) return err;
  union_kernel<KMAX, PASS_B><<<n / tile, threads, smem, stream>>>(pts, valid, pos_a, hi_a,
                                                                   out, n, tile, k, band);
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
  if (k <= 12)
    return launch_union<12, false>(pts, valid, nullptr, nullptr, out, n, tile, k, band, s);
  if (k <= 16)
    return launch_union<16, false>(pts, valid, nullptr, nullptr, out, n, tile, k, band, s);
  if (k <= 32)
    return launch_union<32, false>(pts, valid, nullptr, nullptr, out, n, tile, k, band, s);
  if (k <= 64)
    return launch_union<64, false>(pts, valid, nullptr, nullptr, out, n, tile, k, band, s);
  return cudaErrorInvalidValue;
}

extern "C" int tc_union_window_b(const float* pts, const float* valid,
                                 const int* pos_a, const float* hi_a, float* out,
                                 int n, int tile, int k, int band, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 12)
    return launch_union<12, true>(pts, valid, pos_a, hi_a, out, n, tile, k, band, s);
  if (k <= 16)
    return launch_union<16, true>(pts, valid, pos_a, hi_a, out, n, tile, k, band, s);
  if (k <= 32)
    return launch_union<32, true>(pts, valid, pos_a, hi_a, out, n, tile, k, band, s);
  if (k <= 64)
    return launch_union<64, true>(pts, valid, pos_a, hi_a, out, n, tile, k, band, s);
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
