// Union-window normal sums and fused window normals for Hopper (sm_90a).
//
// Replaces the Pallas kernels window_union_a_tiles and
// window_union_b_tiles of threecrate_tpu/kernels/knn_pallas.py (bodies
// _union_a_kernel and _union_b_kernel, with their bisection radius), and
// window_normals_tiles (bodies _moments_kernel and _moments_band_kernel,
// eigensolve _normal_from_cov_lanes; see its section below). The callers
// (ops/normals.py: _union_window_sums, _estimate_window_moments)
// Morton-sort the cloud and pad it to a multiple of the tile; each block
// then serves one tile of queries against the prev/self/next tiles of the
// sorted order.
//
// Layout: coordinates (3, n) row-major, validity (n), pass-A positions
// (n) int32, outputs (11, n) or (6, n) row-major, all in sorted order.
//
// Every kernel here stages its 3-tile window once in shared memory as
// 16-byte records (x, y, z, tag), so one LDS.128 broadcast gives a whole
// warp a candidate's coordinates and validity (union pass B: also its
// pass-A tile), and each thread serves Q queries of the tile (i, i + T,
// ... for T threads), testing each candidate it loads against all of
// them. The selection of a query (select_window, band_radius):
//   1. r2, the k-th smallest squared distance among the +-band sorted
//      neighbours, in a sorted register list;
//   2. the selection sweep: the list restarts as k copies of the float
//      just above r2, and one sweep over the window inserts each
//      candidate that strictly beats the current k-th, after the entries
//      equal to it. The band columns are window columns, so at least k of
//      them lie at or below r2 and the list ends as the window's k
//      smallest, ties to the lowest column (the sweep runs in column
//      order): its last entry is d_(k);
//   3. the radius (union passes, kernel 4's band body): Pallas' bisection
//      asks count(d2 <= mid) >= k, which is exactly d_(k) <= mid for
//      every mid (inf, ties and invalid columns included), so its 6 fp32
//      halvings of [0, r2] run here in registers against d_(k), with no
//      sweep, and give its radius bit for bit.
// The lists are right-aligned: KMAX - k entries of -inf ahead of the k
// smallest, so that the last entry is the k-th for any k <= KMAX; they
// come in 12, 16, 32 and 64 entries (12 serves the default k = 10: an
// insertion costs 2 operations per entry, 24 and not 32). Distances are
// formed unfused (tc::sq_dist's order), so radii, counts, k-th rows and
// use_b equal the plain version's bit for bit.
//
// Union passes: a sums sweep adds count, S1 = sum(c - q) and
// S2 = sum((c - q)(c - q)^T) over the candidates at or below the radius
// (pass B: with the pass-A tile test). The Pallas kernel gets the same
// sums from a tile-centred moments matmul shifted to the query;
// accumulating around the query directly is the same quantity with less
// cancellation and needs no matmul. The sums differ from the plain
// version's in order only.
//
// What bounds the union passes: instruction issue. Each query makes 2
// sweeps of ~12 issued instructions per candidate (the d2 of 8 unfused
// operations, a compare, and the branch around the list insertion or the
// sums), and the candidate's load and loop overhead are shared by Q
// queries. On top come the list insertions and the sums of selected
// candidates, each in a minority of a warp's steps but paid by the whole
// warp where its queries diverge. Q = 2 at every list size: at KMAX 16,
// Q = 4 needs 96 registers a thread against Q = 2's 61, and on the H100
// the warps that Q = 2 keeps in flight hide the latency of each query's
// d2 chain better than wider sharing saves issue (Q = 4 and Q = 8 ran
// slower at k = 10). At 64 entries a thread holds 128 list registers,
// and kThreads = 128 threads a block keep a block's registers within the
// SM's at any tile. Device memory moves 16-24 bytes in and 24-44 out per
// query, and the window (12 KB at tile 256) is read from shared memory,
// not device memory: wgmma and TMA have no role in these per-query scans.
// Kernel 4's own note is in its section below.

#include "window.cuh"

namespace {

using tc::chunk_beyond;
using tc::kChunk;
using tc::kInf;
using tc::n_chunks;
using tc::select_window;
using tc::stage_boxes;
using tc::stage_records;

// Largest finite radius: a query with fewer than k valid band candidates
// keeps hi = inf, and inf <= inf would select invalid candidates.
constexpr float kHiClamp = 3.4e38f;

// Threads of a block, and the queries each serves per round in the union
// passes (kQueries) and in both bodies of the fused window normals
// (kNormalQueries): a block holds kThreads * Q queries at a time and
// loops over larger tiles.
constexpr int kThreads = 128;
constexpr int kQueries = 2;
constexpr int kNormalQueries = 1;

// Steps 1-3: the selection radius hi[j] of each of a thread's Q queries,
// clamped to kHiClamp.
template <int KMAX, int Q>
__device__ __forceinline__ void band_radius(const float4* __restrict__ win,
                                            const float4* __restrict__ box, int tile,
                                            int base, int k, int band, int* qi, float* qx,
                                            float* qy, float* qz, float* hi) {
  float best[Q][KMAX];
  float r2[Q];
  select_window<KMAX, Q, false>(win, box, tile, base, k, band, qi, qx, qy, qz, best, nullptr,
                                r2);
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

// Union pass A (PASS_B false): rows [cnt, S1(3), S2(6), hiA].
// Union pass B (PASS_B true) over the shifted-lattice order. Where
// hiB < hiA (pass A's window was poor) it emits the full pass-B window
// sums at hiB, to be used alone; otherwise the sums within hiA over
// candidates OUTSIDE the query's pass-A window (|posA tile - query posA
// tile| > 1), which add to pass A's sums. Rows [S_out(10), use_b].
template <int KMAX, bool PASS_B>
__global__ void __launch_bounds__(kThreads)
union_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
             const int* __restrict__ pos_a, const float* __restrict__ hi_a,
             float* __restrict__ out, int n, int tile, int k, int band) {
  constexpr int Q = kQueries;
  extern __shared__ float4 win[];
  const int shift = __ffs(tile) - 1;  // log2(tile): tile is a power of two
  stage_records(pts, valid, PASS_B ? pos_a : nullptr, n, tile, shift, win);
  __syncthreads();

  const int w3 = 3 * tile;
  for (int base = 0; base < tile; base += blockDim.x * Q) {
    int qi[Q];
    float qx[Q], qy[Q], qz[Q], hi[Q];
    band_radius<KMAX, Q>(win, nullptr, tile, base, k, band, qi, qx, qy, qz, hi);

    // the sums sweep
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
// [nx, ny, nz, curvature, count, k-th] (6, n). Two selection bodies, as
// the Pallas kernel's, both on the staged records:
//   band == 0 (_moments_kernel): the k nearest valid window columns, ties
//     to the lowest column: select_window seeded from a +-min(2k, tile)
//     band, the columns carried in the list (Pallas' max-extraction
//     rounds and the plain version's stable sort give the same order);
//     sums over the k selected, best first, around the query; the k-th
//     row is -d_(k) (-inf below k valid columns).
//   band > 0 (_moments_band_kernel): band_radius at half-width
//     max(band, k), as the wrapper passes it, then one sums sweep over
//     every window column within it, in column order: raw moments
//     [1, c, c c^T] in the frame of the tile centre (the mean of the
//     tile's valid queries), the covariance E[cc] - E[c]E[c]; the k-th
//     row is -hi.
// Both sweeps pass over each 16-column chunk of the window whose
// bounding box (staged beside the records) lies beyond the query's
// current k-th (selection) or hi (sums): none of its columns could enter
// or be selected, so skipping it changes nothing (chunk_beyond's margin
// keeps the fp32 box bound below every fp32 d2 it covers). The sums are
// accumulated in double and rounded once to fp32 (the plain version does
// the same in another order), so they, and everything after them, have
// the plain version's bits except where a double sum lands within 2^-53
// of an fp32 rounding boundary. Every fp32 operation after the sums is
// rounded on its own in the Pallas body's order.
//
// What bounds it: instruction issue, as the union passes. Per query the
// band body makes the +-band seed list, a selection sweep and a sums
// sweep; the exact body the +-2k seed list and one sweep whose list
// carries each entry's column (5 operations per entry and insertion).
// A warp scans a chunk where any of its 32 Morton-adjacent queries needs
// it; a box test costs ~20 operations. A selected candidate's 9
// tile-frame features are widened to double and added with 10 DADDs
// (half the fp32 rate on the H100); the eigensolve is ~550 fp32
// operations. The choices, timed on the H100 at k = 10, tile 256
// (tools/window_normals_variants.py, see PERF.md): one query a thread
// (two ran 2-38% slower: insertions diverge across a thread's queries
// and its registers grow), 16-column chunks (8 and 32 within -1% to
// +6%; no culling 28% slower at band 16, 15% at band 0), chunk loops
// unrolled 4 (2: 1-4% slower), the exact body's seed at +-2k rather than
// +-k (6% faster), lists of 12 for k <= 12 (16 ran 5-41% slower).
// Device memory moves 16 bytes in and 24 out per query.

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

// A tile-frame candidate's 9 moment features (x, y, z, xx, yy, zz, xy, xz,
// yz), each product rounded to fp32, widened to double.
__device__ __forceinline__ void moment_features(double* f, float x, float y, float z) {
  f[0] = x;
  f[1] = y;
  f[2] = z;
  f[3] = __fmul_rn(x, x);
  f[4] = __fmul_rn(y, y);
  f[5] = __fmul_rn(z, z);
  f[6] = __fmul_rn(x, y);
  f[7] = __fmul_rn(x, z);
  f[8] = __fmul_rn(y, z);
}

// g += [1, f]: one selected candidate's moments.
__device__ __forceinline__ void add_features(double* g, const double* f) {
  g[0] += 1.0;
#pragma unroll
  for (int r = 0; r < 9; ++r) g[r + 1] += f[r];
}

__device__ __forceinline__ void add_moments(double* g, float x, float y, float z) {
  double f[9];
  moment_features(f, x, y, z);
  add_features(g, f);
}

// The band body's sums: the window record b joins the tile-frame moments
// g[j] of each query whose radius hi[j] it lies within; its 9 features
// are formed once for the Q queries.
template <int Q>
__device__ __forceinline__ void sum_candidate(float4 b, const float* qx, const float* qy,
                                              const float* qz, const float* hi, float tcx,
                                              float tcy, float tcz, double (*g)[10]) {
  const bool ok = __float_as_int(b.w) >= 0;
  bool sel[Q];
  bool any = false;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    sel[j] = ok && tc::sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z) <= hi[j];
    any = any || sel[j];
  }
  if (!any) return;
  double f[9];
  moment_features(f, __fsub_rn(b.x, tcx), __fsub_rn(b.y, tcy), __fsub_rn(b.z, tcz));
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (sel[j]) add_features(g[j], f);
  }
}

// band == 0: the exact window k-NN of each query.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
window_normals_exact_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
                            float* __restrict__ out, int n, int tile, int k) {
  constexpr int Q = kNormalQueries;
  extern __shared__ float4 win[];
  float4* box = win + 3 * tile;
  stage_records(pts, valid, nullptr, n, tile, __ffs(tile) - 1, win);
  __syncthreads();
  stage_boxes(win, 3 * tile, kChunk, box);
  __syncthreads();

  for (int base = 0; base < tile; base += blockDim.x * Q) {
    int qi[Q];
    float qx[Q], qy[Q], qz[Q], r2[Q];
    float best[Q][KMAX];
    int col[Q][KMAX];
    select_window<KMAX, Q, true>(win, box, tile, base, k, min(2 * k, tile), qi, qx, qy, qz,
                                 best, col, r2);
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int i = base + static_cast<int>(threadIdx.x) + j * static_cast<int>(blockDim.x);
      if (i >= tile) continue;
      // the k selected, best first
      double g[10] = {0., 0., 0., 0., 0., 0., 0., 0., 0., 0.};
#pragma unroll
      for (int m = 0; m < KMAX; ++m) {
        if (m >= KMAX - k && best[j][m] < kInf) {
          const float4 b = win[col[j][m]];
          add_moments(g, __fsub_rn(b.x, qx[j]), __fsub_rn(b.y, qy[j]),
                      __fsub_rn(b.z, qz[j]));
        }
      }
      emit_normal(g, -best[j][KMAX - 1], out, n, static_cast<long>(blockIdx.x) * tile + i);
    }
  }
}

// band > 0: every window column within the band radius, in the tile-centre
// frame.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
window_normals_band_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
                           float* __restrict__ out, int n, int tile, int k, int band) {
  constexpr int Q = kNormalQueries;
  extern __shared__ float4 win[];
  float4* box = win + 3 * tile;
  // (4, kThreads) partial sums of the tile centre
  double* part = reinterpret_cast<double*>(box + 2 * n_chunks(3 * tile, kChunk));
  stage_records(pts, valid, nullptr, n, tile, __ffs(tile) - 1, win);

  // tile centre: the mean of the tile's valid queries, each sum in double
  // (in thread order, then over the threads) rounded once to fp32
  double s[4] = {0., 0., 0., 0.};
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long col = static_cast<long>(blockIdx.x) * tile + i;
    const float v = valid[col];
    s[0] += __fmul_rn(pts[col], v);
    s[1] += __fmul_rn(pts[n + col], v);
    s[2] += __fmul_rn(pts[2L * n + col], v);
    s[3] += v;
  }
  for (int r = 0; r < 4; ++r) part[r * kThreads + threadIdx.x] = s[r];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int r = 0; r < 4; ++r) {
      double tot = 0.;
      for (int j = 0; j < static_cast<int>(blockDim.x); ++j) tot += part[r * kThreads + j];
      part[r * kThreads] = tot;
    }
  }
  stage_boxes(win, 3 * tile, kChunk, box);
  __syncthreads();
  const float nq = fmaxf(static_cast<float>(part[3 * kThreads]), 1.f);
  const float tcx = __fdiv_rn(static_cast<float>(part[0]), nq);
  const float tcy = __fdiv_rn(static_cast<float>(part[kThreads]), nq);
  const float tcz = __fdiv_rn(static_cast<float>(part[2 * kThreads]), nq);

  const int w3 = 3 * tile;
  for (int base = 0; base < tile; base += blockDim.x * Q) {
    int qi[Q];
    float qx[Q], qy[Q], qz[Q], hi[Q];
    band_radius<KMAX, Q>(win, box, tile, base, k, band, qi, qx, qy, qz, hi);

    // the sums sweep, in column order, past the chunks beyond every hi[j]
    double g[Q][10];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
#pragma unroll
      for (int r = 0; r < 10; ++r) g[j][r] = 0.;
    }
    for (int c0 = 0; c0 < w3; c0 += kChunk) {
      bool beyond = true;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        beyond = beyond && chunk_beyond<false>(box, c0 / kChunk, qx[j], qy[j], qz[j], hi[j]);
      }
      if (beyond) continue;
      const int c1 = min(c0 + kChunk, w3);
#pragma unroll 4
      for (int c = c0; c < c1; ++c) sum_candidate<Q>(win[c], qx, qy, qz, hi, tcx, tcy, tcz, g);
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int i = base + static_cast<int>(threadIdx.x) + j * static_cast<int>(blockDim.x);
      if (i < tile) emit_normal(g[j], -hi[j], out, n, static_cast<long>(blockIdx.x) * tile + i);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Threads of a block serving a tile, Q queries each.
int block_threads(int tile, int q) {
  const int threads = tile / q;
  return threads < 1 ? 1 : (threads > kThreads ? kThreads : threads);
}

template <int KMAX, bool PASS_B>
cudaError_t launch_union(const float* pts, const float* valid, const int* pos_a,
                         const float* hi_a, float* out, int n, int tile, int k, int band,
                         cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(tile) * sizeof(float4);
  cudaError_t err = allow_smem(union_kernel<KMAX, PASS_B>, smem);
  if (err != cudaSuccess) return err;
  union_kernel<KMAX, PASS_B><<<n / tile, block_threads(tile, kQueries), smem, stream>>>(
      pts, valid, pos_a, hi_a, out, n, tile, k, band);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_normals(const float* pts, const float* valid, float* out, int n,
                           int tile, int k, int band, cudaStream_t stream) {
  const size_t win =
      (3 * static_cast<size_t>(tile) + 2 * n_chunks(3 * tile, kChunk)) * sizeof(float4);
  cudaError_t err;
  if (band == 0) {
    err = allow_smem(window_normals_exact_kernel<KMAX>, win);
    if (err != cudaSuccess) return err;
    window_normals_exact_kernel<KMAX>
        <<<n / tile, block_threads(tile, kNormalQueries), win, stream>>>(pts, valid, out, n,
                                                                          tile, k);
  } else {
    const size_t smem = win + 4 * kThreads * sizeof(double);
    err = allow_smem(window_normals_band_kernel<KMAX>, smem);
    if (err != cudaSuccess) return err;
    window_normals_band_kernel<KMAX>
        <<<n / tile, block_threads(tile, kNormalQueries), smem, stream>>>(pts, valid, out, n,
                                                                           tile, k, band);
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
  if (k <= 12) return launch_normals<12>(pts, valid, out, n, tile, k, band, s);
  if (k <= 16) return launch_normals<16>(pts, valid, out, n, tile, k, band, s);
  if (k <= 32) return launch_normals<32>(pts, valid, out, n, tile, k, band, s);
  if (k <= 64) return launch_normals<64>(pts, valid, out, n, tile, k, band, s);
  return cudaErrorInvalidValue;
}
