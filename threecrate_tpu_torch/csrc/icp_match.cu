// Static-sort ICP correspondence for Hopper (sm_90a).
//
// Replaces the Pallas kernel icp_match_tiles of
// threecrate_tpu/kernels/icp_pallas.py (body _icp_match_kernel). The
// caller (ops/registration.py, _static_corr_setup) Morton-sorts the
// target once and the source once per ICP call; each iteration it picks,
// per source tile, the first of w_tiles consecutive target tiles to
// search (window_start), the tile-mean key's tile in the middle.
//
// Layout: source (4, ns) = [moved x, y, z, valid]; target (4+E, nt) =
// [x, y, z, valid, extra(E)] with invalid targets at 2e19 sentinel
// coordinates, whose squared distance overflows to +inf (so this file
// must not be built with fast math or flush-to-zero); window_start
// (ns / tile) int32 in target tiles. Output (4+E, ns) = [matched x, y, z,
// match-valid, matched extra(E)].
//
// One block per source tile. Each point finds the minimum squared
// distance m over its window's w_tiles*tile target columns (d2 in
// tc::sq_dist's unfused order), the lowest column at m and the number of
// columns at m, and returns that target's payload. Exact ties (duplicate
// targets or equidistant candidates) average their payloads, summed in
// column order, as the Pallas kernel's one-hot matmul does. An
// all-invalid window yields zeros and match-valid 0; an invalid source
// point gets match-valid 0 while its matched payload is still the
// window's nearest, as in the Pallas kernel. The valid row of the target
// is not read: the sentinels make invalid targets unmatchable.
//
// The records body (icp_match_kernel): the block stages its window once
// as 16-byte (x, y, z, tag) records with the bounding boxes of their
// 16-column chunks (tc::stage_boxes) and the E payload rows behind them.
// A target at a sentinel magnitude (kFarTarget) is tagged out of the
// boxes: from every query below kNearQuery its d2 is +inf, and a block
// holding a query at or above it culls nothing. Each thread serves
// kIcpQueries points from one LDS.128 per candidate. A warp sweeps the
// chunks by the box distance of its points' centroid, nearest first (a
// bitonic sort of the chunks across the lanes; with more than 32 chunks
// or a partial warp: the middle tile, which holds the tile-mean key,
// then the tiles after it and those before), and passes over a chunk
// whose fp32 box bound (tc::chunk_beyond<false>, shrunk by kCullMargin)
// already exceeds the running m of every point of the thread. The test
// is not strict: a culled chunk holds no column at or below m, and m
// only falls, so the minimum and the tie count are those of a full sweep
// in column order, and where the minimum is unique, so is its column.
// Ties sum their payloads from column 0 in column order (no column
// before the lowest at m is at m). Where records and payload rows would
// not fit in a block's shared memory (e.g. w_tiles 16 at tile 1024), the
// rows body (icp_match_rows_kernel) scans (3 + E) float rows in column
// order, one point a thread.
//
// What bounds it: fp32 issue. A warp examines the columns of the chunks
// that any of its points' box tests cannot exclude, ~14 operations each
// (d2, two compares and the updates of m, its column and the tie count),
// with a ~20-op box test per chunk and thread. Device memory moves
// ~(16 + 16·w_tiles + out) bytes per point, the window from shared
// memory; wgmma and TMA have no role in a per-point scan.

#include "window.cuh"

namespace {

using tc::chunk_beyond;
using tc::kChunk;
using tc::kInf;
using tc::n_chunks;

using tc::Key;

constexpr float kSentinel = 2e19f;
// Source points a thread serves in the records body.
constexpr int kIcpQueries = 1;
// Whether a warp sweeps its chunks by their box distance to its centroid.
constexpr bool kWarpOrder = true;
// A target with a coordinate of this magnitude or more stays out of the
// boxes; from a query whose coordinates lie below kNearQuery in
// magnitude, its d2 overflows (|dx| > 1.85e19).
constexpr float kFarTarget = kSentinel;
constexpr float kNearQuery = 1e18f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float max_abs(float x, float y, float z) {
  return fmaxf(fmaxf(fabsf(x), fabsf(y)), fabsf(z));
}

// The parent body's payload of a found match: row p of the column at m,
// or the mean over every column at m (summed in column order from first).
__device__ __forceinline__ float tied_mean(const float* row, int stride, int first, int wc,
                                           float m, int ties, float qx, float qy, float qz,
                                           const float* cx, const float* cy, const float* cz,
                                           int step) {
  float v = 0.f;
  for (int j = first; j < wc; ++j) {
    if (tc::sq_dist(qx, qy, qz, cx[j * step], cy[j * step], cz[j * step]) == m) {
      v += row[j * stride];
    }
  }
  return v / static_cast<float>(ties);
}

template <int Q>
__global__ void __launch_bounds__((kMaxThreads + Q - 1) / Q)
icp_match_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const int* __restrict__ window_start, float* __restrict__ out, int ns,
                 int nt, int n_extra, int w_tiles, int tile) {
  extern __shared__ float4 win[];  // wc records, 2 * n_chunks boxes, E rows of wc
  const int wc = w_tiles * tile;
  const int nch = n_chunks(wc, kChunk);
  float4* box = win + wc;
  float* pay = reinterpret_cast<float*>(box + 2 * nch);
  const long start = static_cast<long>(window_start[blockIdx.x]) * tile;
  for (int j = threadIdx.x; j < wc; j += blockDim.x) {
    const long col = start + j;
    const bool in = col >= 0 && col < nt;
    float4 r = make_float4(kSentinel, kSentinel, kSentinel, __int_as_float(-1));
    if (in) {
      r.x = tgt[col];
      r.y = tgt[static_cast<long>(nt) + col];
      r.z = tgt[2L * nt + col];
      r.w = __int_as_float(max_abs(r.x, r.y, r.z) < kFarTarget ? 0 : -1);
    }
    win[j] = r;
    for (int e = 0; e < n_extra; ++e) {
      pay[e * wc + j] = in ? tgt[(4 + e) * static_cast<long>(nt) + col] : 0.f;
    }
  }

  int qi[Q];
  float qx[Q], qy[Q], qz[Q];
  bool near = true;
  const long base = static_cast<long>(blockIdx.x) * tile;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    qi[j] = min(static_cast<int>(threadIdx.x + j * blockDim.x), tile - 1);
    qx[j] = src[base + qi[j]];
    qy[j] = src[ns + base + qi[j]];
    qz[j] = src[2L * ns + base + qi[j]];
    near = near && max_abs(qx[j], qy[j], qz[j]) < kNearQuery;
  }
  __syncthreads();
  tc::stage_boxes(win, wc, kChunk, box);
  const bool cull = __syncthreads_and(near);

  // the chunk order of the warp: with full warps and at most 32 chunks,
  // by the box distance of the warp's centroid, nearest first; else the
  // middle tile first, then the tiles after it and those before
  const int lane = threadIdx.x % 32;
  const bool by_distance = kWarpOrder && nch <= 32 && blockDim.x % 32 == 0;
  Key order = 0;
  if (by_distance) {
    float c[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      c[0] = __fadd_rn(c[0], qx[j]);
      c[1] = __fadd_rn(c[1], qy[j]);
      c[2] = __fadd_rn(c[2], qz[j]);
    }
    float gap2 = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      for (int d = 16; d > 0; d >>= 1) c[a] = __fadd_rn(c[a], __shfl_xor_sync(~0u, c[a], d));
      c[a] = __fmul_rn(c[a], 1.f / (32 * Q));
      const float lo = lane < nch ? (&box[2 * lane].x)[a] : 0.f;
      const float hi = lane < nch ? (&box[2 * lane + 1].x)[a] : 0.f;
      const float g = fmaxf(fmaxf(__fsub_rn(lo, c[a]), __fsub_rn(c[a], hi)), 0.f);
      gap2 = __fadd_rn(gap2, __fmul_rn(g, g));
    }
    order = lane < nch ? (static_cast<Key>(__float_as_uint(gap2)) << 32) | lane : ~0ull;
    order = tc::warp_sort<false>(order, lane);
  }
  const int ch0 = ((w_tiles - 1) / 2) * tile / kChunk;

  float m[Q];
  int first[Q], ties[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    m[j] = kInf;
    first[j] = 0;
    ties[j] = 0;
  }
  for (int i = 0; i < nch; ++i) {
    const int ch = by_distance ? static_cast<int>(__shfl_sync(~0u, order, i) & 31u)
                               : (ch0 + i < nch ? ch0 + i : ch0 + i - nch);
    if (cull) {
      bool beyond = true;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        beyond = beyond && chunk_beyond<false>(box, ch, qx[j], qy[j], qz[j], m[j]);
      }
      if (beyond) continue;
    }
    const int c1 = min(ch * kChunk + kChunk, wc);
#pragma unroll 4
    for (int c = ch * kChunk; c < c1; ++c) {
      const float4 b = win[c];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        // m, a column at m and the number of columns at m
        const float s = tc::sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z);
        const bool lt = s < m[j];
        ties[j] = lt ? 1 : ties[j] + (s == m[j]);
        first[j] = lt ? c : first[j];
        m[j] = lt ? s : m[j];
      }
    }
  }

  const float* rx = reinterpret_cast<const float*>(win);  // records as 4 interleaved rows
  const float* ry = rx + 1;
  const float* rz = rx + 2;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i >= tile) continue;
    const long col = base + i;
    const bool found = m[j] < kInf;
    out[3L * ns + col] = (src[3L * ns + col] > 0.5f && found) ? 1.f : 0.f;
    for (int p = 0; p < 3 + n_extra; ++p) {
      // rows x, y, z from the records (stride 4 floats), extras from pay
      const float* row = p < 3 ? rx + p : pay + (p - 3) * wc;
      const int stride = p < 3 ? 4 : 1;
      float v = 0.f;
      if (found && ties[j] == 1) {
        v = row[first[j] * stride];
      } else if (found) {
        // no column before the lowest at m is at m: sum from column 0
        v = tied_mean(row, stride, 0, wc, m[j], ties[j], qx[j], qy[j], qz[j], rx, ry, rz, 4);
      }
      const int out_row = p < 3 ? p : p + 1;  // skip the match-valid row
      out[out_row * static_cast<long>(ns) + col] = v;
    }
  }
}

// The rows body: (3 + E) float rows of the window, one point a thread,
// one sweep in column order.
__global__ void icp_match_rows_kernel(const float* __restrict__ src,
                                      const float* __restrict__ tgt,
                                      const int* __restrict__ window_start,
                                      float* __restrict__ out, int ns, int nt, int n_extra,
                                      int w_tiles) {
  extern __shared__ float smem[];  // (3 + E, w_tiles * tile) row-major
  const int tile = blockDim.x;
  const int wc = w_tiles * tile;
  const int n_pay = 3 + n_extra;
  const long start = static_cast<long>(window_start[blockIdx.x]) * tile;
  for (int j = threadIdx.x; j < wc; j += tile) {
    const long col = start + j;
    const bool in = col >= 0 && col < nt;
    for (int r = 0; r < 3; ++r) {
      smem[r * wc + j] = in ? tgt[r * static_cast<long>(nt) + col] : kSentinel;
    }
    for (int e = 0; e < n_extra; ++e) {
      smem[(3 + e) * wc + j] = in ? tgt[(4 + e) * static_cast<long>(nt) + col] : 0.f;
    }
  }
  __syncthreads();

  const long col = static_cast<long>(blockIdx.x) * tile + threadIdx.x;
  const float qx = src[col];
  const float qy = src[ns + col];
  const float qz = src[2L * ns + col];
  const bool src_valid = src[3L * ns + col] > 0.5f;
  const float* cx = smem;
  const float* cy = smem + wc;
  const float* cz = smem + 2 * wc;

  float m = kInf;
  int first = 0;
  int ties = 0;
  for (int j = 0; j < wc; ++j) {
    const float s = tc::sq_dist(qx, qy, qz, cx[j], cy[j], cz[j]);
    if (s < m) {
      m = s;
      first = j;
      ties = 1;
    } else if (s == m) {
      ++ties;
    }
  }
  const bool found = m < kInf;
  out[3L * ns + col] = (src_valid && found) ? 1.f : 0.f;
  for (int p = 0; p < n_pay; ++p) {
    const float* row = smem + p * wc;
    float v = 0.f;
    if (found && ties == 1) {
      v = row[first];
    } else if (found) {
      v = tied_mean(row, 1, first, wc, m, ties, qx, qy, qz, cx, cy, cz, 1);
    }
    const int out_row = p < 3 ? p : p + 1;  // skip the match-valid row
    out[out_row * static_cast<long>(ns) + col] = v;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// The wrapper (kernels/icp.py) checks shapes, dtypes and devices, that
// tile divides ns and nt, and that the rows body's (3 + E) rows fit in a
// block's shared memory.
extern "C" int tc_icp_match(const float* src, const float* tgt,
                            const int* window_start, float* out, int ns, int nt,
                            int rows, int tile, int w_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_extra = rows - 4;
  const size_t wc = static_cast<size_t>(w_tiles) * tile;
  const size_t smem = wc * sizeof(float4) + 2 * n_chunks(static_cast<int>(wc), kChunk) *
                      sizeof(float4) + n_extra * wc * sizeof(float);
  cudaError_t err;
  if (smem <= 227 * 1024) {
    constexpr int Q = kIcpQueries;
    err = allow_smem(icp_match_kernel<Q>, smem);
    if (err != cudaSuccess) return err;
    icp_match_kernel<Q><<<ns / tile, (tile + Q - 1) / Q, smem, s>>>(
        src, tgt, window_start, out, ns, nt, n_extra, w_tiles, tile);
  } else {
    const size_t rows_smem = (3 + n_extra) * wc * sizeof(float);
    err = allow_smem(icp_match_rows_kernel, rows_smem);
    if (err != cudaSuccess) return err;
    icp_match_rows_kernel<<<ns / tile, tile, rows_smem, s>>>(src, tgt, window_start, out,
                                                             ns, nt, n_extra, w_tiles);
  }
  return cudaGetLastError();
}
