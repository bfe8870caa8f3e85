// The staged windows that the window kernels share: 16-byte candidate
// records and the bounding boxes of their column chunks, with the test
// that lets a sweep pass over a chunk beyond its threshold, the
// one-sweep k-smallest selection of the window kernels' queries, and a
// warp's bitonic sort of 64-bit keys.
#pragma once

#include "common.cuh"

namespace tc {

// The factor that keeps a box's fp32 distance bound below every fp32 d2
// it covers (both carry ~5 roundings of 2^-24).
constexpr float kCullMargin = 1.f - 1.f / 32768.f;

// Window columns under one bounding box in the selection sweeps below.
constexpr int kChunk = 16;

// Chunks of `chunk` columns in a window of `cols` columns.
__host__ __device__ __forceinline__ int n_chunks(int cols, int chunk) {
  return (cols + chunk - 1) / chunk;
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

// Bounding boxes of the valid columns (tag >= 0) of each `chunk`-column
// chunk of the `cols` staged records, as (min, max) record pairs; a chunk
// without a valid column gets min = +inf, max = -inf.
__device__ inline void stage_boxes(const float4* __restrict__ win, int cols, int chunk,
                                   float4* box) {
  for (int ch = threadIdx.x; ch * chunk < cols; ch += blockDim.x) {
    float4 lo = make_float4(kInf, kInf, kInf, 0.f);
    float4 hi = make_float4(-kInf, -kInf, -kInf, 0.f);
    for (int c = ch * chunk; c < min(ch * chunk + chunk, cols); ++c) {
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

// 64-bit sort keys of the warp-wide selections: (d2 bits, column) or
// (distance bits, chunk); d2 >= 0, so the keys order as the floats.
using Key = unsigned long long;

// The key that a lane keeps from a bitonic compare-exchange with its
// partner's o: the smaller where keep_min, else the larger.
__device__ __forceinline__ Key exchange(Key v, Key o, bool keep_min) {
  return (o < v) == keep_min ? o : v;
}

// Sort one key a lane across a full warp (a bitonic network of 15
// compare-exchange stages), ascending by lane or, with DESC, descending.
template <bool DESC>
__device__ __forceinline__ Key warp_sort(Key v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool up = ((lane & size) == 0) != DESC;  // this block ascends
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      v = exchange(v, __shfl_xor_sync(~0u, v, d), ((lane & d) == 0) == up);
    }
  }
  return v;
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

// insert_sorted with the column c of v carried beside it, after the
// entries equal to v.
template <int KMAX>
__device__ __forceinline__ void insert_ranked(float* b, int* col, float v, int c) {
#pragma unroll
  for (int m = KMAX - 1; m > 0; --m) {
    col[m] = b[m] <= v ? col[m] : (b[m - 1] <= v ? c : col[m - 1]);
    b[m] = fminf(b[m], fmaxf(b[m - 1], v));
  }
  col[0] = b[0] <= v ? col[0] : c;
  b[0] = fminf(b[0], v);
}

// The selection's column filter beside the records' validity: skip(c, qc)
// is true where window column c may not enter the list of the query at
// window column qc. SkipNone passes every valid column.
struct SkipNone {
  __device__ __forceinline__ bool operator()(int, int) const { return false; }
};

// One step of the selection sweep: window record b (column c) enters the
// list of each query it strictly beats the k-th of; qc[j] is query j's
// window column.
template <int KMAX, int Q, bool COLS, typename Skip>
__device__ __forceinline__ void select_candidate(float4 b, int c, const int* qc,
                                                 const float* qx, const float* qy,
                                                 const float* qz, float (*best)[KMAX],
                                                 int (*col)[KMAX], Skip skip) {
  const bool ok = __float_as_int(b.w) >= 0;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const float d = sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z);
    if (ok && d < best[j][KMAX - 1] && !skip(c, qc[j])) {
      if constexpr (COLS) {
        insert_ranked<KMAX>(best[j], col[j], d, c);
      } else {
        insert_sorted<KMAX>(best[j], d);
      }
    }
  }
}

// Drain the queues of the deferred sweep (select_window with QUEUE > 0):
// in round i, each thread inserts its queries' i-th queued column where
// it still beats the k-th; mask holds the warp's threads.
template <int KMAX, int Q, bool COLS, int QUEUE>
__device__ __forceinline__ void drain_queue(const float4* __restrict__ win,
                                            const unsigned short* __restrict__ queue, int* qn,
                                            const float* qx, const float* qy, const float* qz,
                                            float (*best)[KMAX], int (*col)[KMAX],
                                            unsigned mask) {
  int most = 0;
#pragma unroll
  for (int j = 0; j < Q; ++j) most = max(most, qn[j]);
  most = __reduce_max_sync(mask, most);
  for (int i = 0; i < most; ++i) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if (i >= qn[j]) continue;
      const int c = queue[(j * QUEUE + i) * blockDim.x + threadIdx.x];
      const float4 b = win[c];
      const float d = sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z);
      if (d < best[j][KMAX - 1]) {
        if constexpr (COLS) {
          insert_ranked<KMAX>(best[j], col[j], d, c);
        } else {
          insert_sorted<KMAX>(best[j], d);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) qn[j] = 0;
}

// The k smallest window d2 of the Q queries of a thread in the round from
// base, in two steps:
//   1. r2[j], the k-th smallest d2 among the +-band sorted neighbours of
//      query j, in a sorted register list;
//   2. the selection sweep: the list restarts as k copies of the float
//      just above r2, and one sweep over the window in column order
//      inserts each candidate that strictly beats the current k-th,
//      after the entries equal to it. The band columns are window
//      columns, so at least k of them lie at or below r2 and the list
//      ends as the window's k smallest, ties to the lowest column.
// Sets qi[j] (window column tile + qi[j]; a thread past the tile's end,
// tile < Q, repeats its last query) and its coordinates (qx, qy, qz)[j];
// best[j] ends as the window's k smallest d2, right-aligned: KMAX - k
// entries of -inf ahead of them, so that the last entry is the k-th for
// any k <= KMAX (with COLS, col[j] holds their columns). win holds the
// window's 3 * tile records. With box the sweep passes over each kChunk
// chunk that lies beyond the current k-th of all Q queries: none of its
// columns could enter. Columns that skip() refuses enter neither step.
//
// With QUEUE > 0 the sweep defers its insertions: a column that beats
// query j's k-th joins j's queue of window columns in shared memory
// (queue: QUEUE entries a query and thread, stride blockDim.x). At each
// chunk where a queue of the warp could overflow in the chunk, and after
// the sweep, the warp drains them in rounds: in round i each thread
// inserts its i-th queued column if it still beats the k-th. A query's
// columns enter in column order, each tested against the k-th of the
// columns before it, so the lists end as the direct sweep's; but the warp
// runs one insertion a round instead of one for every column that any of
// its threads inserts. The culling tests the k-th as of the last drain,
// which only errs towards sweeping a chunk.
template <int KMAX, int Q, bool COLS, typename Skip = SkipNone, int QUEUE = 0>
__device__ __forceinline__ void select_window(const float4* __restrict__ win,
                                              const float4* __restrict__ box, int tile,
                                              int base, int k, int band, int* qi, float* qx,
                                              float* qy, float* qz, float (*best)[KMAX],
                                              int (*col)[KMAX], float* r2,
                                              Skip skip = Skip(),
                                              unsigned short* queue = nullptr) {
  static_assert(QUEUE == 0 || QUEUE >= kChunk, "a queue holds a chunk's columns");
  int qc[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    qi[j] = min(base + static_cast<int>(threadIdx.x) + j * static_cast<int>(blockDim.x),
                tile - 1);
    qc[j] = tile + qi[j];
    const float4 r = win[qc[j]];
    qx[j] = r.x;
    qy[j] = r.y;
    qz[j] = r.z;
#pragma unroll
    for (int m = 0; m < KMAX; ++m) best[j][m] = m < KMAX - k ? -kInf : kInf;
    // 1. r2: the k-th smallest over the +-band sorted neighbours
    for (int c = qc[j] - band; c <= qc[j] + band; ++c) {
      const float4 b = win[c];
      const float d = __float_as_int(b.w) >= 0 && !skip(c, qc[j])
                          ? sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z)
                          : kInf;
      insert_sorted<KMAX>(best[j], d);
    }
    r2[j] = best[j][KMAX - 1];
    const float seed = nextafterf(r2[j], kInf);
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      if (m >= KMAX - k) best[j][m] = seed;
      if constexpr (COLS) col[j][m] = 0;
    }
  }

  // 2. the selection sweep: best[j] ends as the window's k smallest
  const int w3 = 3 * tile;
  if constexpr (QUEUE > 0) {
    // the threads of this warp that the block has
    const int lanes = min(32, static_cast<int>(blockDim.x - (threadIdx.x & ~31u)));
    const unsigned mask = lanes == 32 ? ~0u : (1u << lanes) - 1u;
    int qn[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) qn[j] = 0;
    for (int c0 = 0; c0 < w3; c0 += kChunk) {
      bool full = false;
#pragma unroll
      for (int j = 0; j < Q; ++j) full = full || qn[j] > QUEUE - kChunk;
      if (__any_sync(mask, full)) {
        drain_queue<KMAX, Q, COLS, QUEUE>(win, queue, qn, qx, qy, qz, best, col, mask);
      }
      if (box != nullptr) {
        bool beyond = true;
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          beyond = beyond && chunk_beyond<true>(box, c0 / kChunk, qx[j], qy[j], qz[j],
                                                best[j][KMAX - 1]);
        }
        if (beyond) continue;
      }
      const int c1 = min(c0 + kChunk, w3);
#pragma unroll 4
      for (int c = c0; c < c1; ++c) {
        const float4 b = win[c];
        const bool ok = __float_as_int(b.w) >= 0;
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const float d = sq_dist(qx[j], qy[j], qz[j], b.x, b.y, b.z);
          if (ok && d < best[j][KMAX - 1] && !skip(c, qc[j])) {
            queue[(j * QUEUE + qn[j]) * blockDim.x + threadIdx.x] =
                static_cast<unsigned short>(c);
            ++qn[j];
          }
        }
      }
    }
    drain_queue<KMAX, Q, COLS, QUEUE>(win, queue, qn, qx, qy, qz, best, col, mask);
    return;
  }
  if (box == nullptr) {
#pragma unroll 2
    for (int c = 0; c < w3; ++c) select_candidate<KMAX, Q, COLS>(win[c], c, qc, qx, qy, qz, best, col, skip);
    return;
  }
  for (int c0 = 0; c0 < w3; c0 += kChunk) {
    bool beyond = true;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      beyond = beyond && chunk_beyond<true>(box, c0 / kChunk, qx[j], qy[j], qz[j],
                                            best[j][KMAX - 1]);
    }
    if (beyond) continue;
    const int c1 = min(c0 + kChunk, w3);
#pragma unroll 4
    for (int c = c0; c < c1; ++c) select_candidate<KMAX, Q, COLS>(win[c], c, qc, qx, qy, qz, best, col, skip);
  }
}

}  // namespace tc
