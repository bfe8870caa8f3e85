// Morton-window k-nearest neighbours for Hopper (sm_90a).
//
// Replaces the Pallas kernel knn_window_tiles of
// threecrate_tpu/kernels/knn_pallas.py (body _kernel). The callers
// (ops/neighbors.py: knn_window, knn_window_sorted, knn_window_cross)
// Morton-sort the cloud and pad it to a multiple of the tile; each block
// then serves one tile of queries against the prev/self/next tiles of the
// sorted order.
//
// Layout: coordinates (3, n) row-major, validity (n), original ids (n)
// int32; outputs -d^2 (k, n), ids (k, n) int32 and, with coordinates,
// (3k, n), all in sorted order.
//
// Selection, as the Pallas kernel's k rounds of max-extraction (each
// round the largest -d^2, the lowest window column among equals): the k
// best window columns ordered by (-d^2 descending, column ascending).
// Invalid columns (validity <= 0.5, the prev tile of tile 0, the next
// tile of the last tile, and under exclude_self every column with the
// query's own id) are -inf. Once a query's finite candidates are used
// up, every further Pallas round picks window column 0 again (the chosen
// columns are -inf by then too), so -inf slots report column 0's id and
// coordinates. The window is staged as the Pallas BlockSpecs cut it: the
// prev tile of tile 0 is the edge tile itself, so that column is read
// from device memory (tc::stage_records stages an edge tile as invalid
// and never reads it). d^2 is tc::sq_dist's, every operation rounded on
// its own as the plain PyTorch version computes it, so both give the
// same bits.
//
// Both bodies stage the window once as 16-byte (x, y, z, tag) records
// with the bounding boxes of their tc::kChunk-column chunks and the ids
// beside them.
//
// The list body (knn_list_kernel, k <= 16): kernel 4's exact selection
// (tc::select_window with columns), one query a thread: the k-th d^2 of
// the +-min(2k, tile) sorted neighbours seeds a right-aligned register
// list of 12 (k <= 12) or 16 entries, then one sweep in column order
// takes each candidate that strictly beats the current k-th, after the
// entries equal to it, past the chunks whose box bound already reaches
// the k-th (no column there could enter). The insertions are deferred:
// a thread queues its candidates' columns (kListQueue a thread, in
// shared memory) and its warp inserts them in rounds, one a thread and
// round, each tested again against the k-th it then faces. A warp so
// pays one insertion a round rather than one for every column that any
// of its 32 queries takes. exclude_self refuses the columns with the
// query's id in both steps.
//
// The warp body (knn_warp_kernel, 16 < k <= 128): one query a warp. A
// candidate is the 64-bit key (d^2 bits, column): d^2 >= 0, so the order
// of the unsigned keys is the slots' order. The warp keeps the KB
// smallest keys so far (KB = k rounded up to 32, 64 or 128) as a sorted
// list, KB / 32 keys a lane; the threshold is its k-th key (none before
// k are kept). Lanes form the d^2 of 32 columns at a time; keys below
// the threshold go to the warp's buffer in shared memory through a
// ballot/popc prefix, and each 32 buffered keys are sorted across the
// lanes (a bitonic network) and merged into the list (one min step and
// KB's half-cleaners). The sweep starts with the ~kSeedPerK * k columns
// around the query (its Morton neighbours), so that the threshold is
// tight early, then covers the rest in column order, past each pair of
// chunks whose box bound exceeds the threshold's d^2 (not strict: a
// column at that d^2 with a lower index still beats the threshold).
// Every window column is either examined or beyond the final k-th, so
// the list ends as the k smallest keys. The slots of kRound queries are
// stored to shared memory and written as coalesced (k, n) rows.
//
// What bounds it: instruction issue. The list body: ~12 operations per
// examined candidate, and ~75 per queued candidate and drain round (the
// insertion into a 12-entry list with its columns). The warp body: ~35
// instructions per group of 32 columns, and per merge of 32 keys ~200
// (15 sorting stages and log2(KB) half-cleaning stages of 64-bit
// compare-exchanges, 2 shuffles, 2 compares and 2 selects each), ~5 a
// query at k = 64. Device memory traffic is ~20 bytes read and (8 + 12
// with coordinates) * k bytes written per query.

#include "window.cuh"

namespace {

using tc::chunk_beyond;
using tc::kChunk;
using tc::kInf;
using tc::n_chunks;
using tc::select_window;
using tc::stage_boxes;
using tc::stage_records;

using tc::exchange;
using tc::Key;
constexpr Key kEmpty = ~0ull;   // no candidate: sorts after every key
constexpr int kThreads = 128;   // list body: threads a block
constexpr int kWarp = 32;
constexpr int kWarps = 8;       // warp body: warps a block
constexpr int kRound = 32;      // warp body: queries whose slots are written together
// warp body: the seed, about kSeedPerK * k columns (whole warps of them)
constexpr int kSeedPerK = 2;
// list body: window columns a thread's queue of deferred insertions holds
constexpr int kListQueue = 32;

// ids of the window's 3 * tile columns, the tiles clamped as the Pallas
// BlockSpecs clamp them
__device__ inline void stage_ids(const int* __restrict__ ids, int n, int tile, int* wid) {
  const int t = blockIdx.x;
  const int n_t = n / tile;
  for (int j = threadIdx.x; j < 3 * tile; j += blockDim.x) {
    const int seg = j / tile;
    const int ct = min(max(t - 1 + seg, 0), n_t - 1);
    wid[j] = ids[static_cast<long>(ct) * tile + (j - seg * tile)];
  }
}

// exclude_self: column c may not enter the list of the query at qc when
// they carry the same id
struct SkipSameId {
  const int* wid;
  __device__ __forceinline__ bool operator()(int c, int qc) const { return wid[c] == wid[qc]; }
};

// The outputs of slot j of query q: -d2 of window column c, its id and
// coordinates, or (-inf, column 0 of the clamped window) where not found.
struct SlotWriter {
  float* neg;
  int* idx;
  float* crd;
  int n;
  const float4* win;
  const int* wid;
  int id0;
  float4 p0;  // column 0's coordinates

  __device__ __forceinline__ void operator()(int j, long q, bool found, float d2, int c) const {
    c = found ? c : 0;
    neg[j * static_cast<long>(n) + q] = found ? -d2 : -kInf;
    idx[j * static_cast<long>(n) + q] = found ? wid[c] : id0;
    if (crd != nullptr) {
      const float4 b = found ? win[c] : p0;
      crd[(3 * j) * static_cast<long>(n) + q] = b.x;
      crd[(3 * j + 1) * static_cast<long>(n) + q] = b.y;
      crd[(3 * j + 2) * static_cast<long>(n) + q] = b.z;
    }
  }
};

// Stages records, ids and boxes; returns the writer of the block's slots.
__device__ inline SlotWriter stage_window(const float* __restrict__ pts,
                                          const float* __restrict__ valid,
                                          const int* __restrict__ ids, float* neg, int* idx,
                                          float* crd, int n, int tile, float4* win,
                                          float4* box, int* wid) {
  stage_records(pts, valid, nullptr, n, tile, __ffs(tile) - 1, win);
  stage_ids(ids, n, tile, wid);
  __syncthreads();
  stage_boxes(win, 3 * tile, kChunk, box);
  __syncthreads();
  const long c0 = static_cast<long>(max(static_cast<int>(blockIdx.x) - 1, 0)) * tile;
  return SlotWriter{neg, idx, crd, n, win, wid, ids[c0],
                    make_float4(pts[c0], pts[n + c0], pts[2L * n + c0], 0.f)};
}

template <int KMAX, bool EXCL>
__global__ void __launch_bounds__(kThreads)
knn_list_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
                const int* __restrict__ ids, float* __restrict__ neg_out,
                int* __restrict__ idx_out, float* __restrict__ crd_out, int n, int tile,
                int k) {
  extern __shared__ float4 win[];
  float4* box = win + 3 * tile;
  int* wid = reinterpret_cast<int*>(box + 2 * n_chunks(3 * tile, kChunk));
  // kListQueue window columns a thread
  unsigned short* queue = reinterpret_cast<unsigned short*>(wid + 3 * tile);
  const SlotWriter out =
      stage_window(pts, valid, ids, neg_out, idx_out, crd_out, n, tile, win, box, wid);
  const float4* cull_box = box;  // nullptr would sweep every chunk

  for (int base = 0; base < tile; base += blockDim.x) {
    int qi[1];
    float qx[1], qy[1], qz[1], r2[1];
    float best[1][KMAX];
    int col[1][KMAX];
    if constexpr (EXCL) {
      select_window<KMAX, 1, true, SkipSameId, kListQueue>(
          win, cull_box, tile, base, k, min(2 * k, tile), qi, qx, qy, qz, best, col, r2,
          SkipSameId{wid}, queue);
    } else {
      select_window<KMAX, 1, true, tc::SkipNone, kListQueue>(
          win, cull_box, tile, base, k, min(2 * k, tile), qi, qx, qy, qz, best, col, r2,
          tc::SkipNone(), queue);
    }
    const int i = base + static_cast<int>(threadIdx.x);
    if (i >= tile) continue;
    const long q = static_cast<long>(blockIdx.x) * tile + i;
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      if (m >= KMAX - k) out(m - (KMAX - k), q, best[0][m] < kInf, best[0][m], col[0][m]);
    }
  }
}

// ---------------------------------------------------------------------------
// The warp body's sorted list: KB = 32 * R keys, key i of the list at
// lane i % 32, register i / 32.

template <int R>
struct WarpList {
  Key best[R];  // the KB smallest keys merged so far, ascending
  Key thr;      // the k-th of them: a key at or above it is no slot
  float thr_d2;
  int cnt;      // keys waiting in the warp's buffer

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) best[r] = kEmpty;
    thr = kEmpty;
    thr_d2 = kInf;
    cnt = 0;
  }

  // Merge 32 new keys, one a lane (kEmpty for none): sorted descending
  // they are the last 32 of a descending list of KB whose others are
  // kEmpty, so one min with the last register and KB's half-cleaners
  // leave best the KB smallest, ascending.
  __device__ __forceinline__ void merge(Key v, int k, int lane) {
    v = tc::warp_sort<true>(v, lane);
    best[R - 1] = v < best[R - 1] ? v : best[R - 1];
#pragma unroll
    for (int d = kWarp * R / 2; d >= kWarp; d >>= 1) {  // partners in this lane
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & (d / kWarp)) continue;
        const Key a = best[r], b = best[r | (d / kWarp)];
        best[r] = b < a ? b : a;
        best[r | (d / kWarp)] = b < a ? a : b;
      }
    }
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1) {            // partners in lane ^ d
#pragma unroll
      for (int r = 0; r < R; ++r) {
        best[r] = exchange(best[r], __shfl_xor_sync(~0u, best[r], d), (lane & d) == 0);
      }
    }
    // register (k - 1) / 32 of lane (k - 1) % 32, by masks: a select chain
    // would become an indexed load of best from local memory
    Key x = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) x |= best[r] & (0ull - static_cast<Key>((k - 1) / kWarp == r));
    thr = __shfl_sync(~0u, x, (k - 1) % kWarp);
    thr_d2 = thr == kEmpty ? kInf : __uint_as_float(static_cast<unsigned>(thr >> 32));
  }

  // Each lane offers one key: those below thr join the buffer in lane
  // order; a full warp of buffered keys is merged.
  __device__ __forceinline__ void offer(Key key, Key* buf, int k, int lane) {
    const bool in = key < thr;
    const unsigned ballot = __ballot_sync(~0u, in);
    if (in) buf[cnt + __popc(ballot & ((1u << lane) - 1u))] = key;
    cnt += __popc(ballot);
    if (cnt >= kWarp) {
      __syncwarp();
      const Key v = buf[lane];
      const Key rest = buf[kWarp + lane];
      __syncwarp();
      cnt -= kWarp;
      if (lane < cnt) buf[lane] = rest;
      merge(v, k, lane);
    }
  }

  // Merge whatever the buffer holds.
  __device__ __forceinline__ void flush(const Key* buf, int k, int lane) {
    if (cnt == 0) return;
    __syncwarp();
    const Key v = lane < cnt ? buf[lane] : kEmpty;
    cnt = 0;
    merge(v, k, lane);
  }
};

// The key of window column c for the query at qc (kEmpty where c is not
// taken, not valid, at an infinite d2 or, with EXCL, of the query's id).
template <bool EXCL>
__device__ __forceinline__ Key window_key(const float4* __restrict__ win,
                                          const int* __restrict__ wid, float4 q, int own,
                                          int c, bool take) {
  if (!take) return kEmpty;
  const float4 b = win[c];
  const float d2 = tc::sq_dist(q.x, q.y, q.z, b.x, b.y, b.z);
  bool ok = __float_as_int(b.w) >= 0 && d2 < kInf;
  if (EXCL) ok = ok && wid[c] != own;
  return ok ? (static_cast<Key>(__float_as_uint(d2)) << 32) | static_cast<unsigned>(c) : kEmpty;
}

template <int KB, bool EXCL>
__global__ void __launch_bounds__(kWarps * kWarp)
knn_warp_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
                const int* __restrict__ ids, float* __restrict__ neg_out,
                int* __restrict__ idx_out, float* __restrict__ crd_out, int n, int tile,
                int k) {
  constexpr int R = KB / kWarp;
  extern __shared__ float4 win[];
  const int w3 = 3 * tile;
  const int nch = n_chunks(w3, kChunk);
  float4* box = win + w3;
  Key* bufs = reinterpret_cast<Key*>(box + 2 * nch);  // kWarps buffers of 2 * kWarp keys
  const int round = min(kRound, tile);
  const int stride = k | 1;                            // a query's slots, padded
  Key* slots = bufs + kWarps * 2 * kWarp;              // (round, stride) keys
  int* wid = reinterpret_cast<int*>(slots + round * stride);
  const SlotWriter out =
      stage_window(pts, valid, ids, neg_out, idx_out, crd_out, n, tile, win, box, wid);

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  Key* buf = bufs + warp * 2 * kWarp;
  // the seed: the nb columns around the query, whole warps of them
  // nearest kSeedPerK * k, and the query's own where excluded
  const int nb = min(max((kSeedPerK * k + kWarp / 2) / kWarp, 1) * kWarp + (EXCL ? 1 : 0), w3);
  for (int r0 = 0; r0 < tile; r0 += round) {
    // a trip count the whole block shares (round is a multiple of kWarps)
    for (int it = 0; it < round / kWarps; ++it) {
      const int qq = it * kWarps + warp;
      const int qc = tile + r0 + qq;  // the query's window column
      const float4 q = win[qc];
      const int own = EXCL ? wid[qc] : 0;
      WarpList<R> L;
      L.init();
      const int lo = min(max(qc - nb / 2, 0), w3 - nb);
      for (int g = 0; g < nb; g += kWarp) {
        L.offer(window_key<EXCL>(win, wid, q, own, lo + g + lane, g + lane < nb), buf, k, lane);
      }
      L.flush(buf, k, lane);
      // the rest in column order, past pairs of chunks beyond thr
      unsigned open = 0u;
      float open_thr = -1.f;
      for (int c0 = 0; c0 < w3; c0 += kWarp) {
        const int ch = c0 / kChunk;
        if (ch % kWarp == 0 || open_thr != L.thr_d2) {
          // lane l tests chunk (ch & ~31) + l against the current threshold
          const int mine = (ch & ~(kWarp - 1)) + lane;
          open = __ballot_sync(
              ~0u, mine < nch && !chunk_beyond<false>(box, mine, q.x, q.y, q.z, L.thr_d2));
          open_thr = L.thr_d2;
        }
        if (((open >> (ch % kWarp)) & 3u) == 0u) continue;
        const int c = c0 + lane;
        L.offer(window_key<EXCL>(win, wid, q, own, c, c < w3 && (c < lo || c >= lo + nb)), buf,
                k, lane);
      }
      L.flush(buf, k, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = r * kWarp + lane;
        if (p < k) slots[qq * stride + p] = L.best[r];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < k * round; e += blockDim.x) {
      const int qq = e % round;
      const Key key = slots[qq * stride + e / round];
      out(e / round, static_cast<long>(blockIdx.x) * tile + r0 + qq, key != kEmpty,
          __uint_as_float(static_cast<unsigned>(key >> 32)), static_cast<int>(key & 0xffffffffu));
    }
    __syncthreads();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Args {
  const float* pts;
  const float* valid;
  const int* ids;
  float* neg;
  int* idx;
  float* crd;
  int n, tile, k;
  bool exclude_self;
  cudaStream_t stream;
};

size_t window_bytes(int tile) {
  return (3 * static_cast<size_t>(tile) + 2 * n_chunks(3 * tile, kChunk)) * sizeof(float4) +
         3 * static_cast<size_t>(tile) * sizeof(int);
}

template <int KMAX>
cudaError_t launch_list(const Args& a) {
  const auto kernel = a.exclude_self ? knn_list_kernel<KMAX, true> : knn_list_kernel<KMAX, false>;
  const size_t threads = a.tile < kThreads ? a.tile : kThreads;
  const size_t smem = window_bytes(a.tile) + threads * kListQueue * sizeof(unsigned short);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n / a.tile, threads, smem, a.stream>>>(
      a.pts, a.valid, a.ids, a.neg, a.idx, a.crd, a.n, a.tile, a.k);
  return cudaGetLastError();
}

template <int KB>
cudaError_t launch_warp(const Args& a) {
  const auto kernel = a.exclude_self ? knn_warp_kernel<KB, true> : knn_warp_kernel<KB, false>;
  const size_t round = a.tile < kRound ? a.tile : kRound;
  const size_t smem = window_bytes(a.tile) +
                      (kWarps * 2 * kWarp + static_cast<size_t>(a.k | 1) * round) * sizeof(Key);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n / a.tile, kWarps * kWarp, smem, a.stream>>>(a.pts, a.valid, a.ids, a.neg,
                                                          a.idx, a.crd, a.n, a.tile, a.k);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels/knn_window.py) checks shapes, dtypes and devices,
// that tile is a power of two <= 1024 dividing n and 1 <= k <= min(128,
// 3 * tile).
extern "C" int tc_knn_window(const float* pts, const float* valid, const int* ids,
                             float* neg, int* idx, float* crd, int n, int tile, int k,
                             int with_coords, int exclude_self, void* stream) {
  const Args a{pts, valid, ids, neg, idx, with_coords ? crd : nullptr, n, tile, k,
               exclude_self != 0, static_cast<cudaStream_t>(stream)};
  if (k <= 12) return launch_list<12>(a);
  if (k <= 16) return launch_list<16>(a);
  if (k <= 32) return launch_warp<32>(a);
  if (k <= 64) return launch_warp<64>(a);
  if (k <= 128) return launch_warp<128>(a);
  return cudaErrorInvalidValue;
}
