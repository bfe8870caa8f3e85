// Fused FPFH window kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels spfh_a_tiles, spfh_b_tiles,
// fpfh_weight_a_tiles, fpfh_weight_b_tiles, spfh_band_a_tiles and
// spfh_band_b_tiles of threecrate_tpu/kernels/fpfh_pallas.py (bodies
// _pair_hist with _atan2_approx, _weight_body and _spfh_band_body; the
// banded kernels scan only the +-band sorted positions around each
// query, see "Banded stage 1" below). The caller (ops/features.py,
// _fpfh_fused) Morton-sorts the cloud twice and pads it to a multiple of
// the tile; each block then serves one tile of queries against the
// prev/self/next tiles of the sorted order.
//
// Layout: packed rows (R, n) row-major, R = 7 for stage 1 ([x, y, z,
// valid, nx, ny, nz]; the banded pass B 8, with each column's pass-A
// position as fp32) and 37 for stage 2 ([x, y, z, valid, spfh(33)]);
// pass-A positions (n) int32; outputs (34, n) row-major, all in sorted
// order.
//
// Per query, over the 3*tile window candidates with valid & d2 <= r2 &
// d2 > 1e-12 (pass B: and the candidate's pass-A tile more than one tile
// from the query's):
//   stage 1: the PCL pair features (theta, cos phi, cos alpha) binned
//            into 3 x 11 vote counters kept in shared memory, plus the
//            count;
//   stage 2: sum of (1/d) * spfh(candidate) into 33 register
//            accumulators, in column order, plus the count.
//
// Every operation of the features and of the selection is rounded on its
// own (the _rn intrinsics keep nvcc from contracting products into FMAs,
// and 1/sqrt is a correctly rounded division of a correctly rounded
// square root), in the order the plain PyTorch versions (kernels/fpfh.py)
// evaluate them, so the vote and count rows equal theirs bit for bit.
// _atan2_approx is reproduced (tc::atan2_approx in common.cuh), not
// atan2f: its ~5e-3 rad error moves votes across bin edges.
//
// Stage 1 (spfh_a/b, one block a tile) stages the window once as the
// 16-byte records and 16-column boxes of stage 2 below (window.cuh) and
// its normals as one float4 plane. A warp serves 32 queries (256 threads
// a block, looping over larger tiles; a tile narrower than a warp leaves
// lanes idle) and sweeps the window in column order, past the chunks
// whose box lies beyond r2 for all of them. The sweep only selects: a
// lane tests its query against the broadcast record (~15 operations), and
// the warp appends the selected (column, lane) pairs to its ring in
// shared memory in lane order (__ballot_sync and a __popc prefix).
// Whenever the ring holds a warp of pairs, the warp drains one: each lane
// takes a pair, reloads both records and normals (4 LDS.128), forms d and
// d2 again with the sweep's operations and runs the pair features (~165
// instructions), and adds its three votes to the pair's query with shared
// atomics into two 16-bit counters a word (a count is at most 3 * tile <=
// 3072). At the end the warp drains the rest. Integer votes commute, so
// the order of the pairs does not touch the rows. Shared memory: 102 bytes
// a tile column plus 2.4 KB a warp (45 KB at tile 256, 122 KB at 1024).
//
// What bounds it: instruction issue. The earlier one-query-a-thread sweep
// ran the ~165-instruction body for every column that any lane of a warp
// selected (~300 of 768 at r = 0.5 on a 1M LiDAR scan, a query's own
// count being ~98), so two thirds of its lanes idled through it; the ring
// runs ~98 full rounds instead, beside a sweep of ~20 instructions a
// column. Chosen on the H100 at tile 256, 1M points, r = 0.5 and 0.25
// (tools/spfh_variants.py, see PERF.md): the ring over a per-lane mask
// loop that votes its own selections with no atomics (that pays the
// busiest lane's count: 16-40% slower); culling (none: 6-42% slower);
// 16-bit counters (int counters, 64 KB a block: 2-9% slower); 256
// threads (128: 7-17% slower); a cap of 64 registers, 4 blocks an SM
// (uncapped, 72 registers: 6-11% slower); the earlier sweep: 1.7-2.4x.
//
// Banded stage 1 (spfh_band_a/b, replacing spfh_band_a_tiles and
// spfh_band_b_tiles, _spfh_band_body) takes stage 1's ring and counters
// to the +-band sorted positions of each query. A block stages only its
// span, the tile and band columns on each side (352 at tile 256 and
// band 48, against a 3-tile window's 768), once, as 16-byte (x, y, z, w)
// records and a float4 normal plane; w folds the candidate's validity
// into the value its test reads (pass B: its pass-A position, compared
// in fp32 as the Pallas body does). A warp serves 32 consecutive queries
// (256 threads a block, looping over larger tiles) and sweeps their
// 2 * band + 1 offsets kBandSteps (8) a step: a lane tests its query's
// neighbour at each offset (the warp reads 32 consecutive records, one
// LDS.128 each), then the warp appends the step's selections to its ring
// offset by offset (a __ballot_sync and a __popc prefix each) and drains
// it a warp of pairs at a time. The full steps carry no bound checks; the
// last, partial one does. A count is at most 2 * band + 1 <= 2049, so
// 16-bit counters hold it; it is written as the sum of the query's theta
// votes (each pair casts one). Shared memory: 32 bytes a span column
// plus 4.3 KB a warp (46 KB at tile 256 and band 48, 133 KB at tile and
// band 1024).
//
// What bounds it: instruction issue. At r = 0.25 and band 48 on a 1M
// LiDAR scan a warp drains 16.1 (A) and 8.4 (B) rounds; the earlier kernel
// (one query a thread over three staged 7-8-row segments) ran the pair
// body at every offset where a lane of the warp selected, 59.6 (A) and
// 41.1 (B) of 97. The sweep, some 23 instructions a query and offset by
// count (a distance, three tests, a ballot and the ring append), takes half
// of pass A's time and two thirds of pass B's with the staging and the
// rows (a probe without votes: 0.140 / 0.133 ms of 0.277 / 0.208), the
// pair features a third of A's (0.098 ms), the shared atomics nothing.
// Timed on the H100 at tile 256, 1M points, r = 0.25 and band 48
// (tools/spfh_band_variants.py, see PERF.md): 8 offsets a step (1: 26-36%
// slower, 2: 9-11%, 16: 11-12%, 4 and per-lane masks of 32 offsets
// appended lane after lane: within the spread); steps without bound
// checks (checked: 5-7% slower); 256 threads (128: 4-6% slower); a cap
// of 64 registers, 4 blocks an SM (uncapped, 92 registers: 21-24% slower;
// 5 or 6 blocks: within the spread); 16-bit counters (8-bit: within the
// spread); no culling (boxes over the warp's 32 + 2 * band columns swept
// column by column: 29-36% slower); the earlier kernel: 2.2x (A), 2.4x (B).
//
// Stage 2 stages the window once as 16-byte (x, y, z, tag) records and
// the bounding boxes of its 16-column chunks (window.cuh; pass B's tag is
// the column's pass-A tile, so its window test is one integer compare),
// and each segment's SPFH payload in turn as 9 float4 planes (bins
// 4p ... 4p + 3 of every column in plane p): 50 KB at tile 256, 198 KB at
// 1024. A thread serves one query (256 threads a block, looping over
// larger tiles). A query passes over a chunk whose box lies beyond r2
// (tc::chunk_beyond: its fp32 distance bound, shrunk by 2^-15, above r2),
// and a warp when all its queries do; no column of such a chunk could be
// selected, so culling drops only fmaf(0, s, acc) == acc steps. The
// missing prev tile of tile 0 and next tile of the last are staged as not
// valid, boxed at +-inf and never read. In a surviving chunk a candidate
// costs one broadcast LDS.128 and ~15 operations; a selected one 1/sqrt,
// 9 broadcast LDS.128 and 33 FMAs, paid by its warp whenever any lane
// selects it. The sums take the same FMAs in the same column order as the
// one-query-a-thread full sweep, so its rows are kept bit for bit; they
// differ from the plain version's matmul in summation order only.
//
// What bounds it: instruction issue. At r = 0.5 on a 1M LiDAR scan pass A
// selects ~98 of the 768 candidates a query, ~300 a warp, so the 33-FMA
// bodies of the selected candidates take most of the issue and the sweep
// of the chunks that some lane needs the rest; a warp's neighbourhoods
// cover much of its window there, so few chunks are culled. Device
// memory moves ~(4 * 37 * 3 + 136) bytes per query, the payload read once
// per segment and block. The choices, timed on the H100 at tile 256, 1M
// points, r = 0.5 and 0.25 (tools/fpfh_weight_variants.py, see PERF.md):
// 4 blocks an SM, which caps a thread at 64 registers (uncapped, 96
// registers and 2 blocks: 34-39% slower); payload planes (33 scalar
// rows: 6-36% slower); culling (none: 7-26% slower); one segment's
// payload at a time (the whole window's, 124 KB, one block an SM: 2.1x);
// one query a thread (two spill under the cap: 3-4x); 16-column chunks
// (8: 6-11% slower; 32: -2% to +2%).

#include "window.cuh"

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

// The query's normal and the bin scales of stage 1.
struct QueryFrame {
  float n0, n1, n2;
  float theta_scale, cos_scale;
};

__device__ __forceinline__ float theta_scale() {
  return __fdiv_rn(static_cast<float>(kBins), kTwoPi);
}

// The vote rows (theta, cos phi, cos alpha) of one selected pair: the PCL
// pair features of d = c - q (|d|^2 = d2) and the normals of query (f)
// and candidate (cn0..2), binned.
__device__ __forceinline__ int3 pair_bins(float dx, float dy, float dz, float d2,
                                          const QueryFrame& f, float cn0, float cn1,
                                          float cn2) {
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
  return make_int3(bin_of(__fmul_rn(__fadd_rn(f1, kPi), f.theta_scale)),
                   kBins + bin_of(__fmul_rn(__fadd_rn(f2, 1.f), f.cos_scale)),
                   2 * kBins + bin_of(__fmul_rn(__fadd_rn(f3, 1.f), f.cos_scale)));
}

// ---------------------------------------------------------------------------
// Stage 1 (spfh_a/b): rows [theta bins(11), cos phi bins(11), cos alpha
// bins(11), count].

// Window columns under one bounding box (a tile where the tile is
// smaller), threads of a block (at least a warp: lanes past a narrower
// tile select nothing), blocks an SM (which caps a thread's registers),
// entries of a warp's ring of selected pairs, and vote counters a 32-bit
// word (a counter reaches at most 3 * tile <= 3072).
constexpr int kWarp = 32;
constexpr int kSpfhChunk = 16;
constexpr int kSpfhThreads = 256;
constexpr int kSpfhBlocks = 4;
constexpr int kQueue = 64;
constexpr int kVotesPerWord = 2;
constexpr int kVoteBits = 32 / kVotesPerWord;
constexpr int kVoteWords = (kHist + kVotesPerWord - 1) / kVotesPerWord;
// a row of a warp's counters holds one word of each of its 32 queries,
// padded so that one query's rows fall on distinct banks
constexpr int kVoteStride = kWarp + 1;
static_assert(kQueue >= 2 * kWarp && (kQueue & (kQueue - 1)) == 0,
              "a column appends at most a warp of pairs to a ring holding fewer");

// Stage the normals of the prev/self/next tiles as (nx, ny, nz, 0),
// column for column beside tc::stage_records' records; a column outside
// [0, n) is not staged (its record is not valid, so it is never read).
__device__ __forceinline__ void stage_normals(const float* __restrict__ packed, int n,
                                              int tile, float4* nrm) {
  const int t0 = static_cast<int>(blockIdx.x) - 1;
  const int n_t = n / tile;
  for (int j = threadIdx.x; j < 3 * tile; j += blockDim.x) {
    const int ct = t0 + j / tile;
    if (ct < 0 || ct >= n_t) continue;
    const long col = static_cast<long>(t0) * tile + j;
    nrm[j] = make_float4(packed[4L * n + col], packed[5L * n + col], packed[6L * n + col], 0.f);
  }
}

// A warp's selected pairs and votes: a ring of kQueue (column * 32 +
// query lane) entries, appended in column order and lane order and
// drained a warp at a time, and kVoteWords rows of vote counters, query
// lane l in word l of each row.
struct PairQueue {
  int* ring;
  unsigned* votes;
  unsigned head, tail;  // entries drained and appended so far (warp-uniform)
};

__device__ __forceinline__ void add_vote(unsigned* votes, int bin, int lane) {
  atomicAdd(&votes[bin / kVotesPerWord * kVoteStride + lane],
            1u << (kVoteBits * (bin % kVotesPerWord)));
}

__device__ __forceinline__ unsigned read_vote(const unsigned* votes, int bin, int lane) {
  const unsigned w = votes[bin / kVotesPerWord * kVoteStride + lane];
  return kVotesPerWord == 1 ? w
                            : (w >> (kVoteBits * (bin % kVotesPerWord))) & ((1u << kVoteBits) - 1u);
}

// Vote the next k <= kWarp entries of a ring of kRing, one a lane: the
// pair's offsets and d2 again from the staged records, with the sweep's
// operations, its bins, and three shared atomic adds into its query's
// counters. self0 is the window column of the warp's lane-0 query.
template <int kRing = kQueue>
__device__ __forceinline__ void drain(PairQueue& pq, int k, const float4* __restrict__ win,
                                      const float4* __restrict__ nrm, int self0,
                                      float th_scale) {
  __syncwarp();  // the entries are written
  const int lane = threadIdx.x % kWarp;
  if (lane < k) {
    const int e = pq.ring[(pq.head + lane) % kRing];
    const int ql = e % kWarp;
    const int c = e / kWarp;
    const float4 q = win[self0 + ql];
    const float4 b = win[c];
    const float dx = __fsub_rn(b.x, q.x);
    const float dy = __fsub_rn(b.y, q.y);
    const float dz = __fsub_rn(b.z, q.z);
    const float4 qn = nrm[self0 + ql];
    const float4 cn = nrm[c];
    const int3 bins = pair_bins(dx, dy, dz, dot3(dx, dy, dz, dx, dy, dz),
                                QueryFrame{qn.x, qn.y, qn.z, th_scale, 0.5f * kBins}, cn.x,
                                cn.y, cn.z);
    add_vote(pq.votes, bins.x, ql);
    add_vote(pq.votes, bins.y, ql);
    add_vote(pq.votes, bins.z, ql);
  }
  pq.head += k;
  __syncwarp();  // the entries are read before the ring is written again
}

// The sweep over columns c0 ... c0 + chunk - 1: each lane tests its query
// (valid, d2 <= r2, d2 > 1e-12 and, in pass B, the column's pass-A tile
// more than one tile from the query's), the warp appends the selected
// pairs to its ring in lane order, and drains a warp of them whenever the
// ring holds that many.
template <bool kPassB>
__device__ __forceinline__ void sweep_chunk(PairQueue& pq, int c0, int chunk,
                                            const float4* __restrict__ win,
                                            const float4* __restrict__ nrm, float4 q,
                                            int tile_q, bool active, float r2, int self0,
                                            float th_scale, int& cnt) {
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
  for (int c = c0; c < c0 + chunk; ++c) {
    const float4 b = win[c];
    const int tag = __float_as_int(b.w);
    const float d2 = tc::sq_dist(q.x, q.y, q.z, b.x, b.y, b.z);
    bool sel = active && tag >= 0 && d2 <= r2 && d2 > 1e-12f;
    if (kPassB) sel = sel && static_cast<unsigned>(tag - tile_q + 1) > 2u;
    const unsigned ballot = __ballot_sync(~0u, sel);
    if (ballot == 0u) continue;
    if (sel) {
      pq.ring[(pq.tail + __popc(ballot & below)) % kQueue] = c * kWarp + lane;
      ++cnt;
    }
    pq.tail += __popc(ballot);
    if (pq.tail - pq.head >= kWarp) drain(pq, kWarp, win, nrm, self0, th_scale);
  }
}

template <bool kPassB>
__global__ void __launch_bounds__(kSpfhThreads, kSpfhBlocks)
spfh_kernel(const float* __restrict__ packed, const int* __restrict__ pos_a,
            float* __restrict__ out, int n, int tile, float r2) {
  extern __shared__ float4 win[];
  const int chunk = min(kSpfhChunk, tile);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float4* box = win + 3 * tile;
  float4* nrm = box + 2 * tc::n_chunks(3 * tile, chunk);
  unsigned* votes = reinterpret_cast<unsigned*>(nrm + 3 * tile);
  int* rings = reinterpret_cast<int*>(votes + (blockDim.x / kWarp) * kVoteWords * kVoteStride);
  PairQueue pq{rings + warp * kQueue, votes + warp * kVoteWords * kVoteStride, 0u, 0u};
  tc::stage_records(packed, packed + 3L * n, pos_a, n, tile, __ffs(tile) - 1, win);
  stage_normals(packed, n, tile, nrm);
  __syncthreads();
  tc::stage_boxes(win, 3 * tile, chunk, box);
  __syncthreads();
  const float th_scale = theta_scale();

  for (int base = 0; base < tile; base += blockDim.x) {  // block-uniform
    const int i = base + static_cast<int>(threadIdx.x);
    const bool active = i < tile;
    const float4 q = win[tile + min(i, tile - 1)];
    const int tag = __float_as_int(q.w);
    const int tile_q = tag ^ (tag >> 31);
    const int self0 = tile + base + warp * kWarp;
    for (int w = 0; w < kVoteWords; ++w) pq.votes[w * kVoteStride + lane] = 0u;
    pq.head = pq.tail = 0u;
    int cnt = 0;
    // the sweep in column order, past the chunks beyond r2 for every query
    for (int c0 = 0; c0 < 3 * tile; c0 += chunk) {
      const bool beyond =
          !active || tc::chunk_beyond<false>(box, c0 / chunk, q.x, q.y, q.z, r2);
      if (__all_sync(~0u, beyond)) continue;
      sweep_chunk<kPassB>(pq, c0, chunk, win, nrm, q, tile_q, active, r2, self0, th_scale,
                          cnt);
    }
    drain(pq, static_cast<int>(pq.tail - pq.head), win, nrm, self0, th_scale);
    if (active) {
      const long col = static_cast<long>(blockIdx.x) * tile + i;
      for (int b = 0; b < kHist; ++b) {
        out[b * static_cast<long>(n) + col] = static_cast<float>(read_vote(pq.votes, b, lane));
      }
      out[kHist * static_cast<long>(n) + col] = static_cast<float>(cnt);
    }
  }
}

template <bool kPassB>
cudaError_t launch_spfh(const float* packed, const int* pos_a, float* out, int n, int tile,
                        float r2, void* stream) {
  const int chunk = tile < kSpfhChunk ? tile : kSpfhChunk;
  const int threads = tile < kWarp ? kWarp : (tile > kSpfhThreads ? kSpfhThreads : tile);
  const size_t smem =
      (6 * static_cast<size_t>(tile) + 2 * tc::n_chunks(3 * tile, chunk)) * sizeof(float4) +
      static_cast<size_t>(threads / kWarp) * (kVoteWords * kVoteStride + kQueue) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spfh_kernel<kPassB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  spfh_kernel<kPassB><<<n / tile, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, pos_a, out, n, tile, r2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Banded stage 1 (spfh_band_a/b, _spfh_band_body): the candidates of
// query p are the sorted positions p - band ... p + band inside [0, n)
// (band <= tile); pass B also drops |posA_c - posA_q| <= band, on the
// fp32 pass-A positions of packed row 7. Rows as stage 1.

// Threads of a block (at least a warp: lanes past a narrower tile select
// nothing), blocks an SM (which caps a thread's registers), offsets a lane
// tests before the warp appends their selections, and entries of a warp's
// ring (a step appends at most kBandSteps * kWarp pairs to fewer than a
// warp's).
constexpr int kBandThreads = 256;
constexpr int kBandBlocks = 4;
constexpr int kBandSteps = 8;
constexpr int kBandQueue = 512;
static_assert(kBandQueue >= (kBandSteps + 1) * kWarp && (kBandQueue & (kBandQueue - 1)) == 0,
              "a step appends at most kBandSteps warps of pairs to a ring holding fewer");

// Stage the block's span, the sorted columns tile * b - band ... tile *
// b + tile + band - 1, as (x, y, z, w) records with their (nx, ny, nz, 0)
// normals beside them. w carries the candidate side of the selection:
// pass A 0 where the column is valid, pass B the column's pass-A position
// (row 7) there; NaN where it is not valid, so that pass A's w == 0 and
// pass B's |w - posA_q| > band are false exactly where valid_c && (the
// same test on row 7) is. A column outside [0, n) is staged with w = NaN
// and never read from device memory. The query side of the test never
// reads w: a query is served whether it is valid or not.
template <bool kPassB>
__device__ __forceinline__ void stage_span(const float* __restrict__ packed, int n, int tile,
                                           int band, float4* win, float4* nrm) {
  const long c0 = static_cast<long>(blockIdx.x) * tile - band;
  const float nan = __int_as_float(0x7fc00000);
  for (int j = threadIdx.x; j < tile + 2 * band; j += blockDim.x) {
    const long col = c0 + j;
    float4 r = make_float4(0.f, 0.f, 0.f, nan);
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col >= 0 && col < n) {
      const float w = kPassB ? packed[7L * n + col] : 0.f;
      r = make_float4(packed[col], packed[n + col], packed[2L * n + col],
                      packed[3L * n + col] > 0.5f ? w : nan);
      m = make_float4(packed[4L * n + col], packed[5L * n + col], packed[6L * n + col], 0.f);
    }
    win[j] = r;
    nrm[j] = m;
  }
}

// One step of the banded sweep: lane l tests span columns c0 ... c0 +
// kBandSteps - 1 of its query (kFull: all at most last, its last column;
// else those that are), the warp's 32 lanes 32 consecutive records a
// column; then the warp appends the selections column by column, each in
// lane order, and drains while its ring holds a warp of pairs.
template <bool kPassB, bool kFull>
__device__ __forceinline__ void band_step(PairQueue& pq, int c0, int last,
                                          const float4* __restrict__ win,
                                          const float4* __restrict__ nrm, float4 q, float q_pa,
                                          float band_f, float r2, bool active, int self0,
                                          float th_scale) {
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  bool sel[kBandSteps];
  unsigned ballot[kBandSteps];
  unsigned any = 0u;
#pragma unroll
  for (int k = 0; k < kBandSteps; ++k) {
    const float4 b = win[kFull ? c0 + k : min(c0 + k, last)];
    const float d2 = tc::sq_dist(q.x, q.y, q.z, b.x, b.y, b.z);
    const bool cand = kPassB ? fabsf(__fsub_rn(b.w, q_pa)) > band_f : b.w == 0.f;
    sel[k] = active && (kFull || c0 + k <= last) && cand && d2 <= r2 && d2 > 1e-12f;
    ballot[k] = __ballot_sync(~0u, sel[k]);
    any |= ballot[k];
  }
  if (any == 0u) return;
  const int e0 = c0 * kWarp + lane;
#pragma unroll
  for (int k = 0; k < kBandSteps; ++k) {
    if (sel[k]) pq.ring[(pq.tail + __popc(ballot[k] & below)) % kBandQueue] = e0 + k * kWarp;
    pq.tail += __popc(ballot[k]);
  }
  while (pq.tail - pq.head >= kWarp) drain<kBandQueue>(pq, kWarp, win, nrm, self0, th_scale);
}

template <bool kPassB>
__global__ void __launch_bounds__(kBandThreads, kBandBlocks)
spfh_band_kernel(const float* __restrict__ packed, float* __restrict__ out, int n, int tile,
                 int band, float r2) {
  extern __shared__ float4 win[];
  const int span = tile + 2 * band;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float4* nrm = win + span;
  unsigned* votes = reinterpret_cast<unsigned*>(nrm + span);
  int* rings = reinterpret_cast<int*>(votes + (blockDim.x / kWarp) * kVoteWords * kVoteStride);
  PairQueue pq{rings + warp * kBandQueue, votes + warp * kVoteWords * kVoteStride, 0u, 0u};
  stage_span<kPassB>(packed, n, tile, band, win, nrm);
  __syncthreads();
  const float th_scale = theta_scale();
  const float band_f = static_cast<float>(band);

  for (int base = 0; base < tile; base += blockDim.x) {  // block-uniform
    const int i = base + static_cast<int>(threadIdx.x);
    const bool active = i < tile;
    const int qi = min(i, tile - 1);
    const long col = static_cast<long>(blockIdx.x) * tile + qi;
    const float4 q = win[band + qi];  // its x, y, z; w is not the query's
    const float q_pa = kPassB ? packed[7L * n + col] : 0.f;
    const int self0 = band + base + warp * kWarp;
    for (int w = 0; w < kVoteWords; ++w) pq.votes[w * kVoteStride + lane] = 0u;
    pq.head = pq.tail = 0u;
    // the query's span columns qi ... qi + 2 * band, kBandSteps a step
    const int last = qi + 2 * band;
    int c0 = qi;
    for (; c0 + kBandSteps - 1 <= last; c0 += kBandSteps) {
      band_step<kPassB, true>(pq, c0, last, win, nrm, q, q_pa, band_f, r2, active, self0,
                              th_scale);
    }
    if (c0 <= last) {
      band_step<kPassB, false>(pq, c0, last, win, nrm, q, q_pa, band_f, r2, active, self0,
                               th_scale);
    }
    drain<kBandQueue>(pq, static_cast<int>(pq.tail - pq.head), win, nrm, self0, th_scale);
    if (active) {
      // every pair votes once in theta: the count is the sum of its bins
      int cnt = 0;
      for (int b = 0; b < kHist; ++b) {
        const unsigned v = read_vote(pq.votes, b, lane);
        if (b < kBins) cnt += static_cast<int>(v);
        out[b * static_cast<long>(n) + col] = static_cast<float>(v);
      }
      out[kHist * static_cast<long>(n) + col] = static_cast<float>(cnt);
    }
  }
}

template <bool kPassB>
cudaError_t launch_band(const float* packed, float* out, int n, int tile, int band, float r2,
                        void* stream) {
  const int threads = tile < kWarp ? kWarp : (tile > kBandThreads ? kBandThreads : tile);
  const size_t smem =
      2 * static_cast<size_t>(tile + 2 * band) * sizeof(float4) +
      static_cast<size_t>(threads / kWarp) * (kVoteWords * kVoteStride + kBandQueue) *
          sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spfh_band_kernel<kPassB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  spfh_band_kernel<kPassB><<<n / tile, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, out, n, tile, band, r2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Stage 2 (fpfh_weight_a/b): rows [sum (1/d) * spfh(33), count].

// Window columns under one bounding box (a tile where the tile is
// smaller, so that no chunk straddles two segments), threads of a block,
// blocks an SM (which caps a thread at 64 registers), queries a thread,
// and window segments whose payload is staged at a time.
constexpr int kWeightChunk = 16;
constexpr int kWeightThreads = 256;
constexpr int kWeightBlocks = 4;
constexpr int kWeightQueries = 1;
constexpr int kPlaneSegments = 1;
// float4 payload planes: bins 4p ... 4p + 3 in plane p, the last holding
// bin 32 alone
constexpr int kPlanes = (kHist + 3) / 4;
static_assert(kHist == 4 * (kPlanes - 1) + 1, "the last plane holds one bin");

// Stage the SPFH payload of window segments [s0, s0 + kPlaneSegments) as
// kPlanes float4 planes, column j of the staged segments at
// plane[p * kPlaneSegments * tile + j]: neighbouring threads write
// neighbouring 16 bytes. A segment outside [0, n) is not read: its
// records are not valid, so no candidate of it is ever weighted.
__device__ __forceinline__ void stage_payload(const float* __restrict__ packed, int n,
                                              int tile, int s0, float4* plane) {
  const int n_t = n / tile;
  const int stride = kPlaneSegments * tile;
  const int t0 = static_cast<int>(blockIdx.x) - 1 + s0;
  for (int j = threadIdx.x; j < stride; j += blockDim.x) {
    const int ct = t0 + j / tile;
    if (ct < 0 || ct >= n_t) continue;
    const float* spfh = packed + 4L * n + static_cast<long>(t0) * tile + j;
#pragma unroll
    for (int p = 0; p < kPlanes - 1; ++p) {
      const long b = 4L * p;
      plane[p * stride + j] = make_float4(spfh[b * n], spfh[(b + 1) * n], spfh[(b + 2) * n],
                                          spfh[(b + 3) * n]);
    }
    plane[(kPlanes - 1) * stride + j] =
        make_float4(spfh[(kHist - 1) * static_cast<long>(n)], 0.f, 0.f, 0.f);
  }
}

// acc += w * the payload of staged column j, bin by bin in order.
__device__ __forceinline__ void weigh(const float4* __restrict__ plane, int stride, int j,
                                      float w, float* acc) {
#pragma unroll
  for (int p = 0; p < kPlanes - 1; ++p) {
    const float4 s = plane[p * stride + j];
    acc[4 * p] = fmaf(w, s.x, acc[4 * p]);
    acc[4 * p + 1] = fmaf(w, s.y, acc[4 * p + 1]);
    acc[4 * p + 2] = fmaf(w, s.z, acc[4 * p + 2]);
    acc[4 * p + 3] = fmaf(w, s.w, acc[4 * p + 3]);
  }
  acc[kHist - 1] = fmaf(w, plane[(kPlanes - 1) * stride + j].x, acc[kHist - 1]);
}

// One candidate of the sweep: record b (staged column j) is weighted into
// each of the Q queries that selects it: valid, d2 <= r2, d2 > 1e-12 and,
// in pass B, its pass-A tile more than one tile from the query's.
template <bool kPassB, int Q>
__device__ __forceinline__ void weigh_candidate(float4 b, const float4* __restrict__ plane,
                                                int stride, int j, const float* qx,
                                                const float* qy, const float* qz,
                                                const int* tile_q, float r2,
                                                float (*acc)[kHist], int* cnt) {
  const int tag = __float_as_int(b.w);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float d2 = tc::sq_dist(qx[q], qy[q], qz[q], b.x, b.y, b.z);
    bool sel = tag >= 0 && d2 <= r2 && d2 > 1e-12f;
    if (kPassB) sel = sel && static_cast<unsigned>(tag - tile_q[q] + 1) > 2u;
    if (sel) {
      weigh(plane, stride, j, rsqrt_rn(d2), acc[q]);
      ++cnt[q];
    }
  }
}

template <bool kPassB>
__global__ void __launch_bounds__(kWeightThreads, kWeightBlocks)
fpfh_weight_kernel(const float* __restrict__ packed, const int* __restrict__ pos_a,
                   float* __restrict__ out, int n, int tile, float r2) {
  constexpr int Q = kWeightQueries;
  extern __shared__ float4 win[];
  const int chunk = min(kWeightChunk, tile);
  const int stride = kPlaneSegments * tile;
  const int n_t = n / tile;
  float4* box = win + 3 * tile;
  float4* plane = box + 2 * tc::n_chunks(3 * tile, chunk);
  tc::stage_records(packed, packed + 3L * n, pos_a, n, tile, __ffs(tile) - 1, win);
  __syncthreads();
  tc::stage_boxes(win, 3 * tile, chunk, box);
  __syncthreads();

  for (int base = 0; base < tile; base += blockDim.x * Q) {
    // a thread past the tile's end (tile < Q) repeats its last query
    float qx[Q], qy[Q], qz[Q];
    int tile_q[Q], cnt[Q];
    float acc[Q][kHist];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = min(base + static_cast<int>(threadIdx.x) + q * static_cast<int>(blockDim.x),
                        tile - 1);
      const float4 r = win[tile + i];
      qx[q] = r.x;
      qy[q] = r.y;
      qz[q] = r.z;
      const int tag = __float_as_int(r.w);
      tile_q[q] = tag ^ (tag >> 31);
      cnt[q] = 0;
#pragma unroll
      for (int b = 0; b < kHist; ++b) acc[q][b] = 0.f;
    }
    for (int s0 = 0; s0 < 3; s0 += kPlaneSegments) {
      bool staged = false;
      for (int s = s0; s < s0 + kPlaneSegments; ++s) {
        const int ct = static_cast<int>(blockIdx.x) - 1 + s;
        staged = staged || (ct >= 0 && ct < n_t);
      }
      if (!staged) continue;  // block-uniform
      __syncthreads();  // the previous planes are no longer read
      stage_payload(packed, n, tile, s0, plane);
      __syncthreads();
      // the sweep in column order, past the chunks beyond r2 for every query
      const int c_lo = s0 * tile;
      for (int c0 = c_lo; c0 < c_lo + stride; c0 += chunk) {
        bool beyond = true;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          beyond = beyond && tc::chunk_beyond<false>(box, c0 / chunk, qx[q], qy[q], qz[q], r2);
        }
        if (beyond) continue;
#pragma unroll 4
        for (int c = c0; c < c0 + chunk; ++c) {
          weigh_candidate<kPassB, Q>(win[c], plane, stride, c - c_lo, qx, qy, qz, tile_q, r2,
                                     acc, cnt);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = base + static_cast<int>(threadIdx.x) + q * static_cast<int>(blockDim.x);
      if (i >= tile) continue;
      const long col = static_cast<long>(blockIdx.x) * tile + i;
#pragma unroll
      for (int b = 0; b < kHist; ++b) out[b * static_cast<long>(n) + col] = acc[q][b];
      out[kHist * static_cast<long>(n) + col] = static_cast<float>(cnt[q]);
    }
  }
}

template <bool kPassB>
cudaError_t launch_weight(const float* packed, const int* pos_a, float* out, int n, int tile,
                          float r2, void* stream) {
  const int chunk = tile < kWeightChunk ? tile : kWeightChunk;
  const size_t smem =
      (3 * static_cast<size_t>(tile) + 2 * tc::n_chunks(3 * tile, chunk) +
       static_cast<size_t>(kPlanes) * kPlaneSegments * tile) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fpfh_weight_kernel<kPassB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = tile / kWeightQueries;
  fpfh_weight_kernel<kPassB>
      <<<n / tile, threads < 1 ? 1 : (threads > kWeightThreads ? kWeightThreads : threads),
         smem, static_cast<cudaStream_t>(stream)>>>(packed, pos_a, out, n, tile, r2);
  return cudaGetLastError();
}

}  // namespace

// The wrappers (kernels/fpfh.py) check shapes, dtypes and devices, that
// tile is a power of two <= 1024 dividing n, 0 <= band <= tile, and the
// shared-memory size; r2 arrives rounded to fp32.
extern "C" int tc_spfh_a(const float* packed, float* out, int n, int tile, float r2,
                         void* stream) {
  return launch_spfh<false>(packed, nullptr, out, n, tile, r2, stream);
}

extern "C" int tc_spfh_b(const float* packed, const int* pos_a, float* out, int n,
                         int tile, float r2, void* stream) {
  return launch_spfh<true>(packed, pos_a, out, n, tile, r2, stream);
}

extern "C" int tc_fpfh_weight_a(const float* packed, float* out, int n, int tile,
                                float r2, void* stream) {
  return launch_weight<false>(packed, nullptr, out, n, tile, r2, stream);
}

extern "C" int tc_fpfh_weight_b(const float* packed, const int* pos_a, float* out,
                                int n, int tile, float r2, void* stream) {
  return launch_weight<true>(packed, pos_a, out, n, tile, r2, stream);
}

extern "C" int tc_spfh_band_a(const float* packed, float* out, int n, int tile, int band,
                              float r2, void* stream) {
  return launch_band<false>(packed, out, n, tile, band, r2, stream);
}

extern "C" int tc_spfh_band_b(const float* packed, float* out, int n, int tile, int band,
                              float r2, void* stream) {
  return launch_band<true>(packed, out, n, tile, band, r2, stream);
}
