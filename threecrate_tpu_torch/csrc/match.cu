// Top-1 search in descriptor space for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves descriptor matching to
// XLA (a matmul and an argmin, or its tiled knn). This is the port's own
// kernel for the match stage (ops/features.py:match_descriptors, through
// kernels/match.py), launched once a direction.
//
// For every query row q it returns the nearest valid database row p and
// its d2 = max(|q|^2 + |p|^2 - 2 q.p, 0), packed as one 64-bit word
// (float_bits(d2) << 32) | p. d2 >= 0 (-0 is stored as +0), so the
// unsigned order of the words is the order by d2, then by row: ties go
// to the lowest row, as torch.argmin's do, and the result does not
// depend on the order in which blocks run. The wrapper fills the output
// with the no-row sentinel (+inf bits, row 0), which is what a query
// whose database holds no valid row keeps.
//
// Layout (built by the wrapper): queries (d, ldq) and database (d, ldn)
// column-major in the descriptor dimension (row k holds dimension k of
// every point), the points padded with zeros to a multiple of 128; the
// queries' squared norms (ldq) and the database's (ldn), +inf where a
// database row is invalid or padding. Such a row's d2 is +inf or NaN and
// loses every comparison below, so it is never chosen, whatever its
// descriptor holds. The norms come from the wrapper's (x * x).sum(1), as
// neighbors.knn computes them; q.p is an fp32 FMA chain over the
// dimensions in order, and (|q|^2 + |p|^2) - 2 q.p is one FMA: 2 q.p is
// exact, so that FMA has the bits of the unfused expression. No TF32, no
// tensor cores, no fast math.
//
// What bounds it: fp32 operations, 2 Q N D of them a direction (Q N D
// FFMA), at 67 TFLOP/s outside the tensor cores. The shape is that of a
// SIMT fp32 GEMM: a block of 256 threads owns 128 queries and walks a
// range of 128-row database tiles; each thread holds an 8 x 8 register
// tile of dot products (rows ty*4.. and 64+ty*4.., columns tx*4.. and
// 64+tx*4.., so each step reads two float4 of queries and two of
// database from shared memory for 64 FFMA). The dimension is swept in
// stages of up to kStageDim, unpadded (D = 33 is one stage, D = 352
// eight); each stage's query and database slices, with the tile's norms,
// are copied into shared memory with cp.async, double-buffered, while
// the previous stage computes. After a tile's last stage the epilogue forms each d2 in
// registers (an add and an FMA), takes each row's minimum over the
// thread's 8 columns, and only where that beats the row's best so far
// walks the 8 columns for the lowest one at the new best: ~3
// instructions a pair against D FFMA. d2 never reaches device memory.
// When its tiles are done a block reduces each row's (d2, row) over the
// 16 threads that share it with shuffles and issues one 64-bit atomicMin
// a query.
//
// Grid: query blocks x database splits. The split count comes from the
// shape alone: enough blocks for kWaves full waves of the card's resident
// blocks (few query blocks, as in a 16,384-query forward pass, split the
// database; 2^20 queries need no split), capped at the database's tiles.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

using tc::kInf;

constexpr int kThreads = 256;
constexpr int kTile = 128;       // queries of a block; database rows of a tile
constexpr int kStageDim = 48;    // descriptor dimensions a stage holds at most
constexpr int kWaves = 16;       // resident-block waves the grid aims for

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

// Issue the copies of stage st: dimensions [k0, k0 + klen) of the block's
// queries and of database tile t, and the tile's norms.
__device__ __forceinline__ void issue_stage(float* s_a, float* s_b, float* s_pn,
                                            const float* at, const float* bt,
                                            const float* pn, int ldq, int ldn, int q0,
                                            int t, int k0, int klen) {
  const int n4 = klen * (kTile / 4);
  for (int e = threadIdx.x; e < n4; e += kThreads) {
    const int k = e / (kTile / 4);
    const int c = (e % (kTile / 4)) * 4;
    copy16(s_a + k * kTile + c, at + static_cast<size_t>(k0 + k) * ldq + q0 + c);
    copy16(s_b + k * kTile + c,
           bt + static_cast<size_t>(k0 + k) * ldn + static_cast<size_t>(t) * kTile + c);
  }
  if (threadIdx.x < kTile / 4)
    copy16(s_pn + threadIdx.x * 4, pn + static_cast<size_t>(t) * kTile + threadIdx.x * 4);
}

__global__ void __launch_bounds__(kThreads, 2)
match_nearest_kernel(const float* __restrict__ at, const float* __restrict__ qn,
                     const float* __restrict__ bt, const float* __restrict__ pn,
                     unsigned long long* __restrict__ out, int q, int ldq, int ldn, int d,
                     int kc, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_qn = smem;
  const int stage_floats = 2 * kc * kTile + kTile;
  float* stage_base = smem + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * n_tiles / gridDim.y);
  const int t_end =
      static_cast<int>(static_cast<long long>(blockIdx.y + 1) * n_tiles / gridDim.y);
  const int nk = (d + kc - 1) / kc;
  const int n_stages = (t_end - t_begin) * nk;

  auto stage_a = [&](int st) { return stage_base + (st & 1) * stage_floats; };
  auto issue = [&](int st) {
    const int kt = st % nk;
    const int k0 = kt * kc;
    float* s_a = stage_a(st);
    issue_stage(s_a, s_a + kc * kTile, s_a + 2 * kc * kTile, at, bt, pn, ldq, ldn, q0,
                t_begin + st / nk, k0, min(kc, d - k0));
  };

  if (tid < kTile / 4) copy16(s_qn + tid * 4, qn + q0 + tid * 4);
  if (n_stages > 0) issue(0);
  __pipeline_commit();

  float acc[8][8];
  float best[8];
  int best_row[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = kInf;
    best_row[i] = 0;
  }

  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) issue(st + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();

    const float* s_a = stage_a(st);
    const float* s_b = s_a + kc * kTile;
    const int kt = st % nk;
    const int klen = min(kc, d - kt * kc);
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    // one step of the FMA chain: dimension k of 8 queries and 8 rows
    auto step = [&](int k) {
      const float* ra = s_a + k * kTile;
      const float* rb = s_b + k * kTile;
      const float4 a0 = *reinterpret_cast<const float4*>(ra + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ra + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(rb + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(rb + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    };
    int k = 0;
    for (; k + 4 <= klen; k += 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) step(k + kk);
    }
    for (; k < klen; ++k) step(k);

    if (kt == nk - 1) {
      // d2 of the tile's pairs; a row's 8 columns are walked only where
      // their minimum beats the row's best (NaN never does)
      const float* s_pn = s_a + 2 * kc * kTile;
      const float4 p0 = *reinterpret_cast<const float4*>(s_pn + tx * 4);
      const float4 p1 = *reinterpret_cast<const float4*>(s_pn + 64 + tx * 4);
      const float4 n0 = *reinterpret_cast<const float4*>(s_qn + ty * 4);
      const float4 n1 = *reinterpret_cast<const float4*>(s_qn + 64 + ty * 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float qq[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
      const int col0 = (t_begin + st / nk) * kTile;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float m = kInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(-2.f, acc[i][j], qq[i] + p[j]);
          m = fminf(m, acc[i][j]);
        }
        if ((m < 0.f ? 0.f : m) < best[i]) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v = acc[i][j] < 0.f ? 0.f : acc[i][j];
            if (v < best[i]) {
              best[i] = v;
              best_row[i] = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // each row's best over the 16 threads of its half-warp, then one
  // atomicMin a query (lane tx = i writes row slot i)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(best[i] + 0.f)) << 32) |
        static_cast<unsigned int>(best_row[i]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
    const int row = q0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (tx == i && row < q) atomicMin(out + row, key);
  }
}

}  // namespace

// at (d, ldq), qn (ldq), bt (d, ldn), pn (ldn) as above; out (q) uint64,
// filled with the sentinel by the caller. ldq, ldn multiples of 128.
extern "C" int tc_match_nearest(const float* at, const float* qn, const float* bt,
                                const float* pn, void* out, int q, int ldq, int ldn, int d,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q <= 0 || ldq < q || ldq % kTile || ldn <= 0 || ldn % kTile || d <= 0)
    return cudaErrorInvalidValue;
  const int kc = min(d, kStageDim);
  const size_t smem = (kTile + 2 * (2 * kc * kTile + kTile)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      match_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, match_nearest_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  const int q_blocks = ldq / kTile;
  const int n_tiles = ldn / kTile;
  const long long want = static_cast<long long>(kWaves) * sms * max(per_sm, 1);
  const int splits =
      static_cast<int>(min(static_cast<long long>(n_tiles),
                           max(1LL, (want + q_blocks - 1) / q_blocks)));
  match_nearest_kernel<<<dim3(q_blocks, splits), kThreads, smem, s>>>(
      at, qn, bt, pn, static_cast<unsigned long long*>(out), q, ldq, ldn, d, kc, n_tiles);
  return cudaGetLastError();
}
