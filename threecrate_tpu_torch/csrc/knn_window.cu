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
// tile of the last tile, and the query's own id under exclude_self) are
// -inf. Once a query's finite candidates are used up, every further
// Pallas round picks window column 0 again (the chosen columns are -inf
// by then too), so -inf slots report column 0's id and coordinates. The
// window is staged as the Pallas BlockSpecs cut it: the prev tile of
// tile 0 and the next tile of the last tile are the edge tile itself.
//
// Per query (one block per tile of up to 128 threads, each thread serving
// every 128th query of the tile, so the register lists below never limit
// the tile): one sweep over the
// 3*tile window columns in column order, inserting each finite candidate
// into a best-first register list of KMAX entries before the first
// strictly smaller entry, so equal values stay in column order. The list
// is an insert-and-shift chain
// with static indices, so it lives in registers: 78 and 138 of them at
// KMAX = 16 and 32, all 255 with a 68-byte spill at 64, and a 2.4 KB
// spill at 128 (nvcc -Xptxas -v, sm_90a). A candidate no better than the
// last entry skips the chain. d^2 is
// (dx*dx + dy*dy) + dz*dz with dx = q - c, each operation rounded on its
// own (tc::sq_dist), as the plain PyTorch version computes it, so both
// give the same bits.
//
// What bounds it: the list insertion, ~KMAX compare-selects for each
// candidate that beats the current k-th (most of them early in the sweep,
// few later); distances are ~9 operations per candidate from shared
// memory (warp-wide broadcasts). Device memory traffic is ~20 bytes read
// and (8 + 12 with coordinates) * k bytes written per query. Sharing the
// candidate tests across queries (a warp-level selection) is later work.

#include "common.cuh"

namespace {

using tc::kInf;

constexpr int kThreads = 128;  // threads per block; a thread serves tile / 128 queries

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
knn_window_kernel(const float* __restrict__ pts, const float* __restrict__ valid,
                  const int* __restrict__ ids, float* __restrict__ neg_out,
                  int* __restrict__ idx_out, float* __restrict__ crd_out, int n,
                  int tile, int k, int with_coords, int exclude_self) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int n_t = n / tile;
  float* wx = smem;
  float* wy = smem + 3 * tile;
  float* wz = smem + 6 * tile;
  float* wv = smem + 9 * tile;
  int* wid = reinterpret_cast<int*>(smem + 12 * tile);
  for (int j = threadIdx.x; j < 3 * tile; j += blockDim.x) {
    const int seg = j / tile;
    const int ct = min(max(t - 1 + seg, 0), n_t - 1);
    const bool ok = seg == 1 || (seg == 0 && t > 0) || (seg == 2 && t < n_t - 1);
    const long col = static_cast<long>(ct) * tile + (j - seg * tile);
    wx[j] = pts[col];
    wy[j] = pts[n + col];
    wz[j] = pts[2L * n + col];
    wv[j] = ok ? valid[col] : 0.f;
    wid[j] = ids[col];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int q = tile + i;
    const float qx = wx[q], qy = wy[q], qz = wz[q];
    const int own = wid[q];
    float best[KMAX];  // -d^2, best first; unfilled entries (-inf, column 0)
    int bcol[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      best[j] = -kInf;
      bcol[j] = 0;
    }
    for (int c = 0; c < 3 * tile; ++c) {
      if (!(wv[c] > 0.5f) || (exclude_self && wid[c] == own)) continue;
      float v = -tc::sq_dist(wx[c], wy[c], wz[c], qx, qy, qz);
      if (!(v > best[KMAX - 1])) continue;
      // insert before the first strictly smaller entry, then shift the
      // rest down one by one: a displaced entry must not pass an equal
      // one, or equal values would leave column order
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

    const long col = static_cast<long>(t) * tile + i;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const int c = bcol[j];
        neg_out[j * static_cast<long>(n) + col] = best[j];
        idx_out[j * static_cast<long>(n) + col] = wid[c];
        if (with_coords) {
          crd_out[(3 * j) * static_cast<long>(n) + col] = wx[c];
          crd_out[(3 * j + 1) * static_cast<long>(n) + col] = wy[c];
          crd_out[(3 * j + 2) * static_cast<long>(n) + col] = wz[c];
        }
      }
    }
  }
}

template <int KMAX>
cudaError_t launch(const float* pts, const float* valid, const int* ids, float* neg,
                   int* idx, float* crd, int n, int tile, int k, int with_coords,
                   int exclude_self, cudaStream_t stream) {
  const size_t smem = 15 * static_cast<size_t>(tile) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(knn_window_kernel<KMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  knn_window_kernel<KMAX><<<n / tile, tile < kThreads ? tile : kThreads, smem, stream>>>(
      pts, valid, ids, neg, idx, crd, n, tile, k, with_coords, exclude_self);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels/knn_window.py) checks shapes, dtypes and devices,
// that tile is a power of two <= 1024 dividing n and 1 <= k <= min(128,
// 3 * tile).
extern "C" int tc_knn_window(const float* pts, const float* valid, const int* ids,
                             float* neg, int* idx, float* crd, int n, int tile, int k,
                             int with_coords, int exclude_self, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16)
    return launch<16>(pts, valid, ids, neg, idx, crd, n, tile, k, with_coords,
                      exclude_self, s);
  if (k <= 32)
    return launch<32>(pts, valid, ids, neg, idx, crd, n, tile, k, with_coords,
                      exclude_self, s);
  if (k <= 64)
    return launch<64>(pts, valid, ids, neg, idx, crd, n, tile, k, with_coords,
                      exclude_self, s);
  if (k <= 128)
    return launch<128>(pts, valid, ids, neg, idx, crd, n, tile, k, with_coords,
                       exclude_self, s);
  return cudaErrorInvalidValue;
}
