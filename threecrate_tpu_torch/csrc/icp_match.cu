// Static-sort ICP correspondence for Hopper (sm_90a).
//
// Replaces the Pallas kernel icp_match_tiles of
// threecrate_tpu/kernels/icp_pallas.py (body _icp_match_kernel). The
// caller (ops/registration.py, _static_corr_setup) Morton-sorts the
// target once and the source once per ICP call; each iteration it picks,
// per source tile, the first of w_tiles consecutive target tiles to
// search (window_start).
//
// Layout: source (4, ns) = [moved x, y, z, valid]; target (4+E, nt) =
// [x, y, z, valid, extra(E)] with invalid targets at 2e19 sentinel
// coordinates, whose squared distance overflows to +inf (so this file
// must not be built with fast math or flush-to-zero); window_start
// (ns / tile) int32 in target tiles. Output (4+E, ns) = [matched x, y, z,
// match-valid, matched extra(E)].
//
// One block per source tile, one thread per source point. The block
// stages its w_tiles*tile target columns (coordinates and extras) in
// shared memory; each thread finds the minimum squared distance and
// returns the payload of that target. Exact ties (duplicate targets or
// equidistant candidates) average their payloads, as the Pallas kernel's
// one-hot matmul does. An all-invalid window yields zeros and
// match-valid 0; an invalid source point gets match-valid 0 while its
// matched payload is still the window's nearest, as in the Pallas kernel.
//
// What bounds it: fp32 ALU, one sweep of w_tiles*tile candidates per
// point (~9 flops each) from broadcast shared-memory reads; device
// memory traffic is ~(16 + 16·w_tiles + out) bytes per point. wgmma/TMA
// are left for later work.

#include "common.cuh"

namespace {

using tc::kInf;
constexpr float kSentinel = 2e19f;

__global__ void icp_match_kernel(const float* __restrict__ src,
                                 const float* __restrict__ tgt,
                                 const int* __restrict__ window_start,
                                 float* __restrict__ out, int ns, int nt,
                                 int n_extra, int w_tiles) {
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
      for (int j = first; j < wc; ++j) {
        if (tc::sq_dist(qx, qy, qz, cx[j], cy[j], cz[j]) == m) v += row[j];
      }
      v /= static_cast<float>(ties);
    }
    const int out_row = p < 3 ? p : p + 1;  // skip the match-valid row
    out[out_row * static_cast<long>(ns) + col] = v;
  }
}

}  // namespace

// The wrapper (kernels/icp.py) checks shapes, dtypes and devices, that
// tile divides ns and nt, and the shared-memory size.
extern "C" int tc_icp_match(const float* src, const float* tgt,
                            const int* window_start, float* out, int ns, int nt,
                            int rows, int tile, int w_tiles, void* stream) {
  const int n_extra = rows - 4;
  const size_t smem = static_cast<size_t>(3 + n_extra) * w_tiles * tile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        icp_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  icp_match_kernel<<<ns / tile, tile, smem, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, window_start, out, ns, nt, n_extra, w_tiles);
  return cudaGetLastError();
}
