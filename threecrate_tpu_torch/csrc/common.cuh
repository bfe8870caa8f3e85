// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <limits>

namespace tc {

constexpr float kInf = std::numeric_limits<float>::infinity();

// |b - a|^2 with every operation rounded on its own, in the order
// ((dx*dx + dy*dy) + dz*dz). The explicit _rn intrinsics keep nvcc from
// contracting a multiply-add into an FMA, so the kernel's distances have
// the same bits as the plain PyTorch version's elementwise ops, and both
// select exactly the same candidates.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(bx, ax);
  const float dy = __fsub_rn(by, ay);
  const float dz = __fsub_rn(bz, az);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace tc
