// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <limits>

namespace tc {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr float kPi = 3.1415927410125732f;      // float32(pi)
constexpr float kHalfPi = 1.5707963705062866f;  // float32(pi / 2)
constexpr float kTwoPi = 6.2831854820251465f;   // float32(2 pi)

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

// 1/sqrt(max(x, 1e-24)): a correctly rounded division of a correctly
// rounded square root (the plain versions' torch.ones_like(x) /
// torch.sqrt(x)), not the approximate rsqrt instruction.
__device__ __forceinline__ float rsqrt_rn(float x) {
  return __fdiv_rn(1.f, __fsqrt_rn(fmaxf(x, 1e-24f)));
}

// ((a0*b0 + a1*b1) + a2*b2), each operation rounded on its own.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// _atan2_approx of threecrate_tpu/kernels/fpfh_pallas.py: odd minimax
// atan on [0, 1], Horner form, then the quadrant corrections; max error
// ~5e-3 rad. Reproduced rather than atan2f: the error moves votes across
// bin edges, so the bins follow the polynomial.
__device__ __forceinline__ float atan2_approx(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float z = __fdiv_rn(fminf(ax, ay), fmaxf(fmaxf(ax, ay), 1e-30f));
  const float z2 = __fmul_rn(z, z);
  float p = __fmul_rn(z2, 0.0208351f);
  p = __fmul_rn(z2, __fadd_rn(-0.0851330f, p));
  p = __fmul_rn(z2, __fadd_rn(0.1801410f, p));
  p = __fmul_rn(z2, __fadd_rn(-0.3302995f, p));
  float t = __fmul_rn(z, __fadd_rn(0.9998660f, p));
  if (ay > ax) t = __fsub_rn(kHalfPi, t);
  if (x < 0.f) t = __fsub_rn(kPi, t);
  return y < 0.f ? -t : t;
}

}  // namespace tc
