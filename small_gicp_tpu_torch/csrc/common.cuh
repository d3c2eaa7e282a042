// Shared device helpers of the port's hand-written kernels.
#pragma once

#include <cuda_runtime.h>

namespace sgt {

// "No neighbour yet" distance; finite so that comparisons never see inf.
constexpr float kBig = 3.0e38f;

// Squared distance in the rounding order of the plain PyTorch versions:
// ((dx*dx) + (dy*dy)) + (dz*dz) with every operation rounded on its own
// (no fused multiply-add), so kernel and plain version pick the same
// neighbours bit for bit.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz,
                                         float& dx, float& dy, float& dz) {
  dx = __fsub_rn(ax, bx);
  dy = __fsub_rn(ay, by);
  dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// R·p + t in the plain versions' order: ((r0·x + r1·y) + r2·z) + t.
__device__ __forceinline__ float affine_row(const float* r, float t, float x,
                                            float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)),
                   t);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace sgt
