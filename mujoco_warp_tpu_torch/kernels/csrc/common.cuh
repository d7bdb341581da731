// Shared device helpers of the kernels (k1.cu, k4.cu, mass_chain.cu,
// solve.cu, linalg.cu).
//
// Layout: every per-world array in device memory is lanes-last, (rows,
// W) float32, row r of world w at base[r * W + w] (the large-tree mass
// chain's qM and the linalg.cu operands may be world-major instead); the
// kernels copy a block's worlds into shared memory (warp.cuh) and give
// each world one warp.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MWT_MINVAL 1e-15f
#define MWT_BIGW 1e10f

// nv cap of the fused gate (mujoco_warp_tpu_torch/fused/__init__.py,
// checked by the wrappers): the shapes of the factor and substitutions
// the one-warp Newton (K4 and the solve kernel) and the mass chain's
// factor (mass_chain.cuh) instantiate
#define MWT_MAX_NV 64

// row r of world w of a lanes-last array of W columns
#define LANE(ptr, r) (ptr)[(size_t)(r) * W + w]

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// |a| with the squared norm floored at 1e-15 (fused.py _gnorm)
__device__ __forceinline__ float norm3(const float* a) {
  return sqrtf(fmaxf(dot3(a, a), MWT_MINVAL));
}

__device__ __forceinline__ void qmul(const float* u, const float* v,
                                     float* out) {
  float r0 = u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3];
  float r1 = u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2];
  float r2 = u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1];
  float r3 = u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0];
  out[0] = r0;
  out[1] = r1;
  out[2] = r2;
  out[3] = r3;
}

__device__ __forceinline__ void qnormalize(float* q) {
  float n = sqrtf(fmaxf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3],
                        MWT_MINVAL));
  q[0] = q[0] / n;
  q[1] = q[1] / n;
  q[2] = q[2] / n;
  q[3] = q[3] / n;
}

// quaternion -> row-major rotation matrix
__device__ __forceinline__ void q2mat(const float* q, float* R) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1 - 2 * (yy + zz);
  R[1] = 2 * (xy - wz);
  R[2] = 2 * (xz + wy);
  R[3] = 2 * (xy + wz);
  R[4] = 1 - 2 * (xx + zz);
  R[5] = 2 * (yz - wx);
  R[6] = 2 * (xz - wy);
  R[7] = 2 * (yz + wx);
  R[8] = 1 - 2 * (xx + yy);
}

__device__ __forceinline__ void matvec3(const float* R, const float* c,
                                        float* out) {
  for (int r = 0; r < 3; ++r)
    out[r] = R[3 * r] * c[0] + R[3 * r + 1] * c[1] + R[3 * r + 2] * c[2];
}

__device__ __forceinline__ void matTvec3(const float* R, const float* c,
                                         float* out) {
  for (int r = 0; r < 3; ++r)
    out[r] = R[r] * c[0] + R[3 + r] * c[1] + R[6 + r] * c[2];
}
