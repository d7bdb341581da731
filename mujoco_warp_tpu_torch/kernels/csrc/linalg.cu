// Batched Cholesky solves of the general step, one thread per world:
//  - chol_solve: x = (L L^T)^-1 b from the mass factor qLD (qacc_smooth);
//  - damped_solve: (M + h diag(damping))^-1 (M qacc), Euler's implicit
//    joint damping: the right-hand side M qacc, the factor of the damped
//    matrix and the two triangular solves in one kernel.
//
// Replace the Pallas kernels mujoco_warp_tpu/pallas/linalg.py
// chol_solve_batched (:109, call :131) and damped_solve_batched (:145,
// call :180), both in their unrolled form (_chol_tile :158 and
// _chol_solve_tile :176 of pallas/solver.py: pivots and divisors floored
// at 1e-15).  The damped system is solved whole, not tree-blocked.
//
// Bound.  chol_solve reads nv^2 + nv and writes nv floats per world;
// damped_solve reads nv^2 + nv (and nv damping terms once) and writes nv:
// at nv 13 and 8192 worlds 6.0 MB and 6.0 MB, 1.8 us at 3.35 TB/s; the
// ~nv^2 (solve) and ~nv^3 / 3 (factor) flops per world are far below the
// card's rate.  One thread per world walks a dependent chain of ~nv^2
// (solve) or ~nv^3 / 3 (factor) loads, so both are latency-bound.

#include "common.cuh"

struct CholSolveParams {
  int W, n;
  const float* L;  // (n n, W) lower factor
  const float* b;  // (n, W)
  float* x;        // (n, W)
};

struct DampedSolveParams {
  int W, n;
  const float* M;    // (n n, W)
  const float* a;    // (n, W) qacc
  const float* dmp;  // (n,) h * damping
  float* x;          // (n, W)
  float* scr;        // (n n, W): the damped matrix, factored in place
};

__global__ void __launch_bounds__(128) chol_solve_kernel(
    const CholSolveParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  float b[MWT_MAX_NV], x[MWT_MAX_NV];
  for (int i = 0; i < p.n; ++i) b[i] = LANE(p.b, i);
  chol_solve_lanes(p.L, b, x, p.n, W, w);
  for (int i = 0; i < p.n; ++i) LANE(p.x, i) = x[i];
}

__global__ void __launch_bounds__(128) damped_solve_kernel(
    const DampedSolveParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  const int n = p.n;
  float* A = p.scr;
  for (int i = 0; i < n; ++i)
    for (int k = 0; k <= i; ++k)
      LANE(A, i * n + k) = LANE(p.M, i * n + k) + (i == k ? p.dmp[i] : 0.0f);
  chol_lanes(A, A, n, W, w);
  float a[MWT_MAX_NV], rhs[MWT_MAX_NV], x[MWT_MAX_NV];
  for (int k = 0; k < n; ++k) a[k] = LANE(p.a, k);
  for (int i = 0; i < n; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = acc + LANE(p.M, i * n + k) * a[k];
    rhs[i] = acc;
  }
  chol_solve_lanes(A, rhs, x, n, W, w);
  for (int i = 0; i < n; ++i) LANE(p.x, i) = x[i];
}

extern "C" {

int mwt_chol_solve_params_size() { return (int)sizeof(CholSolveParams); }

int mwt_damped_solve_params_size() { return (int)sizeof(DampedSolveParams); }

// Launch on `stream`; return cudaGetLastError() of the launch.
int mwt_chol_solve_launch(const CholSolveParams* p, void* stream) {
  const int threads = 128;
  const int blocks = (p->W + threads - 1) / threads;
  chol_solve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

int mwt_damped_solve_launch(const DampedSolveParams* p, void* stream) {
  const int threads = 128;
  const int blocks = (p->W + threads - 1) / threads;
  damped_solve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
