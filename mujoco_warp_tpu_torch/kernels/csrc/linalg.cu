// Batched Cholesky kernels of the general step:
//  - chol_batched: L with L L^T = A + jitter I, the mass factor qLD of
//    large trees and the Newton H of large constraint systems;
//  - chol_solve: x = (L L^T)^-1 b from a factor (qacc_smooth, and H^-1
//    grad in the large-system Newton);
//  - damped_solve: (M + h diag(damping))^-1 (M qacc), Euler's implicit
//    joint damping: the right-hand side M qacc, the factor of the damped
//    matrix and the two triangular solves in one kernel.
//
// Replace the Pallas kernels mujoco_warp_tpu/pallas/linalg.py
// chol_batched (:65, call :95), chol_solve_batched (:109, call :131) and
// damped_solve_batched (:145, call :180), in both their forms (_chol_tile
// :158 and _chol_solve_tile :176 of pallas/solver.py for n <= 48, the
// loop forms _chol_big :215 and _chol_solve_big :233 beyond): right-
// looking rank-1 updates, pivots rsqrt(max(A_jj, 1e-15)), divisors
// max(L_jj, 1e-15).  The damped system is solved whole, not tree-blocked.
//
// Bound.  chol_batched reads and writes n^2 floats per world: at n 75 and
// 4096 worlds 184 MB, 55 us at 3.35 TB/s; its ~n^3 / 3 flops per world
// (0.6 GFLOP in all) are far below the float32 rate.  chol_solve reads
// n^2 + n and writes n floats per world, damped_solve the same plus the
// factor (at n 75 and 4096 worlds 92 MB each, 28 us).
//
// Design.  chol_batched gives each world one warp: the world's matrix
// (22.5 KB at n 75) is copied from its world-major rows into shared
// memory with an odd row stride (lanes on consecutive rows hit distinct
// banks), factored there with lanes over rows and the column loop serial,
// and written back world-major, so no transpose surrounds the launch; a
// block holds a few worlds.  chol_solve and damped_solve keep one thread
// per world on lanes-last tensors (a dependent chain of ~n^2 and ~n^3 / 3
// loads per thread, latency-bound).

#include "common.cuh"

struct CholBatchedParams {
  int W, n;
  float jitter;
  const float* A;  // (W, n, n) world-major
  float* L;        // (W, n, n) world-major, zero above the diagonal
};

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

// shared-memory row stride of an n x n matrix: odd, so the 32 lanes of a
// warp reading one column touch 32 distinct banks
static __host__ __device__ int chol_stride(int n) { return n | 1; }

static int chol_worlds_per_block(int n) {
  const int bytes = n * chol_stride(n) * (int)sizeof(float);
  int wpb = (96 * 1024) / bytes;
  return wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
}

__global__ void chol_batched_kernel(const CholBatchedParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= p.W) return;
  const int n = p.n, ld = chol_stride(n);
  float* S = smem + (size_t)warp * n * ld;
  const float* A = p.A + (size_t)w * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e - r * n;
    if (c <= r) S[r * ld + c] = r == c ? A[e] + p.jitter : A[e];
  }
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const float piv = rsqrtf(fmaxf(S[j * ld + j], MWT_MINVAL));
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) S[i * ld + j] = S[i * ld + j] * piv;
    __syncwarp();
    // entry (i, k) of the trailing lower triangle loses L_ij L_kj, in
    // column order j as the plain version subtracts them
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = S[i * ld + j];
      for (int k = j + 1; k <= i; ++k)
        S[i * ld + k] = S[i * ld + k] - lij * S[k * ld + j];
    }
    __syncwarp();
  }
  float* L = p.L + (size_t)w * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e - r * n;
    L[e] = c <= r ? S[r * ld + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(128) chol_solve_kernel(
    const CholSolveParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  float b[MWT_LINALG_MAX_N], x[MWT_LINALG_MAX_N];
  for (int i = 0; i < p.n; ++i) b[i] = LANE(p.b, i);
  chol_solve_lanes<MWT_LINALG_MAX_N>(p.L, b, x, p.n, W, w);
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
  float a[MWT_LINALG_MAX_N], rhs[MWT_LINALG_MAX_N], x[MWT_LINALG_MAX_N];
  for (int k = 0; k < n; ++k) a[k] = LANE(p.a, k);
  for (int i = 0; i < n; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = acc + LANE(p.M, i * n + k) * a[k];
    rhs[i] = acc;
  }
  chol_solve_lanes<MWT_LINALG_MAX_N>(A, rhs, x, n, W, w);
  for (int i = 0; i < n; ++i) LANE(p.x, i) = x[i];
}

extern "C" {

int mwt_chol_batched_params_size() { return (int)sizeof(CholBatchedParams); }

int mwt_chol_solve_params_size() { return (int)sizeof(CholSolveParams); }

int mwt_damped_solve_params_size() { return (int)sizeof(DampedSolveParams); }

// Launch on `stream`; return cudaGetLastError() of the launch.
int mwt_chol_batched_launch(const CholBatchedParams* p, void* stream) {
  const int wpb = chol_worlds_per_block(p->n);
  const size_t bytes = (size_t)wpb * p->n * chol_stride(p->n) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      chol_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p->W + wpb - 1) / wpb;
  chol_batched_kernel<<<blocks, 32 * wpb, bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

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
