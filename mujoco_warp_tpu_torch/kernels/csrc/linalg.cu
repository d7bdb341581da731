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
// factor (at n 75 and 4096 worlds 92 MB each, 28 us).  What bounds them
// on the card is each world's dependent chain: n column steps of the
// factor, then n steps of each substitution.
//
// Design.  Every kernel gives each world one warp and holds the world's
// matrix in shared memory (warp.cuh): the factor (chol_warp) computes two
// columns at a time by dot products, a row per lane and every lane's dot
// products of the same length, so the lanes share the work evenly, the
// two substitutions (chol_subst) keep the vector in registers spread over
// the lanes, and both run in the plain version's order (the factor: entry
// (i, j) loses L_im L_jm in column order m; forward: column j updates rows
// i > j; back: row i updates columns k < i), so with --fmad=false kernel
// and plain version round alike.  chol_batched copies each world's lower
// triangle (world-major, contiguous per world) with cp.async into a
// packed triangle, 11.4 KB at n 75, so an SM holds 20 worlds (5 per
// block), and writes L world-major.  chol_solve and damped_solve hold the
// matrix at an odd row stride (the 32 lanes of a warp reading one column
// hit 32 distinct banks), a few worlds per block, as many as fit twice in
// an SM's shared memory (at n 75: 4), and take each input at a world
// stride and an element stride, so they read a world-major factor and a
// world() view of a lanes-last one in place: the block copies its worlds'
// matrices with cp.async, the world or the element as the fastest thread
// index, whichever lies closer in memory, so the loads stay coalesced in
// both layouts, and writes x world-major.  A block barrier ends the loads
// and begins the stores, and every thread reaches both, a warp past W
// included.

#include "warp.cuh"

struct CholBatchedParams {
  int W, n;
  float jitter;
  const float* A;  // (W, n, n) world-major
  float* L;        // (W, n, n) world-major, zero above the diagonal
};

// Element e of world w of an input lies at base[w * ws + e * es]: a
// matrix's element (i, k) is e = i n + k.
struct CholSolveParams {
  int W, n;
  int L_ws, L_es, b_ws, b_es;
  const float* L;  // (W, n, n) lower factor; its upper triangle is not read
  const float* b;  // (W, n)
  float* x;        // (W, n) world-major
};

// The damping of world w's dof i is damping[w * dmp_ws + i]: dmp_ws n
// where each world carries its own, 0 where one row serves every world.
struct DampedSolveParams {
  int W, n;
  int M_ws, M_es, a_ws, a_es, dmp_ws;
  float h;                // the timestep
  const float* M;         // (W, n, n)
  const float* a;         // (W, n) qacc
  const float* damping;   // (W or 1, n)
  float* x;               // (W, n) world-major
};

// worlds per block of chol_solve and damped_solve: as many as fit in 96
// KB, so that two blocks share an SM, at most 8
static int worlds_per_block(size_t bytes_per_world) {
  int wpb = (int)((96 * 1024) / bytes_per_world);
  return wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
}

// Shared floats of one world of chol_solve (nvec 1: b, then y, then x) or
// damped_solve (nvec 2: qacc, and the right-hand side solved in place).
static __host__ __device__ int solve_floats(int n, int nvec) {
  return n * chol_stride(n) + nvec * n;
}

// Shared floats of one world of chol_batched: the packed lower triangle.
static __host__ __device__ int packed_floats(int n) {
  return n * (n + 1) / 2;
}

// Block-wide copy of the n-vectors at src[l * wfloats] to the block's
// nw rows of a world-major (W, n) output.
__device__ __forceinline__ void store_block(const float* src, int wfloats,
                                            float* dst, int w0, int nw,
                                            int n) {
  for (int f = threadIdx.x; f < nw * n; f += blockDim.x) {
    const int l = f / n;
    dst[(size_t)w0 * n + f] = src[l * wfloats + f - l * n];
  }
}

__global__ void chol_batched_kernel(const CholBatchedParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, wf = packed_floats(n), nn = n * n;
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), p.W - w0);
  load_block<true>(p.A, nn, 1, w0, nw, nn, n, true, AtPacked{}, smem, wf);
  copies_done();
  if (warp >= nw) return;
  float* S = smem + warp * wf;
  const AtPacked ix{};
  for (int i = lane; i < n; i += 32) S[ix(i, i)] = S[ix(i, i)] + p.jitter;
  __syncwarp();
  chol_warp(S, n, ix, lane);
  float* L = p.L + (size_t)(w0 + warp) * nn;
  int r = lane / n, c = lane - r * n;
  for (int e = lane; e < nn; e += 32) {
    L[e] = c <= r ? S[ix(r, c)] : 0.0f;
    for (c += 32; c >= n; c -= n) ++r;
  }
}

__global__ void chol_solve_kernel(const CholSolveParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, ld = chol_stride(n), wf = solve_floats(n, 1);
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), p.W - w0);
  load_block(p.L, p.L_ws, p.L_es, w0, nw, n * n, n, true, AtStrided{ld},
             smem, wf);
  load_block(p.b, p.b_ws, p.b_es, w0, nw, n, n, false, AtVector{},
             smem + n * ld, wf);
  copies_done();
  if (warp < nw) {
    float* S = smem + warp * wf;
    chol_subst(S, S + n * ld, n, ld, lane);
  }
  __syncthreads();
  store_block(smem + n * ld, wf, p.x, w0, nw, n);
}

__global__ void damped_solve_kernel(const DampedSolveParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, ld = chol_stride(n), wf = solve_floats(n, 2);
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), p.W - w0);
  // per world: M (n x n at stride ld), qacc, then the right-hand side
  load_block(p.M, p.M_ws, p.M_es, w0, nw, n * n, n, false, AtStrided{ld},
             smem, wf);
  load_block(p.a, p.a_ws, p.a_es, w0, nw, n, n, false, AtVector{},
             smem + n * ld, wf);
  copies_done();
  if (warp < nw) {
    float* S = smem + warp * wf;
    float* a = S + n * ld;
    float* v = S + n * ld + n;
    const float* dmp = p.damping + (size_t)(w0 + warp) * p.dmp_ws;
    // M qacc from every entry of row i, before the damping; then the
    // damped diagonal, + h damping as a rounded product and a rounded
    // sum (each lane its own rows, so no barrier between)
    for (int i = lane; i < n; i += 32) {
      v[i] = dot_in_order(0.0f, S + i * ld, a, n);
      S[i * ld + i] = S[i * ld + i] + __fmul_rn(p.h, dmp[i]);
    }
    chol_warp(S, n, AtStrided{ld}, lane);
    chol_subst(S, v, n, ld, lane);
  }
  __syncthreads();
  store_block(smem + n * ld + n, wf, p.x, w0, nw, n);
}

static size_t chol_batched_bytes(int n) {
  return (size_t)packed_floats(n) * sizeof(float);
}

extern "C" {

int mwt_chol_batched_params_size() { return (int)sizeof(CholBatchedParams); }

int mwt_chol_solve_params_size() { return (int)sizeof(CholSolveParams); }

int mwt_damped_solve_params_size() { return (int)sizeof(DampedSolveParams); }

int mwt_chol_batched_launch(const CholBatchedParams* p, void* stream) {
  const size_t per = chol_batched_bytes(p->n);
  return launch_worlds(chol_batched_kernel, p, p->W, occupancy_worlds(per),
                       per, stream);
}

// chol_batched's registers per thread, worlds per block and shared bytes
// per block at size n, into out[0..2]
int mwt_chol_batched_info(int n, int* out) {
  const size_t per = chol_batched_bytes(n);
  return kernel_info(chol_batched_kernel, occupancy_worlds(per), per, out);
}

int mwt_chol_solve_launch(const CholSolveParams* p, void* stream) {
  const size_t per = solve_floats(p->n, 1) * sizeof(float);
  return launch_worlds(chol_solve_kernel, p, p->W, worlds_per_block(per),
                       per, stream);
}

int mwt_damped_solve_launch(const DampedSolveParams* p, void* stream) {
  const size_t per = solve_floats(p->n, 2) * sizeof(float);
  return launch_worlds(damped_solve_kernel, p, p->W, worlds_per_block(per),
                       per, stream);
}

}  // extern "C"
