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
// matrix in shared memory at an odd row stride (the 32 lanes of a warp
// reading one column hit 32 distinct banks); a block holds a few worlds,
// as many as fit twice in an SM's shared memory (at n 75: 4).  The factor
// (chol_warp) has lanes over rows and the column loop serial.  The two
// substitutions (chol_subst) keep the vector in registers spread over the
// lanes and run in the plain version's order (forward: column j updates
// rows i > j; back: row i updates columns k < i), so with --fmad=false
// kernel and plain version round alike.  chol_batched reads and writes
// world-major.  chol_solve and damped_solve take each input at a world
// stride and an element stride, so they read a world-major factor and a
// world() view of a lanes-last one in place: the block copies its
// worlds' matrices with cp.async, the world or the element as the
// fastest thread index, whichever lies closer in memory, so the loads
// stay coalesced in both layouts, and writes x world-major; a block
// barrier ends the loads and begins the stores, and every thread reaches
// both, a warp past W included.

#include <cuda_pipeline.h>

#include "common.cuh"

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

struct DampedSolveParams {
  int W, n;
  int M_ws, M_es, a_ws, a_es;
  const float* M;    // (W, n, n)
  const float* a;    // (W, n) qacc
  const float* dmp;  // (n,) h * damping
  float* x;          // (W, n) world-major
};

// shared-memory row stride of an n x n matrix: odd, so the 32 lanes of a
// warp reading one column touch 32 distinct banks
static __host__ __device__ int chol_stride(int n) { return n | 1; }

// worlds per block: as many as fit in 96 KB, so that two blocks share an
// SM, at most 8
static int worlds_per_block(size_t bytes_per_world) {
  int wpb = (int)((96 * 1024) / bytes_per_world);
  return wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
}

// Shared floats of one world of chol_solve (nvec 1: b, then y, then x) or
// damped_solve (nvec 2: qacc, and the right-hand side solved in place).
static __host__ __device__ int solve_floats(int n, int nvec) {
  return n * chol_stride(n) + nvec * n;
}

// Factor the lower triangle of S (n x n at row stride ld) in place, one
// warp: pivots rsqrt(max(S_jj, 1e-15)); entry (i, k) of the trailing
// lower triangle loses L_ij L_kj in column order j, as the plain version
// subtracts them.  Reads and writes only the lower triangle.
__device__ __forceinline__ void chol_warp(float* S, int n, int ld,
                                          int lane) {
  for (int j = 0; j < n; ++j) {
    const float piv = rsqrtf(fmaxf(S[j * ld + j], MWT_MINVAL));
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) S[i * ld + j] = S[i * ld + j] * piv;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = S[i * ld + j];
      for (int k = j + 1; k <= i; ++k)
        S[i * ld + k] = S[i * ld + k] - lij * S[k * ld + j];
    }
    __syncwarp();
  }
}

// Solve L L^T x = v in place, one warp, L the lower triangle of S, for
// n <= 32 NSLOT: forward, y_j = v_j / max(L_jj, 1e-15), then v_i -= L_ij
// y_j for i > j; back, x_i = y_i / max(L_ii, 1e-15), then y_k -= L_ik x_i
// for k < i.  The vector lives in registers, element e in lane e % 32 of
// slot e / 32, and each step takes its pivot entry from its lane by a
// shuffle, so a step's chain is one shuffle, one division and one
// product-difference.  Steps run slot by slot (q0), so a step touches only
// the slots it updates: those after q0 going forward, before q0 going
// back.
template <int NSLOT>
__device__ __forceinline__ void chol_subst_warp(const float* S, float* v,
                                                int n, int ld, int lane) {
  float r[NSLOT];
#pragma unroll
  for (int q = 0; q < NSLOT; ++q)
    r[q] = lane + 32 * q < n ? v[lane + 32 * q] : 0.0f;
#pragma unroll
  for (int q0 = 0; q0 < NSLOT; ++q0) {
    const int end = min(32, n - 32 * q0);
    for (int jj = 0; jj < end; ++jj) {
      const int j = 32 * q0 + jj;
      const float y = __shfl_sync(0xffffffffu, r[q0], jj) /
                      fmaxf(S[j * ld + j], MWT_MINVAL);
      if (lane > jj && lane < end)
        r[q0] = r[q0] - S[(32 * q0 + lane) * ld + j] * y;
      if (lane == jj) r[q0] = y;
#pragma unroll
      for (int q = q0 + 1; q < NSLOT; ++q)
        if (lane + 32 * q < n) r[q] = r[q] - S[(lane + 32 * q) * ld + j] * y;
    }
  }
#pragma unroll
  for (int q0 = NSLOT - 1; q0 >= 0; --q0) {
    for (int ii = min(32, n - 32 * q0) - 1; ii >= 0; --ii) {
      const int i = 32 * q0 + ii;
      const float x = __shfl_sync(0xffffffffu, r[q0], ii) /
                      fmaxf(S[i * ld + i], MWT_MINVAL);
      if (lane < ii) r[q0] = r[q0] - S[i * ld + 32 * q0 + lane] * x;
      if (lane == ii) r[q0] = x;
#pragma unroll
      for (int q = 0; q < q0; ++q)
        r[q] = r[q] - S[i * ld + lane + 32 * q] * x;
    }
  }
#pragma unroll
  for (int q = 0; q < NSLOT; ++q)
    if (lane + 32 * q < n) v[lane + 32 * q] = r[q];
}

// chol_subst_warp with as many slots as n needs (n <= 128,
// kernels/linalg.py MAX_N)
__device__ __forceinline__ void chol_subst(const float* S, float* v, int n,
                                           int ld, int lane) {
  if (n <= 32)
    chol_subst_warp<1>(S, v, n, ld, lane);
  else if (n <= 64)
    chol_subst_warp<2>(S, v, n, ld, lane);
  else if (n <= 96)
    chol_subst_warp<3>(S, v, n, ld, lane);
  else
    chol_subst_warp<4>(S, v, n, ld, lane);
}

// Block-wide copy of elements [0, ne) of the block's nw worlds from a
// strided operand into shared memory: element e of local world l goes to
// dst[l * wfloats + at(e)].  Each of the first 32 nw threads copies one
// world's elements e0, e0 + 32, ...; consecutive threads take
// consecutive worlds when the world stride is the smaller, else
// consecutive elements.  ``lower`` skips the upper triangle of an n x n
// matrix where the world is the fastest index; a world-major row's upper
// entries share its sectors, so there the whole row is read in one
// contiguous sweep, which the card does faster than the skipping one.
// The copies are asynchronous (cp.async), so a thread keeps all of its
// loads in flight at once; the caller waits with copies_done.
template <bool MATRIX>
__device__ __forceinline__ void load_block(const float* src, int ws, int es,
                                           int w0, int nw, int ne, int n,
                                           bool lower, float* dst,
                                           int wfloats) {
  const int t = threadIdx.x;
  if (t >= 32 * nw) return;
  const bool world_fast = ws < es;
  const int l = world_fast ? t % nw : t >> 5;
  int e = world_fast ? t / nw : t & 31;
  const float* s = src + (size_t)(w0 + l) * ws;
  float* d = dst + l * wfloats;
  const int ld = chol_stride(n);
  int r = e / n, c = e - r * n;  // (row, column) of element e
  for (; e < ne; e += 32) {
    if (!MATRIX || !lower || !world_fast || c <= r)
      __pipeline_memcpy_async(d + (MATRIX ? r * ld + c : e),
                              s + (size_t)e * es, sizeof(float));
    for (c += 32; c >= n; c -= n) ++r;
  }
}

// Wait for this thread's load_block copies, then for the block's.
__device__ __forceinline__ void copies_done() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
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
  chol_warp(S, n, ld, lane);
  float* L = p.L + (size_t)w * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e - r * n;
    L[e] = c <= r ? S[r * ld + c] : 0.0f;
  }
}

__global__ void chol_solve_kernel(const CholSolveParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, ld = chol_stride(n), wf = solve_floats(n, 1);
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), p.W - w0);
  load_block<true>(p.L, p.L_ws, p.L_es, w0, nw, n * n, n, true, smem, wf);
  load_block<false>(p.b, p.b_ws, p.b_es, w0, nw, n, n, false,
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
  load_block<true>(p.M, p.M_ws, p.M_es, w0, nw, n * n, n, false, smem, wf);
  load_block<false>(p.a, p.a_ws, p.a_es, w0, nw, n, n, false,
                    smem + n * ld, wf);
  copies_done();
  if (warp < nw) {
    float* S = smem + warp * wf;
    const float* a = S + n * ld;
    float* v = S + n * ld + n;
    // M qacc from every entry of row i, before the damping; then the
    // damped diagonal (each lane its own rows, so no barrier between)
    for (int i = lane; i < n; i += 32) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc = acc + S[i * ld + k] * a[k];
      v[i] = acc;
      S[i * ld + i] = S[i * ld + i] + p.dmp[i];
    }
    __syncwarp();
    chol_warp(S, n, ld, lane);
    chol_subst(S, v, n, ld, lane);
  }
  __syncthreads();
  store_block(smem + n * ld + n, wf, p.x, w0, nw, n);
}

// Launch `kernel` over W worlds at `wfloats` shared floats per world, one
// warp per world, on `stream`; return cudaGetLastError() of the launch.
template <typename P>
static int launch_worlds(void (*kernel)(const P), const P* p, int wfloats,
                         void* stream) {
  const size_t per_world = (size_t)wfloats * sizeof(float);
  const int wpb = worlds_per_block(per_world);
  const size_t bytes = wpb * per_world;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p->W + wpb - 1) / wpb;
  kernel<<<blocks, 32 * wpb, bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

int mwt_chol_batched_params_size() { return (int)sizeof(CholBatchedParams); }

int mwt_chol_solve_params_size() { return (int)sizeof(CholSolveParams); }

int mwt_damped_solve_params_size() { return (int)sizeof(DampedSolveParams); }

int mwt_chol_batched_launch(const CholBatchedParams* p, void* stream) {
  return launch_worlds(chol_batched_kernel, p, p->n * chol_stride(p->n),
                       stream);
}

int mwt_chol_solve_launch(const CholSolveParams* p, void* stream) {
  return launch_worlds(chol_solve_kernel, p, solve_floats(p->n, 1), stream);
}

int mwt_damped_solve_launch(const DampedSolveParams* p, void* stream) {
  return launch_worlds(damped_solve_kernel, p, solve_floats(p->n, 2),
                       stream);
}

}  // extern "C"
