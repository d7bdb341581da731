// Building blocks of the kernels that give each world one warp and hold
// the world's matrices in shared memory (every kernel of the library:
// k1.cu, k4.cu, mass_chain.cu, linalg.cu, solve.cu): the block's
// asynchronous loads and its stores, warp reductions and list compaction,
// the Cholesky factor and its two substitutions, and the launch that
// sizes the block from the shared bytes one world needs.
//
// A warp's lanes call every function here together (converged), so the
// __syncwarp and shuffle inside each are met by all 32.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

#define MWT_FULL 0xffffffffu
// shared memory one block may use, and one SM holds (with 1 KB of it
// reserved per block)
#define MWT_SMEM_BLOCK 232448
#define MWT_SMEM_SM 233472

// tells the compiler that p points into shared memory, so that it loads
// and stores through it with shared-memory instructions
#define MWT_SHARED(p) __builtin_assume(__isShared(p))

// shared-memory row stride of a matrix of n columns: odd, so the 32 lanes
// of a warp reading one column touch 32 distinct banks
static __host__ __device__ int chol_stride(int n) { return n | 1; }

// x[0..N) each summed over the warp by a butterfly: each step adds a and
// b on one lane and b and a on its partner, so every lane ends with the
// same sums; the N sums interleave, so their shuffles overlap
template <int N>
__device__ __forceinline__ void warp_sums(float* x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float y[N];
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = __shfl_xor_sync(MWT_FULL, x[k], o);
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = x[k] + y[k];
  }
}


// acc + a[0] b[0] + a[1] b[1] + ... + a[n-1] b[n-1], summed in that
// order
__device__ __forceinline__ float dot_in_order(float acc, const float* a,
                                              const float* b, int n) {
  for (int k = 0; k < n; ++k) acc = acc + a[k] * b[k];
  return acc;
}

// The indices i in [0, n) with keep(i), ascending, into list; returns
// their count (the same on every lane).
template <class F>
__device__ __forceinline__ int warp_compact(int n, F keep,
                                            unsigned short* list,
                                            int lane) {
  int cnt = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool k = i < n && keep(i);
    const unsigned b = __ballot_sync(MWT_FULL, k);
    if (k) list[cnt + __popc(b & ((1u << lane) - 1u))] = (unsigned short)i;
    cnt += __popc(b);
  }
  __syncwarp();
  return cnt;
}

// Block-wide copy of elements [0, ne) of the block's nw worlds from a
// strided operand into shared memory: element e of local world l goes to
// dst[l * wfloats + at(r, c, e)], (r, c) its row and column in a matrix
// of n columns.  Each of the first 32 nw threads copies one world's
// elements e0, e0 + 32, ...; consecutive threads take consecutive worlds
// when the world stride is the smaller, else consecutive elements.
// ``lower`` skips the upper triangle where the world is the fastest index
// (``ALL_LOWER`` everywhere: for a destination that holds no upper
// triangle); a world-major row's upper entries share its sectors, so
// there the whole row is read in one contiguous sweep, which the card
// does faster than the skipping one.  The copies are asynchronous
// (cp.async), so a thread keeps all of its loads in flight at once; the
// caller waits with copies_done.
template <bool ALL_LOWER = false, class At>
__device__ __forceinline__ void load_block(const float* src, int ws, int es,
                                           int w0, int nw, int ne, int n,
                                           bool lower, At at, float* dst,
                                           int wfloats) {
  const int t = threadIdx.x;
  if (t >= 32 * nw) return;
  const bool world_fast = ws < es;
  const int l = world_fast ? t % nw : t >> 5;
  int e = world_fast ? t / nw : t & 31;
  const float* s = src + (size_t)(w0 + l) * ws;
  float* d = dst + l * wfloats;
  int r = e / n, c = e - r * n;  // (row, column) of element e
  for (; e < ne; e += 32) {
    if ((!ALL_LOWER && !(lower && world_fast)) || c <= r)
      __pipeline_memcpy_async(d + at(r, c, e), s + (size_t)e * es,
                              sizeof(float));
    for (c += 32; c >= n; c -= n) ++r;
  }
}

// destinations of load_block: a matrix at row stride ld, a vector, a
// packed lower triangle (row r from r (r + 1) / 2)
struct AtStrided {
  int ld;
  __device__ int operator()(int r, int c, int = 0) const {
    return r * ld + c;
  }
};
struct AtVector {
  __device__ int operator()(int, int, int e) const { return e; }
};
struct AtPacked {
  __device__ int operator()(int r, int c, int = 0) const {
    return (r * (r + 1) >> 1) + c;
  }
};

// Block-wide copy of rows [0, rows) of the block's nw worlds from shared
// memory (row r of local world l at src[l * wfloats + r]) to a lanes-last
// operand of W columns, the world as the fastest thread index, so that
// consecutive threads write consecutive worlds of one row: thread t takes
// world t % nw and rows t / nw, t / nw + step, ... (step the block's
// threads over nw; the few threads past step nw idle).
__device__ __forceinline__ void store_block(float* dst, int W, int w0, int nw,
                                           int rows, const float* src,
                                           int wfloats) {
  const int step = blockDim.x / nw, r0 = threadIdx.x / nw;
  if (r0 >= step) return;
  const int l = threadIdx.x - r0 * nw;
  const float* s = src + l * wfloats;
  float* d = dst + w0 + l;
  for (int r = r0; r < rows; r += step) d[(size_t)r * W] = s[r];
}

// store_block of an n x n matrix held at row stride ld as n n rows; with
// ``lower``, its lower triangle and zeros above the diagonal
__device__ __forceinline__ void store_block_matrix(float* dst, int W, int w0,
                                                   int nw, int n,
                                                   const float* src, int ld,
                                                   int wfloats, bool lower) {
  const int step = blockDim.x / nw, r0 = threadIdx.x / nw;
  if (r0 >= step) return;
  const int l = threadIdx.x - r0 * nw;
  const float* s = src + l * wfloats;
  float* d = dst + w0 + l;
  int i = r0 / n, j = r0 - i * n;  // (row, column) of element e
  for (int e = r0; e < n * n; e += step) {
    d[(size_t)e * W] = (!lower || j <= i) ? s[i * ld + j] : 0.0f;
    for (j += step; j >= n; j -= n) ++i;
  }
}

// Wait for this thread's load_block copies, then for the block's.
__device__ __forceinline__ void copies_done() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Columns j and j + 1 < n of the factor (chol_warp), Q rows per lane:
// lane l holds rows i = j + l + 32 q, and sums each row's dot products
// over the finished columns m < j in order, t = S_ij - L_i0 L_j0 - L_i1
// L_j1 - ... (and u likewise for column j + 1), the chains side by side,
// four columns' loads ahead of their terms; lane 0's t (row j) gives the
// pivot of column j, then column j + 1 takes its last term (m = j, from
// L_{j+1,j} on lane 1) and lane 1's u gives its pivot.
template <int Q, class Ix>
__device__ __forceinline__ void chol_column_pair(float* S, int n, int j,
                                                 Ix ix, int lane) {
  MWT_SHARED(S);
  const float* Sj = S + ix(j, 0);
  const float* Sk = S + ix(j + 1, 0);
  float* Si[Q];
  float t[Q], u[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = j + lane + 32 * q;
    Si[q] = S + ix(i < n ? i : j + 1, 0);
    t[q] = Si[q][j];
    u[q] = Si[q][j + 1];  // read above the diagonal on row j, not used
  }
  int m = 0;
  for (; m + 4 <= j; m += 4) {  // four columns' loads, then their terms
    float lj[4], lk[4], li[Q][4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      lj[w] = Sj[m + w];
      lk[w] = Sk[m + w];
#pragma unroll
      for (int q = 0; q < Q; ++q) li[q][w] = Si[q][m + w];
    }
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        t[q] = t[q] - li[q][w] * lj[w];
        u[q] = u[q] - li[q][w] * lk[w];
      }
  }
  for (; m < j; ++m) {
    const float ljm = Sj[m], lkm = Sk[m];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float lim = Si[q][m];
      t[q] = t[q] - lim * ljm;
      u[q] = u[q] - lim * lkm;
    }
  }
  const float pj = rsqrtf(fmaxf(__shfl_sync(MWT_FULL, t[0], 0), MWT_MINVAL));
#pragma unroll
  for (int q = 0; q < Q; ++q) t[q] = t[q] * pj;  // L_ij
  const float lkj = __shfl_sync(MWT_FULL, t[0], 1);  // L_{j+1,j}
#pragma unroll
  for (int q = 0; q < Q; ++q) u[q] = u[q] - t[q] * lkj;
  const float pk = rsqrtf(fmaxf(__shfl_sync(MWT_FULL, u[0], 1), MWT_MINVAL));
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = j + lane + 32 * q;
    if (i < n) {
      Si[q][j] = t[q];
      if (i > j) Si[q][j + 1] = u[q] * pk;
    }
  }
  __syncwarp();
}

// Factor the lower triangle of S in place, one warp, entry (i, k) at
// S[ix(i, k)], n <= MAXN (a multiple of 32, at most 128): pivots
// rsqrt(max(S_jj, 1e-15)); entry (i, j) loses L_im L_jm in column order
// m before its scaling, as the plain version's right-looking updates
// subtract them, so the two round alike.  Two columns at a time, each
// lane computes the entries of its rows by dot products over the
// finished columns: every lane's dot products have the same length, so
// the work is even over the lanes, and the chains run side by side with
// their loads ahead (no store until the two columns are done).  Reads and
// writes only the lower triangle (and reads, unused, one entry above it
// per pair).
template <int MAXN = 128, class Ix>
__device__ __forceinline__ void chol_warp(float* S, int n, Ix ix, int lane) {
  __syncwarp();
  int j = 0;
  for (; j + 1 < n; j += 2) {
    const int rows = n - j;
    if (MAXN > 96 && rows > 96)
      chol_column_pair<4>(S, n, j, ix, lane);
    else if (MAXN > 64 && rows > 64)
      chol_column_pair<3>(S, n, j, ix, lane);
    else if (MAXN > 32 && rows > 32)
      chol_column_pair<2>(S, n, j, ix, lane);
    else
      chol_column_pair<1>(S, n, j, ix, lane);
  }
  if (j < n) {  // odd n: the last column holds the diagonal only
    const float* Sj = S + ix(j, 0);
    float t = Sj[j];
    for (int m = 0; m < j; ++m) t = t - Sj[m] * Sj[m];
    if (lane == 0) S[ix(j, j)] = t * rsqrtf(fmaxf(t, MWT_MINVAL));
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
// back.  Reads v after, and writes it before, a __syncwarp.
template <int NSLOT>
__device__ __forceinline__ void chol_subst_warp(const float* S, float* v,
                                                int n, int ld, int lane) {
  MWT_SHARED(S);
  MWT_SHARED(v);
  float r[NSLOT];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < NSLOT; ++q)
    r[q] = lane + 32 * q < n ? v[lane + 32 * q] : 0.0f;
#pragma unroll
  for (int q0 = 0; q0 < NSLOT; ++q0) {
    const int end = min(32, n - 32 * q0);
    for (int jj = 0; jj < end; ++jj) {
      const int j = 32 * q0 + jj;
      const float y = __shfl_sync(MWT_FULL, r[q0], jj) /
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
      const float x = __shfl_sync(MWT_FULL, r[q0], ii) /
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
  __syncwarp();
}

// chol_subst_warp with as many slots as n needs (n <= MAXN <= 128,
// kernels/linalg.py MAX_N)
template <int MAXN = 128>
__device__ __forceinline__ void chol_subst(const float* S, float* v, int n,
                                           int ld, int lane) {
  if (MAXN <= 32 || n <= 32)
    chol_subst_warp<1>(S, v, n, ld, lane);
  else if (MAXN <= 64 || n <= 64)
    chol_subst_warp<2>(S, v, n, ld, lane);
  else if (MAXN <= 96 || n <= 96)
    chol_subst_warp<3>(S, v, n, ld, lane);
  else
    chol_subst_warp<4>(S, v, n, ld, lane);
}

// Worlds per block (at most 8) that let an SM hold the most worlds at
// `per_world` shared bytes each; the largest such count, so that a block
// loads more neighbouring worlds of a lanes-last row at once.  With
// `balance`, the count that gives the SM's busiest scheduler the most
// worlds per warp it runs (then the most worlds, then the fewest per
// block): the SM's four schedulers take a block's warps in turn (warp w
// on scheduler w % 4), so 3-warp blocks leave one of them idle.  0 when
// one world does not fit in a block.
static int occupancy_worlds(size_t per_world, bool balance = false) {
  int best = 0, best_sm = 0, best_busiest = 1;
  for (int wpb = 1; wpb <= 8; ++wpb) {
    const size_t bytes = wpb * per_world;
    if (bytes > MWT_SMEM_BLOCK) break;
    int blocks = (int)(MWT_SMEM_SM / (bytes + 1024));
    blocks = min(blocks, min(32, 64 / wpb));
    const int sm = blocks * wpb, busiest = blocks * ((wpb + 3) / 4);
    // sm / busiest against best_sm / best_busiest, in integers
    const int rate = balance ? sm * best_busiest - best_sm * busiest : 0;
    if (rate > 0 || (rate == 0 && (balance ? sm > best_sm
                                           : sm >= best_sm))) {
      best = wpb;
      best_sm = sm;
      best_busiest = busiest;
    }
  }
  return best;
}

// Worlds per block for a kernel that stores lanes-last rows block-wide: 8
// where 8 worlds fit in a block, so that each block writes (and loads)
// whole 32-byte sectors of every row, else occupancy_worlds.  On an H100
// the mass chain and K1 ran 3-19% faster at 8 per block than at the 5-7
// that fill an SM with the most worlds (kerneltime.py in turns).
static int sector_worlds(size_t per_world) {
  return 8 * per_world <= MWT_SMEM_BLOCK ? 8 : occupancy_worlds(per_world);
}

// Launch `kernel` over W worlds, `wpb` per block at `per_world` shared
// bytes each, one warp per world, on `stream`; return cudaGetLastError()
// of the launch.
template <typename P>
static int launch_worlds(void (*kernel)(const P), const P* p, int W, int wpb,
                         size_t per_world, void* stream) {
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = wpb * per_world;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (W + wpb - 1) / wpb;
  kernel<<<blocks, 32 * wpb, bytes, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

// registers per thread of `kernel`, its worlds per block and its shared
// bytes per block, into out[0..2]; returns cudaFuncGetAttributes' error
template <typename P>
static int kernel_info(void (*kernel)(const P), int wpb, size_t per_world,
                       int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  out[0] = e == cudaSuccess ? a.numRegs : -1;
  out[1] = wpb;
  out[2] = (int)(wpb * per_world);
  return (int)e;
}
