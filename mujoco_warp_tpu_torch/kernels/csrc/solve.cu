// The standalone Newton solver kernel of the general step, one warp per
// world, over an assembled dense EFC system: equality, friction-loss and
// inequality (limit, pyramidal and frictionless contact) rows, and
// elliptic contacts.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/solver.py
// _make_kernel (:1041, launched by _solve_tiles :1126 from solve_batched
// :1145) in both its forms: solve_kernel for models without elliptic
// contacts, solve_ell_kernel for elliptic cones.  The Newton loop and the
// linesearch are newton_warp.cuh, on the per-row code of newton.cuh, and
// the world's layout and row set are solve_rows.cuh; K4 (k4.cu) shares all
// three.  The rows stay in the model's order: where the Pallas kernel
// permutes each condim's elliptic contacts into a contiguous block
// (_ell_perm :70), a per-row table (kind ROW_ELL, the row's place in its
// contact, the contact's dim and index; uploaded once per model) lets the
// row walk visit a contact's rows together.
//
// Each world stops on its own tolerance and linesearch tolerance where
// opt.tolerance or opt.ls_tolerance is batched (io.batch_model): the
// warp reads its world's pair at a world stride of 1, or the one shared
// value at a stride of 0.  A per-world impratio needs nothing here: it
// reaches the elliptic form through the row scales s.
//
// Bound.  Per world it reads J (nefc nv), D, aref, fl (nefc each), the
// row scales s (nefc, elliptic only), M (nv^2) and two nv vectors, and
// writes qacc, qfrc_constraint (nv each), efc_force (nefc) and niter: at
// the spheres scene (nefc 192, nv 36) 36.5 KB per world, 299 MB at 8192
// worlds (89 us at 3.35 TB/s).  Each Newton iteration costs ~nefc nv^2 / 2
// flops for H and ~nv^3 / 3 for its factor when a row flips (every
// iteration with elliptic contacts), a few thousand to tens of thousands
// of flops per world; what bounds the kernel is each world's dependent
// chain of Newton and linesearch steps.
//
// Design.  Each world gets one warp, and a block as many worlds as let an
// SM hold the most (warp.cuh occupancy_worlds; 4 at spheres' 46.5 KB).
// The block copies its worlds' inputs, lanes-last (rows, W), into shared
// memory once with cp.async, the world as the fastest thread index; the
// world's J, M and L sit at an odd row stride, its per-row slots (Jaref,
// J search, mask, force; the elliptic form's forces and per-contact
// terms) beside them, and no global scratch remains.  Rows with D == 0
// are empty slots: the warp lists the live rows once, and the factor the
// rows whose D quad is non-zero, so the lanes share only rows that add to
// a sum.  The lanes share J v (over rows), J^T f (over dofs), H (over 4 x
// 4 tiles of its lower triangle, summed in registers; the elliptic
// contacts' middle-zone cone blocks from a table the lanes fill over the
// contacts), the factor and its substitutions (warp.cuh), and the
// linesearch's sums (over rows and contacts, reduced by shuffles).  Each
// step of the Newton loop is one copy of code (newton_warp.cuh), and the
// forms instantiate only the factor and substitution shapes nv <= 64
// needs.  A block barrier ends the loads and begins the stores, and every
// thread reaches both.

#include "solve_rows.cuh"

struct SolveParams {
  int W, nv, nefc, ncon, iterations, ls_iterations;
  // world strides of tol and ls_tol: 1 where the field is batched (each
  // world stops on its own test), 0 where every world shares one value
  int tol_stride, ls_tol_stride;
  float meaninertia;
  const float* tol;     // opt.tolerance, (W,) or (1,)
  const float* ls_tol;  // opt.ls_tolerance, (W,) or (1,)
  const float* J;      // (nefc nv, W)
  const float* D;      // (nefc, W)
  const float* aref;   // (nefc, W)
  const float* fl;     // (nefc, W) friction loss
  const float* M;      // (nv nv, W)
  const float* qfs;    // (nv, W) smooth force
  const float* qacc0;  // (nv, W) warmstart
  float* qacc_out;     // (nv, W)
  float* force_out;    // (nefc, W)
  float* qfrc_out;     // (nv, W) qfrc_constraint
  int* niter_out;      // (1, W)
  const int* kind;     // (nefc,) ROW_INEQ, ROW_EQ, ROW_FRI or ROW_ELL
  // the elliptic form's inputs, null for the other form
  const float* s;      // (nefc, W) elliptic row scales
  const int* etab;     // (nefc, 3) off, dim, contact
};

// One body for both forms, inlined into each named kernel, so the
// pyramidal kernel compiles without any of the elliptic form's code.
template <bool E>
__device__ __forceinline__ void solve_block(const SolveParams& p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.W, nv = p.nv, nefc = p.nefc;
  const SolveLayout lay(nefc, nv, E ? p.ncon : 0);
  const int wf = lay.total;
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), W - w0);
  // each input lanes-last: world stride 1, element stride W
  load_block(p.J, 1, W, w0, nw, nefc * nv, nv, false, AtStrided{lay.ld},
             smem + lay.J, wf);
  load_block(p.M, 1, W, w0, nw, nv * nv, nv, false, AtStrided{lay.ld},
             smem + lay.M, wf);
  const float* rows_in[4] = {p.D, p.aref, p.fl, p.s};
  const int rows_at[4] = {lay.D, lay.aref, lay.fl, lay.s};
  for (int k = 0; k < (E ? 4 : 3); ++k)
    load_block(rows_in[k], 1, W, w0, nw, nefc, nefc, false, AtVector{},
               smem + rows_at[k], wf);
  load_block(p.qacc0, 1, W, w0, nw, nv, nv, false, AtVector{},
             smem + lay.vec, wf);
  load_block(p.qfs, 1, W, w0, nw, nv, nv, false, AtVector{},
             smem + lay.vec + 5 * nv, wf);
  copies_done();
  if (warp < nw) {
    float* b = smem + warp * wf;
    SolveRows<E> R(p.kind, p.etab, nefc, nv, E ? p.ncon : 0, lay, b,
                   lane);
    R.init();
    float* v = b + lay.vec;
    const WarpVecs x{v, v + nv, v + 2 * nv, v + 3 * nv, v + 4 * nv,
                     v + 5 * nv};
    // the world's tolerances, read once by every lane of its warp
    const size_t w = (size_t)(w0 + warp);
    const float tol = __ldg(p.tol + w * p.tol_stride);
    const float ls_tol = __ldg(p.ls_tol + w * p.ls_tol_stride);
    const float niter = newton_solve_warp<MWT_MAX_NV>(
        R, R.M, x, nv, p.iterations, p.ls_iterations, tol, ls_tol,
        p.meaninertia, lane);
    R.forces(true);
    R.jt(x.grad);  // qfrc_constraint
    if (lane == 0) v[6 * nv] = niter;
  }
  __syncthreads();
  // qacc, efc_force, qfrc_constraint and niter, lanes-last, the world as
  // the fastest thread index
  float* outs[3] = {p.qacc_out, p.force_out, p.qfrc_out};
  const int out_at[3] = {lay.vec, lay.frc, lay.vec + 2 * nv};
  const int out_rows[3] = {nv, nefc, nv};
  for (int k = 0; k < 3; ++k)
    for (int f = threadIdx.x; f < out_rows[k] * nw; f += blockDim.x) {
      const int r = f / nw, l = f - r * nw;
      outs[k][(size_t)r * W + w0 + l] = smem[l * wf + out_at[k] + r];
    }
  for (int l = threadIdx.x; l < nw; l += blockDim.x)
    p.niter_out[w0 + l] = (int)smem[l * wf + lay.vec + 6 * nv];
}

__global__ void solve_kernel(const SolveParams p) { solve_block<false>(p); }

__global__ void solve_ell_kernel(const SolveParams p) {
  solve_block<true>(p);
}

// the form's kernel, its shared bytes per world and worlds per block
static void solve_config(const SolveParams* p, void (**kernel)(SolveParams),
                         size_t* per_world, int* wpb) {
  const bool ell = p->s != nullptr;
  *kernel = ell ? solve_ell_kernel : solve_kernel;
  *per_world = (size_t)SolveLayout(p->nefc, p->nv, ell ? p->ncon : 0).total *
               sizeof(float);
  *wpb = occupancy_worlds(*per_world);
}

extern "C" {

int mwt_solve_params_size() { return (int)sizeof(SolveParams); }

// shared floats of one world (ncon > 0: the elliptic form)
int mwt_solve_world_floats(int nefc, int nv, int ncon) {
  return SolveLayout(nefc, nv, ncon).total;
}

// Launches the solve on `stream` (the elliptic form when p->s is set);
// returns cudaGetLastError() of the launch.
int mwt_solve_launch(const SolveParams* p, void* stream) {
  void (*kernel)(SolveParams);
  size_t per_world;
  int wpb;
  solve_config(p, &kernel, &per_world, &wpb);
  return launch_worlds(kernel, p, p->W, wpb, per_world, stream);
}

// the kernel's registers per thread, worlds per block and shared bytes per
// block for p's sizes, into out[0..2]
int mwt_solve_info(const SolveParams* p, int* out) {
  void (*kernel)(SolveParams);
  size_t per_world;
  int wpb;
  solve_config(p, &kernel, &per_world, &wpb);
  return kernel_info(kernel, wpb, per_world, out);
}

}  // extern "C"
