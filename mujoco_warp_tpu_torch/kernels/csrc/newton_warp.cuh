// The Newton solve of newton.cuh with one warp per world: the same
// constraint-state update, gradient, H = M + J^T D J with Cholesky-factor
// reuse, exact bracketed 3-alpha linesearch and per-world stop, with the
// lanes sharing each step's work and the world's system in shared memory.
// Counterpart of mujoco_warp_tpu/pallas/solver.py solve_core (:269), as
// newton.cuh; the solve kernel (solve.cu) and K4 (k4.cu) run it over the
// row set of solve_rows.cuh.
//
// A row set R supplies the rows as in newton.cuh (D(r), aref(r), fl(r),
// kind(r), the slots jaref(r), jv(r), quad(r), and for R::ELL the
// elliptic accessors), so newton.cuh's per-row code (row_force, quad_row,
// eval3_row, p0_row, ell_update, ell_hoist, ell_eval3) serves it.
// The warp's steps are R's methods, each called by all 32 lanes and ending
// in a __syncwarp where lanes read what others wrote:
//   jaref_init(v)  Jaref = J v - aref over every row (J v = 0 on rows with
//                  D == 0), jv = 0;
//   jv_of(v)       jv = J v over the live rows;
//   update_quad()  the rows' masks (elliptic contacts: forces and masks),
//                  true on every lane if a mask flipped;
//   factor()       H of the current state factored into L (at row stride
//                  ld);
//   forces(all)    the row forces into frc (all rows, or the live ones);
//   jt(out)        out = J^T frc over the live rows;
//   p0_lane(p1, p2), eval3_lane(a, c, g, hh)  this lane's share of the
//                  linesearch's sums over rows and contacts.
// Vectors of length nv lie in shared memory, element i with lane i % 32;
// every sum over the lanes is a butterfly (warp.cuh warp_sums), the same
// on every lane, so the loop and linesearch decisions are the warp's.
// J v, J^T f, H and M v are summed per element on one lane, in row and
// dof order; the sums over the lanes are those butterflies.
#pragma once

#include "newton.cuh"
#include "warp.cuh"

// the world's dense vectors in shared memory, nv floats each
struct WarpVecs {
  float *qacc, *Ma, *grad, *search, *mv;
  const float* qfs;
};

// out[i] = M[i, :] v for the lane's rows i (M at row stride ld)
__device__ __forceinline__ void matvec_warp(const float* M, int ld,
                                            const float* v, float* out,
                                            int nv, int lane) {
  for (int i = lane; i < nv; i += 32)
    out[i] = dot_in_order(0.0f, M + i * ld, v, nv);
}

// Newton from the warmstart in x.qacc to qacc; M at row stride rows.ld,
// nv <= MAXN.  Returns the iteration count.  Without elliptic contacts
// the factor is rebuilt only when the world's own mask flipped.  Each step
// of the loop appears once in the code (the first pass factors and takes
// the gradient, each later one first searches and steps), so that the
// kernel's instructions stay few for the instruction cache.
template <int MAXN, class R>
__device__ __forceinline__ float newton_solve_warp(
    const R& rows, const float* M, const WarpVecs& x, int nv, int iterations,
    int ls_iterations, float tol, float ls_tol, float mi, int lane) {
  const float rescale = 1.0f / (mi * (float)nv);
  const int ld = rows.ld;
  float niter = 0.0f, improve = 0.0f;
  rows.jaref_init(x.qacc);
  matvec_warp(M, ld, x.qacc, x.Ma, nv, lane);
  bool refactor = true, first = true;
  rows.update_quad();
  for (;;) {
    if (refactor) rows.factor();
    rows.forces(false);
    rows.jt(x.grad);
    // grad = Ma - qfs - J^T f, search = H^-1 grad
    float gg = 0.0f;
    for (int i = lane; i < nv; i += 32) {
      const float g = x.Ma[i] - x.qfs[i] - x.grad[i];
      x.grad[i] = g;
      x.search[i] = g;
      gg = gg + g * g;
    }
    chol_subst<MAXN>(rows.L, x.search, nv, ld, lane);
    float gm = 0.0f;
    for (int i = lane; i < nv; i += 32) gm = gm + x.grad[i] * x.search[i];
    float sums[2] = {gg, gm};
    warp_sums<2>(sums);
    gg = sums[0];
    gm = sums[1];
    const float gnorm = rescale * sqrtf(fmaxf(gg, 0.0f));
    bool done;
    if (first) {
      done = gnorm < tol;
      first = false;
    } else {
      niter = niter + 1.0f;
      const float model_impr = rescale * 0.5f * gm;
      done = rescale * improve < tol || gnorm < tol || model_impr < tol ||
             niter >= (float)iterations;
    }
    for (int i = lane; i < nv; i += 32) x.search[i] = -x.search[i];
    __syncwarp();
    if (done) break;

    // -- linesearch along `search`
    rows.jv_of(x.search);
    matvec_warp(M, ld, x.search, x.mv, nv, lane);
    float g1 = 0.0f, g2 = 0.0f, ss = 0.0f;
    for (int i = lane; i < nv; i += 32) {
      const float s = x.search[i];
      g1 = g1 + s * (x.Ma[i] - x.qfs[i]);
      g2 = g2 + s * x.mv[i];
      ss = ss + s * s;
    }
    float pp[5] = {g1, g2, ss, 0.0f, 0.0f};
    rows.p0_lane(&pp[3], &pp[4]);
    warp_sums<5>(pp);
    g1 = pp[0];
    g2 = 0.5f * pp[1];
    const float snorm = sqrtf(fmaxf(pp[2], 0.0f));
    const float gtol = fmaxf(tol * ls_tol * snorm * mi * (float)nv, 1e-6f);
    const float p1 = pp[3] + g1;
    const float p2 = pp[4] + 2.0f * g2;
    const float lo_alpha_in = -sdiv(p1, p2);
    // evaluation -1 is the first guess at all three step sizes, 0 .. the
    // bracket's (lo_next, hi_next, mid)
    Pt lo, hi, li;
    float alpha = 0.0f;
    improve = 0.0f;
    bool init_conv = false;
    for (int it = -1; it < ls_iterations; ++it) {
      float a[3];
      if (it < 0) {
        a[0] = a[1] = a[2] = lo_alpha_in;
      } else {
        a[0] = lo.a - sdiv(lo.g, lo.h);
        a[1] = hi.a - sdiv(hi.g, hi.h);
        a[2] = 0.5f * (lo.a + hi.a);
      }
      // cost, slope and curvature at the three step sizes: each lane's
      // rows, then the nine sums over the warp
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = 0.0f;
      rows.eval3_lane(a, v, v + 3, v + 6);
      warp_sums<9>(v);
      Pt e[3];
#pragma unroll
      for (int t = 0; t < 3; ++t)
        e[t] = Pt{v[t] + a[t] * a[t] * g2 + a[t] * g1,
                  v[3 + t] + 2.0f * a[t] * g2 + g1, v[6 + t] + 2.0f * g2,
                  a[t]};
      if (it < 0) {
        li = e[0];
        init_conv = fabsf(li.g) < gtol && li.c < 0.0f;
        const bool lo_less = li.g < p1;
        const Pt p0{0.0f, p1, p2, 0.0f};
        lo = lo_less ? li : p0;
        hi = lo_less ? p0 : li;
        if (init_conv) break;
        continue;
      }
      bool swap_lo = swap3(&lo, e[0]);
      swap_lo = swap3(&lo, e[2]) || swap_lo;
      swap_lo = swap3(&lo, e[1]) || swap_lo;
      bool swap_hi = swap3(&hi, e[1]);
      swap_hi = swap3(&hi, e[2]) || swap_hi;
      swap_hi = swap3(&hi, e[0]) || swap_hi;
      if (lo.c < 0.0f || hi.c < 0.0f) {
        const bool lb = lo.c < hi.c;
        alpha = lb ? lo.a : hi.a;
        improve = -(lb ? lo.c : hi.c);
      }
      if ((!swap_lo && !swap_hi) ||
          (lo.c < 0.0f && lo.g < 0.0f && lo.g > -gtol) ||
          (hi.c < 0.0f && hi.g > 0.0f && hi.g < gtol))
        break;
    }
    if (init_conv) {
      alpha = lo_alpha_in;
      improve = -li.c;
    }

    // -- step and constraint state
    for (int i = lane; i < nv; i += 32) {
      x.qacc[i] = x.qacc[i] + alpha * x.search[i];
      x.Ma[i] = x.Ma[i] + alpha * x.mv[i];
    }
    for (int r = lane; r < rows.nrow; r += 32)
      rows.jaref(r) = rows.jaref(r) + alpha * rows.jv(r);
    __syncwarp();
    // elliptic contacts: H is rebuilt every iteration, its cone blocks
    // vary with Jaref (:969)
    refactor = rows.update_quad() || R::ELL;
  }
  return niter;
}
