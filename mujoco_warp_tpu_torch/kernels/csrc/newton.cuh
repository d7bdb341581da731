// The Newton solve shared by K4 (k4.cu) and the standalone solver kernel
// (solve.cu), one thread per world: the constraint-state update, the
// gradient, H = M + J^T D J with Cholesky-factor reuse, the exact
// bracketed 3-alpha linesearch and the per-world stop.  Counterpart of
// mujoco_warp_tpu/pallas/solver.py solve_core (:269) for pyramidal and
// frictionless rows, equality rows (w_eq) and friction-loss rows (w_fri,
// :321-329, :434, :717-720).
//
// A row set R supplies the rows.  Per row r: D(r), aref(r), fl(r),
// kind(r) (ROW_INEQ, ROW_EQ or ROW_FRI) and the per-world slots jaref(r),
// jv(r), quad(r); for the whole set: nrow, jvec_jaref(v) and jvec_jv(v)
// (J v into the slot), jtforce(out) (J^T of the current row forces),
// factor() (H of the current mask, factored into L()) and L().  Rows with
// D == 0 are zero rows and add exact zeros wherever they are skipped.
#pragma once

#include "common.cuh"

enum { ROW_INEQ = 0, ROW_EQ = 1, ROW_FRI = 2 };

__device__ __forceinline__ float sdiv(float a, float b) {
  float d = fabsf(b) > MWT_MINVAL ? b : (b >= 0.0f ? MWT_MINVAL : -MWT_MINVAL);
  return a / d;
}

__device__ __forceinline__ bool in_bracket(float xg, float yg) {
  return (xg < yg && yg < 0.0f) || (xg > yg && yg > 0.0f);
}

struct Pt {
  float c, g, h, a;
};

// swap `cur` for `nw` when nw brackets tighter (solver.py swap3)
__device__ __forceinline__ bool swap3(Pt* cur, const Pt& nw) {
  bool sw = in_bracket(cur->g, nw.g);
  if (sw) *cur = nw;
  return sw;
}

// friction-loss row: the |Jaref| beyond which the force saturates at fl
template <class R>
__device__ __forceinline__ float row_rf(const R& rows, int r) {
  return rows.fl(r) / fmaxf(rows.D(r), MWT_MINVAL);
}

// the row force of the current constraint state (update_constraint)
template <class R>
__device__ __forceinline__ float row_force(const R& rows, int r) {
  const float ja = rows.jaref(r);
  const float f = -rows.D(r) * ja;
  const int k = rows.kind(r);
  if (k == ROW_FRI) {
    const float rf = row_rf(rows, r), fl = rows.fl(r);
    return ja <= -rf ? fl : (ja >= rf ? -fl : f);
  }
  return (k == ROW_EQ || ja < 0.0f) ? f : f * 0.0f;
}

// constraint-state mask of the current Jaref; returns true if it changed
template <class R>
__device__ bool update_quad(const R& rows) {
  bool flip = false;
  for (int r = 0; r < rows.nrow; ++r) {
    const float ja = rows.jaref(r);
    const int k = rows.kind(r);
    float q;
    if (k == ROW_FRI) {
      const float rf = row_rf(rows, r);
      q = (ja > -rf && ja < rf) ? 1.0f : 0.0f;
    } else {
      q = (k == ROW_EQ || ja < 0.0f) ? 1.0f : 0.0f;
    }
    flip = flip || (q != rows.quad(r));
    rows.quad(r) = q;
  }
  return flip;
}

// cost, slope and curvature of the row terms at three step sizes
template <class R>
__device__ void eval3(const R& rows, const float* a, float* c, float* g,
                      float* hh) {
  for (int t = 0; t < 3; ++t) c[t] = g[t] = hh[t] = 0.0f;
  for (int r = 0; r < rows.nrow; ++r) {
    const float D = rows.D(r);
    if (D == 0.0f) continue;  // a zero row adds exact zeros
    const float ja = rows.jaref(r), jv = rows.jv(r);
    const float jvD = jv * D, grad0 = jvD * ja, hess = jv * jvD;
    const float quad0 = 0.5f * D * ja * ja;
    const float cost0 = quad0 * (ja < 0.0f ? 1.0f : 0.0f);
    const float offset = quad0 - cost0;
    const int kind = rows.kind(r);
    if (kind == ROW_FRI) {
      const float rf = row_rf(rows, r), fl = rows.fl(r);
      const float cf0 = (-rf < ja && ja < rf)
                            ? quad0
                            : (ja <= -rf ? fl * (-0.5f * rf - ja)
                                         : fl * (-0.5f * rf + ja));
      for (int t = 0; t < 3; ++t) {
        const float x = ja + a[t] * jv;
        const bool mid = -rf < x && x < rf;
        const float cf = mid ? 0.5f * D * x * x
                             : (x <= -rf ? fl * (-0.5f * rf - x)
                                         : fl * (-0.5f * rf + x));
        const float gf = mid ? jvD * x : (x <= -rf ? -fl * jv : fl * jv);
        c[t] = c[t] + (cf - cf0);
        g[t] = g[t] + gf;
        hh[t] = hh[t] + hess * (mid ? 1.0f : 0.0f);
      }
      continue;
    }
    const bool eq = kind == ROW_EQ;
    for (int t = 0; t < 3; ++t) {
      const float x = ja + a[t] * jv;
      const float g_eq = grad0 + a[t] * hess;
      const float c_eq = 0.5f * a[t] * (grad0 + g_eq);
      if (eq) {
        c[t] = c[t] + c_eq;
        g[t] = g[t] + g_eq;
        hh[t] = hh[t] + hess;
      } else if (x < 0.0f) {
        c[t] = c[t] + (c_eq + offset);
        g[t] = g[t] + g_eq;
        hh[t] = hh[t] + hess;
      } else {
        c[t] = c[t] + (-cost0);
      }
    }
  }
}

// Newton from the warmstart `ws` (lanes-last (nv, W)) to qacc; qM and qfs
// (the smooth force) lanes-last.  Returns the iteration count.  The loop
// and the linesearch exit per world; done worlds are not touched again,
// and the factor is rebuilt only when the world's own mask flipped.
template <class R>
__device__ float newton_solve(const R& rows, const float* qM, const float* qfs,
                              const float* ws, float* qacc, int nv,
                              int iterations, int ls_iterations, float tol,
                              float ls_tol, float mi, int W, int w) {
  const float rescale = 1.0f / (mi * (float)nv);
  float Ma[MWT_MAX_NV], grad[MWT_MAX_NV], search[MWT_MAX_NV];
  float mv[MWT_MAX_NV];
  float niter = 0.0f;
  for (int i = 0; i < nv; ++i) qacc[i] = LANE(ws, i);
  rows.jvec_jaref(qacc);
  for (int r = 0; r < rows.nrow; ++r) rows.jaref(r) = rows.jaref(r) - rows.aref(r);
  for (int i = 0; i < nv; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < nv; ++k) acc = acc + LANE(qM, i * nv + k) * qacc[k];
    Ma[i] = acc;
  }
  update_quad(rows);
  rows.factor();
  rows.jtforce(grad);
  float gg = 0.0f;
  for (int i = 0; i < nv; ++i) {
    grad[i] = Ma[i] - LANE(qfs, i) - grad[i];
    gg = gg + grad[i] * grad[i];
  }
  chol_solve_lanes(rows.L(), grad, search, nv, W, w);
  for (int i = 0; i < nv; ++i) search[i] = -search[i];
  bool done = rescale * sqrtf(fmaxf(gg, 0.0f)) < tol;

  while (!done) {
    // -- linesearch along `search`
    rows.jvec_jv(search);
    float g1 = 0.0f, g2 = 0.0f, ss = 0.0f;
    for (int i = 0; i < nv; ++i) {
      float acc = 0.0f;
      for (int k = 0; k < nv; ++k) acc = acc + LANE(qM, i * nv + k) * search[k];
      mv[i] = acc;
      g1 = g1 + search[i] * (Ma[i] - LANE(qfs, i));
      g2 = g2 + search[i] * mv[i];
      ss = ss + search[i] * search[i];
    }
    g2 = 0.5f * g2;
    const float snorm = sqrtf(fmaxf(ss, 0.0f));
    const float gtol = fmaxf(tol * ls_tol * snorm * mi * (float)nv, 1e-6f);
    float p1 = 0.0f, p2 = 0.0f;
    for (int r = 0; r < rows.nrow; ++r) {
      const float ja = rows.jaref(r), jv = rows.jv(r);
      const float jvD = jv * rows.D(r);
      const int kind = rows.kind(r);
      if (kind == ROW_FRI) {
        const float rf = row_rf(rows, r), fl = rows.fl(r);
        const bool mid = -rf < ja && ja < rf;
        p1 = p1 + (mid ? jvD * ja : (ja <= -rf ? -fl * jv : fl * jv));
        p2 = p2 + jv * jvD * (mid ? 1.0f : 0.0f);
      } else if (kind == ROW_EQ || ja < 0.0f) {
        p1 = p1 + jvD * ja;
        p2 = p2 + jv * jvD;
      }
    }
    p1 = p1 + g1;
    p2 = p2 + 2.0f * g2;
    auto finish = [&](float* a, Pt* out) {
      float c[3], g[3], hh[3];
      eval3(rows, a, c, g, hh);
      for (int t = 0; t < 3; ++t)
        out[t] = Pt{c[t] + a[t] * a[t] * g2 + a[t] * g1,
                    g[t] + 2.0f * a[t] * g2 + g1, hh[t] + 2.0f * g2, a[t]};
    };
    const float lo_alpha_in = -sdiv(p1, p2);
    Pt li[3];
    {
      float a[3] = {lo_alpha_in, lo_alpha_in, lo_alpha_in};
      finish(a, li);
    }
    const bool init_conv = fabsf(li[0].g) < gtol && li[0].c < 0.0f;
    const bool lo_less = li[0].g < p1;
    const Pt p0{0.0f, p1, p2, 0.0f};
    Pt lo = lo_less ? li[0] : p0, hi = lo_less ? p0 : li[0];
    float alpha = 0.0f, improve = 0.0f;
    bool ls_done = init_conv;
    for (int it = 0; it < ls_iterations && !ls_done; ++it) {
      float a[3] = {lo.a - sdiv(lo.g, lo.h), hi.a - sdiv(hi.g, hi.h),
                    0.5f * (lo.a + hi.a)};
      Pt e[3];  // lo_next, hi_next, mid
      finish(a, e);
      bool swap_lo = swap3(&lo, e[0]);
      swap_lo = swap3(&lo, e[2]) || swap_lo;
      swap_lo = swap3(&lo, e[1]) || swap_lo;
      bool swap_hi = swap3(&hi, e[1]);
      swap_hi = swap3(&hi, e[2]) || swap_hi;
      swap_hi = swap3(&hi, e[0]) || swap_hi;
      ls_done = (!swap_lo && !swap_hi) ||
                (lo.c < 0.0f && lo.g < 0.0f && lo.g > -gtol) ||
                (hi.c < 0.0f && hi.g > 0.0f && hi.g < gtol);
      if (lo.c < 0.0f || hi.c < 0.0f) {
        const bool lb = lo.c < hi.c;
        alpha = lb ? lo.a : hi.a;
        improve = -(lb ? lo.c : hi.c);
      }
    }
    if (init_conv) {
      alpha = lo_alpha_in;
      improve = -li[0].c;
    }

    // -- step, constraint state, gradient
    for (int i = 0; i < nv; ++i) {
      qacc[i] = qacc[i] + alpha * search[i];
      Ma[i] = Ma[i] + alpha * mv[i];
    }
    for (int r = 0; r < rows.nrow; ++r)
      rows.jaref(r) = rows.jaref(r) + alpha * rows.jv(r);
    if (update_quad(rows)) rows.factor();
    rows.jtforce(grad);
    gg = 0.0f;
    for (int i = 0; i < nv; ++i) {
      grad[i] = Ma[i] - LANE(qfs, i) - grad[i];
      gg = gg + grad[i] * grad[i];
    }
    chol_solve_lanes(rows.L(), grad, search, nv, W, w);
    float gm = 0.0f;
    for (int i = 0; i < nv; ++i) gm = gm + grad[i] * search[i];
    niter = niter + 1.0f;
    const float gnorm = rescale * sqrtf(fmaxf(gg, 0.0f));
    const float model_impr = rescale * 0.5f * gm;
    done = rescale * improve < tol || gnorm < tol || model_impr < tol ||
           niter >= (float)iterations;
    for (int i = 0; i < nv; ++i) search[i] = -search[i];
  }
  return niter;
}
