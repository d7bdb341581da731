// The Newton solve of K4 (k4.cu), one thread per world: the
// constraint-state update, the gradient, H = M + J^T D J with
// Cholesky-factor reuse, the exact bracketed 3-alpha linesearch and the
// per-world stop.  Its per-row code (row_force, quad_row, eval3_row,
// p0_row and the elliptic contacts' ell_*) also serves the standalone
// solver kernel's one-warp-per-world Newton (newton_warp.cuh, solve.cu).
// Counterpart of mujoco_warp_tpu/pallas/solver.py solve_core (:269) for
// pyramidal and frictionless rows, equality rows (w_eq), friction-loss
// rows (w_fri, :321-329, :434, :717-720) and elliptic friction cones
// (ell, :445-486, :499-519, :619-713).
//
// A row set R supplies the rows.  Per row r: D(r), aref(r), fl(r),
// kind(r) (ROW_INEQ, ROW_EQ, ROW_FRI or ROW_ELL) and the per-world slots
// jaref(r), jv(r), quad(r); for the whole set: nrow, jvec_jaref(v) and
// jvec_jv(v) (J v into the slot), jtforce(out) (J^T of the current row
// forces), factor() (H of the current state, factored into L()) and L().
// Rows with D == 0 are zero rows and add exact zeros wherever they are
// skipped.
//
// R::ELL (a compile-time constant) says whether the set holds elliptic
// contacts; without them every elliptic branch below compiles away.  An
// elliptic contact is `dim` consecutive rows [n, t1, t2, r1, r2, r3][:dim]
// of kind ROW_ELL, visited together from its normal row.  The set then
// also supplies per row s(r) (the row's scale: mu / sqrt(impratio) on the
// normal row, the friction coefficient f_k on the others), off(r) (the
// row's place in its contact), dim(r) and con(r) (its contact), the slot
// efrc(r) (the row's force of the current state) and the per-contact
// slots coef(c, k) (the linesearch's alpha-independent terms).
#pragma once

#include "common.cuh"

enum { ROW_INEQ = 0, ROW_EQ = 1, ROW_FRI = 2, ROW_ELL = 3 };

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
  if constexpr (R::ELL) {
    if (k == ROW_ELL) return rows.efrc(r);
  }
  if (k == ROW_FRI) {
    const float rf = row_rf(rows, r), fl = rows.fl(r);
    return ja <= -rf ? fl : (ja >= rf ? -fl : f);
  }
  return (k == ROW_EQ || ja < 0.0f) ? f : f * 0.0f;
}

// ---- elliptic contacts (pallas/solver.py solve_core with `ell`)

// the zone of an elliptic contact from N = mu Jaref_n and TT = |u|^2
// (:454-459): 0 top (no force), 1 middle (on the cone), 2 bottom (inside)
enum { ZONE_TOP = 0, ZONE_MID = 1, ZONE_BOTTOM = 2 };

__device__ __forceinline__ int ell_zone(float N, float TT, float mu,
                                        float T) {
  const bool top = (N >= mu * T) || (TT <= 0.0f && N >= 0.0f);
  if (top) return ZONE_TOP;
  const bool bottom = (mu * N + T <= 0.0f) || (TT <= 0.0f && N < 0.0f);
  return bottom ? ZONE_BOTTOM : ZONE_MID;
}

// N, TT and T of the contact whose normal row is r0, at the current Jaref
template <class R>
__device__ __forceinline__ void ell_state(const R& rows, int r0, float* N,
                                          float* TT, float* T) {
  const int dim = rows.dim(r0);
  *N = rows.jaref(r0) * rows.s(r0);
  float tt = 0.0f;
  for (int k = 1; k < dim; ++k) {
    const float u = rows.jaref(r0 + k) * rows.s(r0 + k);
    tt = tt + u * u;
  }
  *TT = tt;
  *T = sqrtf(fmaxf(tt, 0.0f));
}

// dm = D_n / (mu^2 (1 + mu^2)) through sdiv (:460)
template <class R>
__device__ __forceinline__ float ell_dm(const R& rows, int r0) {
  const float mu = rows.s(r0);
  return sdiv(rows.D(r0), mu * mu * (1.0f + mu * mu));
}

// forces and mask of one elliptic contact (:445-470): none in the top
// zone, -D Jaref (mask 1) in the bottom zone, the cone force in the middle
template <class R>
__device__ __forceinline__ void ell_update(const R& rows, int r0) {
  const int dim = rows.dim(r0);
  const float mu = rows.s(r0);
  float N, TT, T;
  ell_state(rows, r0, &N, &TT, &T);
  const int zone = ell_zone(N, TT, mu, T);
  const float dm = ell_dm(rows, r0);
  const float fn = -dm * (N - mu * T) * mu;
  const float ft = -sdiv(fn, T);
  for (int k = 0; k < dim; ++k) {
    const int r = r0 + k;
    float f = 0.0f;
    if (zone == ZONE_BOTTOM) {
      f = -rows.D(r) * rows.jaref(r);
    } else if (zone == ZONE_MID) {
      f = k == 0 ? fn : ft * (rows.jaref(r) * rows.s(r)) * rows.s(r);
    }
    rows.efrc(r) = f;
    rows.quad(r) = zone == ZONE_BOTTOM ? 1.0f : 0.0f;
  }
}

// the per-contact terms of one linesearch (:619-651), hoisted out of the
// evaluations into coef(c, .), and the contact's slope and curvature at
// alpha = 0 (_ell_p0 :698-713) added to *g0, *h0
enum {
  EC_MU, EC_Q1, EC_Q2, EC_U0, EC_V0, EC_UU, EC_UV, EC_VV, EC_DM, EC_T0,
  EC_COST0, EC_R0, EC_SQUAD, EC_SCONE, EC_N
};

template <class R>
__device__ __forceinline__ void ell_hoist(const R& rows, int r0, float* g0,
                                          float* h0) {
  const int dim = rows.dim(r0), c = rows.con(r0);
  const float mu = rows.s(r0);
  float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, uu = 0.0f, uv = 0.0f, vv = 0.0f;
  for (int k = 0; k < dim; ++k) {
    const int r = r0 + k;
    const float jar = rows.jaref(r), jv = rows.jv(r), D = rows.D(r);
    const float DJ = D * jar;
    q0 = q0 + 0.5f * jar * DJ;
    q1 = q1 + jv * DJ;
    q2 = q2 + 0.5f * jv * D * jv;
    if (k) {
      const float su = jar * rows.s(r), sv = jv * rows.s(r);
      uu = uu + su * su;
      uv = uv + su * sv;
      vv = vv + sv * sv;
    }
  }
  const float u0 = rows.jaref(r0) * mu, v0 = rows.jv(r0) * mu;
  const float dm = ell_dm(rows, r0);
  const float T0 = sqrtf(fmaxf(uu, 0.0f));
  const bool no_t = uu <= 0.0f;
  const bool sat = no_t ? u0 >= 0.0f : u0 >= mu * T0;
  const bool qz = no_t ? u0 < 0.0f : mu * u0 + T0 <= 0.0f;
  const float s0_quad = (qz && !sat) ? 1.0f : 0.0f;
  const float s0_cone = (!sat && !qz) ? 1.0f : 0.0f;
  const float r0r = u0 - mu * T0;
  const float cost0 = (1.0f - (sat ? 1.0f : 0.0f)) *
                      ((qz && !sat) ? q0 : 0.5f * dm * r0r * r0r);
  const float r0c = s0_cone * r0r;
  const float vals[EC_N] = {mu, q1, q2, u0, v0, uu, uv, vv, dm, T0,
                            cost0, r0c, s0_quad, s0_cone};
  for (int k = 0; k < EC_N; ++k) rows.coef(c, k) = vals[k];
  // _ell_p0
  const float T0_inv = 1.0f / fmaxf(T0, MWT_MINVAL);
  const float T1 = uv * T0_inv;
  const float T2 = (vv - T1 * T1) * T0_inv;
  const float r1 = v0 - mu * T1;
  const float g_m = dm * r0c * r1;
  const float h_m = dm * (r1 * r1 - mu * r0c * T2);
  *g0 = *g0 + (s0_quad * q1 + s0_cone * g_m);
  *h0 = *h0 + (s0_quad * 2.0f * q2 + s0_cone * h_m);
}

// the contact's cost change, slope and curvature at three step sizes
// (_ell_ev :653-696), added to c, g, hh
template <class R>
__device__ __forceinline__ void ell_eval3(const R& rows, int r0,
                                          const float* a, float* c, float* g,
                                          float* hh) {
  float e[EC_N];
  const int ci = rows.con(r0);
  for (int k = 0; k < EC_N; ++k) e[k] = rows.coef(ci, k);
  const float mu = e[EC_MU], dm = e[EC_DM], q1 = e[EC_Q1], q2 = e[EC_Q2];
  const float u0 = e[EC_U0], v0 = e[EC_V0], T0 = e[EC_T0];
  const float s0c = e[EC_SCONE], s0q = e[EC_SQUAD];
  for (int t = 0; t < 3; ++t) {
    const float al = a[t];
    const float N = u0 + al * v0;
    const float Tsqr_delta = al * (2.0f * e[EC_UV] + al * e[EC_VV]);
    const float Tsqr = e[EC_UU] + Tsqr_delta;
    const float T = sqrtf(fmaxf(Tsqr, 0.0f));
    const bool no_t = Tsqr <= 0.0f;
    const bool in_quad = no_t ? N < 0.0f : mu * N + T <= 0.0f;
    const bool in_top = !no_t && N >= mu * T;
    const bool in_mid = !no_t && !in_top && !in_quad;
    const float aq2 = al * q2;
    if (in_quad) {
      const float b0 = mu * u0 + T0;
      const float c_q = al * (aq2 + q1) +
                        (s0c * 0.5f * dm * (b0 * b0) +
                         (1.0f - s0c - s0q) * 0.5f * dm * (1.0f + mu * mu) *
                             (N * N + fmaxf(Tsqr, 0.0f)));
      c[t] = c[t] + c_q;
      g[t] = g[t] + (2.0f * aq2 + q1);
      hh[t] = hh[t] + 2.0f * q2;
    } else if (in_mid) {
      const float boundary = mu * N + T;
      const float gap = 0.5f * dm * boundary * boundary;
      const float T_inv = 1.0f / fmaxf(T, MWT_MINVAL);
      const float T1 = (e[EC_UV] + al * e[EC_VV]) * T_inv;
      const float T2 = (e[EC_VV] - T1 * T1) * T_inv;
      const float r = N - mu * T;
      const float r1 = v0 - mu * T1;
      const float T_delta = Tsqr_delta / fmaxf(T + T0, MWT_MINVAL);
      const float r_delta = al * v0 - mu * T_delta;
      const float c_m = s0c * 0.5f * dm * r_delta *
                            (2.0f * e[EC_R0] + r_delta) +
                        s0q * (al * (aq2 + q1) - gap) +
                        (1.0f - s0c - s0q) * 0.5f * dm * r * r;
      c[t] = c[t] + c_m;
      g[t] = g[t] + dm * r * r1;
      hh[t] = hh[t] + dm * (r1 * r1 + r * (-mu * T2));
    } else {
      c[t] = c[t] + (-e[EC_COST0]);
    }
  }
}

// the mask of row r (not of an elliptic contact) at the current Jaref;
// returns true if it changed
template <class R>
__device__ __forceinline__ bool quad_row(const R& rows, int r) {
  const float ja = rows.jaref(r);
  const int k = rows.kind(r);
  float q;
  if (k == ROW_FRI) {
    const float rf = row_rf(rows, r);
    q = (ja > -rf && ja < rf) ? 1.0f : 0.0f;
  } else {
    q = (k == ROW_EQ || ja < 0.0f) ? 1.0f : 0.0f;
  }
  const bool flip = q != rows.quad(r);
  rows.quad(r) = q;
  return flip;
}

// constraint-state mask of the current Jaref; returns true if it changed
// (elliptic contacts also set their forces)
template <class R>
__device__ bool update_quad(const R& rows) {
  bool flip = false;
  for (int r = 0; r < rows.nrow; ++r) {
    if constexpr (R::ELL) {
      if (rows.kind(r) == ROW_ELL) {
        ell_update(rows, r);
        r += rows.dim(r) - 1;
        continue;
      }
    }
    flip = quad_row(rows, r) || flip;
  }
  return flip;
}

// the cost change, slope and curvature of row r (not of an elliptic
// contact) at three step sizes, added to c, g, hh
template <class R>
__device__ __forceinline__ void eval3_row(const R& rows, int r,
                                          const float* a, float* c, float* g,
                                          float* hh) {
  const float D = rows.D(r);
  if (D == 0.0f) return;  // a zero row adds exact zeros
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
    return;
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

// cost, slope and curvature of the row terms at three step sizes
template <class R>
__device__ void eval3(const R& rows, const float* a, float* c, float* g,
                      float* hh) {
  for (int t = 0; t < 3; ++t) c[t] = g[t] = hh[t] = 0.0f;
  for (int r = 0; r < rows.nrow; ++r) {
    if constexpr (R::ELL) {
      if (rows.kind(r) == ROW_ELL) {
        if (rows.off(r) == 0) ell_eval3(rows, r, a, c, g, hh);
        continue;
      }
    }
    eval3_row(rows, r, a, c, g, hh);
  }
}

// the slope and curvature of row r (not of an elliptic contact) at
// alpha = 0, added to *p1, *p2
template <class R>
__device__ __forceinline__ void p0_row(const R& rows, int r, float* p1,
                                       float* p2) {
  const float ja = rows.jaref(r), jv = rows.jv(r);
  const float jvD = jv * rows.D(r);
  const int kind = rows.kind(r);
  if (kind == ROW_FRI) {
    const float rf = row_rf(rows, r), fl = rows.fl(r);
    const bool mid = -rf < ja && ja < rf;
    *p1 = *p1 + (mid ? jvD * ja : (ja <= -rf ? -fl * jv : fl * jv));
    *p2 = *p2 + jv * jvD * (mid ? 1.0f : 0.0f);
  } else if (kind == ROW_EQ || ja < 0.0f) {
    *p1 = *p1 + jvD * ja;
    *p2 = *p2 + jv * jvD;
  }
}

// Newton from the warmstart `ws` (lanes-last (nv, W)) to qacc; qM and qfs
// (the smooth force) lanes-last.  Returns the iteration count.  The loop
// and the linesearch exit per world; done worlds are not touched again,
// and without elliptic contacts the factor is rebuilt only when the
// world's own mask flipped.
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
      if constexpr (R::ELL) {
        if (rows.kind(r) == ROW_ELL) {
          if (rows.off(r) == 0) ell_hoist(rows, r, &p1, &p2);
          continue;
        }
      }
      p0_row(rows, r, &p1, &p2);
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
    // elliptic contacts: H is rebuilt every iteration, its cone blocks
    // vary with Jaref (:969)
    if (update_quad(rows) || R::ELL) rows.factor();
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
