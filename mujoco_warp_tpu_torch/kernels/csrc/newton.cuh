// The per-row code of the one-warp-per-world Newton solve
// (newton_warp.cuh), which the solve kernel (solve.cu) and K4 (k4.cu) run:
// the row force and constraint-state mask of the current Jaref, and each
// row's terms of the exact bracketed 3-alpha linesearch, for pyramidal
// and frictionless rows, equality rows (w_eq), friction-loss rows (w_fri,
// :321-329, :434, :717-720) and elliptic friction cones (ell, :445-486,
// :499-519, :619-713) of mujoco_warp_tpu/pallas/solver.py solve_core
// (:269).
//
// A row set R supplies the rows.  Per row r: D(r), aref(r), fl(r),
// kind(r) (ROW_INEQ, ROW_EQ, ROW_FRI or ROW_ELL) and the per-world slots
// jaref(r), jv(r), quad(r).  Rows with D == 0 are zero rows and add exact
// zeros wherever they are skipped.
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
