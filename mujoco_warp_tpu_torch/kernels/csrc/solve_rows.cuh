// The rows of one world's dense EFC system in shared memory and the
// warp steps of the one-warp Newton over them (newton_warp.cuh): the
// layout of the world's floats (SolveLayout) and the row set SolveRows.
// The solve kernel (solve.cu) loads an assembled system into this layout;
// K4 (k4.cu) builds its rows into it.  Rows with D == 0 are empty slots:
// the warp lists the live rows once, and the factor the rows whose D quad
// is non-zero, so the lanes share only rows that add to a sum.
#pragma once

#include "newton_warp.cuh"

// The coef region of the elliptic form holds per contact the
// linesearch's EC_N terms during a linesearch, and the CONE_N terms of
// the middle-zone cone blocks while H is built: the contact's normal row
// and dim, C00, pp and dg, then qv, f2 and C0 of its rows 1 .. 5.
enum { CT_R0, CT_DIM, CT_C00, CT_PP, CT_DG, CT_QV, CT_F2 = CT_QV + 5,
       CT_C0 = CT_F2 + 5, CONE_N = CT_C0 + 5 };
static_assert((int)EC_N <= (int)CONE_N, "the coef region holds both");

// One world's shared floats: offsets of each array and the total.  ncon
// counts the contacts of the elliptic form (0 for the other).
struct SolveLayout {
  int ld, J, M, L, D, aref, fl, jaref, jv, quad, frc, s, efrc, coef, vec,
      idx, total;
  __host__ __device__ SolveLayout(int nefc, int nv, int ncon) {
    ld = chol_stride(nv);
    J = 0;
    M = J + nefc * ld;
    L = M + nv * ld;
    D = L + nv * ld;
    aref = D + nefc;
    fl = aref + nefc;
    jaref = fl + nefc;
    jv = jaref + nefc;
    quad = jv + nefc;
    frc = quad + nefc;
    s = frc + nefc;
    const int ne = ncon ? nefc : 0;
    efrc = s + ne;
    coef = efrc + ne;
    // qacc, Ma, grad, search, mv, qfs, niter
    vec = coef + CONE_N * ncon;
    idx = vec + 6 * nv + 1;
    // lists: live rows, live rows outside elliptic contacts, the factor's
    // rows, the elliptic contacts and the live ones (16-bit indices)
    total = idx + (3 * nefc + 2 * ncon + 1) / 2;
  }
};

// the world's rows in shared memory (see newton_warp.cuh)
template <bool E>
struct SolveRows {
  static constexpr bool ELL = E;
  const int* kind_;   // (nefc,) global
  const int* etab_;   // (nefc, 3) global
  int nrow, nv, ld, lane;
  float *Jm, *M, *L;
  float *D_, *aref_, *fl_, *jaref_, *jv_, *quad_, *frc_, *s_, *efrc_, *coef_;
  unsigned short *lrow, *lnr, *act, *acon, *lcon;
  int nlive, nnr, nacon, nlcon;

  // kind: (nefc,) row kinds; etab: (nefc, 3) the elliptic form's table
  // (see solve.cu SolveParams); ncon: the elliptic contacts (0 for the
  // other form); b: the world's floats laid out as l
  __device__ __forceinline__ SolveRows(const int* kind, const int* etab,
                                       int nefc, int nv_, int ncon,
                                       const SolveLayout& l, float* b,
                                       int lane_)
      : kind_(kind), etab_(etab), nrow(nefc), nv(nv_), ld(l.ld),
        lane(lane_) {
    MWT_SHARED(b);
    Jm = b + l.J;
    M = b + l.M;
    L = b + l.L;
    D_ = b + l.D;
    aref_ = b + l.aref;
    fl_ = b + l.fl;
    jaref_ = b + l.jaref;
    jv_ = b + l.jv;
    quad_ = b + l.quad;
    frc_ = b + l.frc;
    s_ = b + l.s;
    efrc_ = b + l.efrc;
    coef_ = b + l.coef;
    lrow = (unsigned short*)(b + l.idx);
    lnr = lrow + nrow;
    act = lnr + nrow;
    acon = act + nrow;
    lcon = acon + (E ? ncon : 0);
  }

  __device__ __forceinline__ float J(int r, int v) const {
    return Jm[r * ld + v];
  }
  __device__ __forceinline__ int kind(int r) const {
    return __ldg(kind_ + r);
  }
  __device__ __forceinline__ float D(int r) const { return D_[r]; }
  __device__ __forceinline__ float aref(int r) const { return aref_[r]; }
  __device__ __forceinline__ float fl(int r) const { return fl_[r]; }
  __device__ __forceinline__ float& jaref(int r) const { return jaref_[r]; }
  __device__ __forceinline__ float& jv(int r) const { return jv_[r]; }
  __device__ __forceinline__ float& quad(int r) const { return quad_[r]; }
  __device__ __forceinline__ float& frc(int r) const { return frc_[r]; }
  // elliptic contacts
  __device__ __forceinline__ float s(int r) const { return s_[r]; }
  __device__ __forceinline__ int off(int r) const {
    return __ldg(etab_ + 3 * r);
  }
  __device__ __forceinline__ int dim(int r) const {
    return __ldg(etab_ + 3 * r + 1);
  }
  __device__ __forceinline__ int con(int r) const {
    return __ldg(etab_ + 3 * r + 2);
  }
  __device__ __forceinline__ float& efrc(int r) const { return efrc_[r]; }
  __device__ __forceinline__ float& coef(int c, int k) const {
    return coef_[c * EC_N + k];
  }
  __device__ __forceinline__ bool ell(int r) const {
    return E && kind(r) == ROW_ELL;
  }
  // does the elliptic contact at normal row r0 have a row with D != 0
  __device__ __forceinline__ bool con_live(int r0) const {
    const int d = dim(r0);
    bool live = false;
    for (int k = 0; k < d; ++k) live = live || D(r0 + k) != 0.0f;
    return live;
  }

  // the lists of rows and contacts the steps walk
  __device__ __forceinline__ void init() {
    nacon = nlcon = 0;
    if constexpr (E) {
      nacon = warp_compact(
          nrow, [&](int r) { return ell(r) && off(r) == 0; }, acon, lane);
      nlcon = warp_compact(nrow, [&](int r) {
        return ell(r) && off(r) == 0 && con_live(r);
      }, lcon, lane);
    }
    nlive = warp_compact(nrow, [&](int r) {
      return D(r) != 0.0f || (ell(r) && con_live(r - off(r)));
    }, lrow, lane);
    nnr = warp_compact(nrow, [&](int r) {
      return D(r) != 0.0f && !ell(r);
    }, lnr, lane);
  }

  // J[r, :] v, 0 on rows with D == 0
  __device__ __forceinline__ float jrow(int r, const float* v) const {
    return D(r) != 0.0f ? dot_in_order(0.0f, Jm + r * ld, v, nv) : 0.0f;
  }
  __device__ __forceinline__ void jaref_init(const float* v) const {
    for (int r = lane; r < nrow; r += 32) {
      jaref(r) = jrow(r, v) - aref(r);
      jv(r) = 0.0f;
    }
    __syncwarp();
  }
  __device__ __forceinline__ void jv_of(const float* v) const {
    for (int a = lane; a < nlive; a += 32) jv(lrow[a]) = jrow(lrow[a], v);
    __syncwarp();
  }
  __device__ __forceinline__ bool update_quad() const {
    bool flip = false;
    for (int r = lane; r < nrow; r += 32)
      if (!ell(r)) flip = quad_row(*this, r) || flip;
    if constexpr (E) {
      for (int a = lane; a < nacon; a += 32) ell_update(*this, acon[a]);
    }
    __syncwarp();
    return __any_sync(MWT_FULL, flip);
  }
  __device__ __forceinline__ void forces(bool all) const {
    if (all) {
      for (int r = lane; r < nrow; r += 32) frc(r) = row_force(*this, r);
    } else {
      for (int a = lane; a < nlive; a += 32)
        frc(lrow[a]) = row_force(*this, lrow[a]);
    }
    __syncwarp();
  }
  // out = J^T frc over the live rows in row order, dofs lane and lane +
  // 32 (nv <= MWT_MAX_NV); zero forces add exact zeros, so they are
  // skipped.  Four rows' loads at a time ahead of their sums.
  __device__ __forceinline__ void jt(float* out) const {
    const int v1 = lane + 32 < nv ? lane + 32 : lane;
    float acc0 = 0.0f, acc1 = 0.0f;
    int a = 0;
    for (; a + 4 <= nlive; a += 4) {
      float f[4], j0[4], j1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = lrow[a + u];
        f[u] = frc(r);
        j0[u] = J(r, lane);
        j1[u] = J(r, v1);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (f[u] != 0.0f) {
          acc0 = acc0 + j0[u] * f[u];
          acc1 = acc1 + j1[u] * f[u];
        }
    }
    for (; a < nlive; ++a) {
      const int r = lrow[a];
      const float f = frc(r);
      if (f != 0.0f) {
        acc0 = acc0 + J(r, lane) * f;
        acc1 = acc1 + J(r, v1) * f;
      }
    }
    if (lane < nv) out[lane] = acc0;
    if (lane + 32 < nv) out[lane + 32] = acc1;
    __syncwarp();
  }
  __device__ __forceinline__ void p0_lane(float* p1, float* p2) const {
    for (int a = lane; a < nnr; a += 32) p0_row(*this, lnr[a], p1, p2);
    if constexpr (E) {
      for (int a = lane; a < nlcon; a += 32) ell_hoist(*this, lcon[a], p1, p2);
    }
    __syncwarp();
  }
  __device__ __forceinline__ void eval3_lane(const float* a, float* c,
                                             float* g, float* hh) const {
    for (int b = lane; b < nnr; b += 32) eval3_row(*this, lnr[b], a, c, g, hh);
    if constexpr (E) {
      for (int b = lane; b < nlcon; b += 32)
        ell_eval3(*this, lcon[b], a, c, g, hh);
    }
  }

  // The middle-zone cone blocks (pallas/solver.py :471-485, _cone_col
  // :499-519), H += [J rows]^T C [J rows] per elliptic contact in that
  // zone, with, for q_j = u_j f_j and the weight dm, C00 = dm mu^2,
  // C0j = -(dm mu^2 / t) q_j,
  // Cjk = (dm mu N / t^3) q_j q_k + dm (mu^2 - N mu / t) f_j^2 delta_jk:
  // the lanes take the live contacts and list those in the middle zone
  // with their terms in the coef region, in row order.  Returns their
  // count.
  __device__ __forceinline__ int cone_table() const {
    int nmid = 0;
    for (int base0 = 0; base0 < nlcon; base0 += 32) {
      const int a = base0 + lane;
      const int r0 = a < nlcon ? lcon[a] : 0;
      float N = 0.0f, TT = 0.0f, T = 0.0f, mu = 0.0f, wt = 0.0f;
      bool mid = false;
      if (a < nlcon) {
        mu = s(r0);
        ell_state(*this, r0, &N, &TT, &T);
        if (ell_zone(N, TT, mu, T) == ZONE_MID) {
          wt = ell_dm(*this, r0);  // the block's weight dm
          mid = wt != 0.0f;
        }
      }
      const unsigned bal = __ballot_sync(MWT_FULL, mid);
      if (mid) {
        float* ct = coef_ + CONE_N * (nmid + __popc(bal & ((1u << lane) - 1u)));
        const int dim = this->dim(r0);
        const float t = fmaxf(T, MWT_MINVAL);
        const float ttt = fmaxf(t * t * t, MWT_MINVAL);
        const float c0s = -wt * mu * mu / t;
        ct[CT_R0] = __int_as_float(r0);
        ct[CT_DIM] = __int_as_float(dim);
        ct[CT_C00] = wt * mu * mu;
        ct[CT_PP] = wt * mu * N / ttt;
        ct[CT_DG] = wt * (mu * mu - N * mu / t);
        for (int k = 1; k < dim; ++k) {
          const float sk = s(r0 + k);
          const float qv = (jaref(r0 + k) * sk) * sk;
          ct[CT_QV + k - 1] = qv;
          ct[CT_F2 + k - 1] = sk * sk;
          ct[CT_C0 + k - 1] = c0s * qv;
        }
      }
      nmid += __popc(bal);
    }
    __syncwarp();
    return nmid;
  }

  // H = M + J^T diag(D quad) J (+ the cone blocks) on the lower triangle,
  // factored in place.  H is cut into 4 x 4 tiles, the lanes take the
  // tiles on and below the diagonal, and each sums its sixteen entries in
  // registers over the rows with D quad != 0 (from four J values of the
  // tile's rows and four of its columns per row), then adds each cone
  // block as its own sum, in the order of newton.cuh.  frc holds the
  // listed rows' D quad meanwhile (forces() refills it after).
  __device__ __forceinline__ void factor() const {
    const int nact = warp_compact(nrow, [&](int r) {
      return D(r) * quad(r) != 0.0f;
    }, act, lane);
    for (int b = lane; b < nact; b += 32) frc(b) = D(act[b]) * quad(act[b]);
    const int nmid = E ? cone_table() : 0;
    __syncwarp();
    const int nb = (nv + 3) >> 2;
    int ib = 0, kb = lane;  // tile (ib, kb), kb <= ib
    while (ib < nb && kb > ib) kb -= ++ib;
    while (ib < nb) {
      const int i0 = 4 * ib, k0 = 4 * kb;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
      for (int b = 0; b < nact; ++b) {
        const float* Jr = Jm + act[b] * ld;
        const float dq = frc(b);
        float jd[4], jk[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          jd[u] = Jr[i0 + u] * dq;
          jk[u] = Jr[k0 + u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = acc[u][v] + jd[u] * jk[v];
      }
      if constexpr (E) {
        for (int c = 0; c < nmid; ++c) {
          const float* ct = coef_ + CONE_N * c;
          const int r0 = __float_as_int(ct[CT_R0]);
          const int dim = __float_as_int(ct[CT_DIM]);
          const float C00 = ct[CT_C00], pp = ct[CT_PP], dg = ct[CT_DG];
          // C [J rows] at the tile's rows i: col[k][u] (_cone_col), and
          // the block against J at the tile's columns
          float qv[5], f2[5], C0[5];
#pragma unroll
          for (int k = 1; k < 6; ++k) {
            qv[k - 1] = ct[CT_QV + k - 1];
            f2[k - 1] = ct[CT_F2 + k - 1];
            C0[k - 1] = ct[CT_C0 + k - 1];
          }
          float col[6][4], blk[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float J0 = J(r0, i0 + u);
            float pJ = 0.0f, c0 = 0.0f;
#pragma unroll
            for (int k = 1; k < 6; ++k)
              if (k < dim) {
                const float Jk = J(r0 + k, i0 + u);
                pJ = pJ + qv[k - 1] * Jk;
                c0 = c0 + C0[k - 1] * Jk;
              }
            col[0][u] = C00 * J0 + c0;
#pragma unroll
            for (int k = 1; k < 6; ++k)
              col[k][u] = k < dim ? C0[k - 1] * J0 + pp * qv[k - 1] * pJ +
                                        dg * f2[k - 1] * J(r0 + k, i0 + u)
                                  : 0.0f;
#pragma unroll
            for (int v = 0; v < 4; ++v) blk[u][v] = 0.0f;
          }
#pragma unroll
          for (int k = 0; k < 6; ++k)
            if (k < dim) {
              float jk[4];
#pragma unroll
              for (int v = 0; v < 4; ++v) jk[v] = J(r0 + k, k0 + v);
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                  blk[u][v] = blk[u][v] + col[k][u] * jk[v];
            }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = acc[u][v] + blk[u][v];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + u, k = k0 + v;
          if (i < nv && k <= i) L[i * ld + k] = M[i * ld + k] + acc[u][v];
        }
      kb += 32;
      while (ib < nb && kb > ib) kb -= ++ib;
    }
    __syncwarp();
    chol_warp<MWT_MAX_NV>(L, nv, AtStrided{ld}, lane);
  }
};
