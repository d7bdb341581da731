// The standalone Newton solver kernel of the general step, one warp per
// world, over an assembled dense EFC system: equality, friction-loss and
// inequality (limit, pyramidal and frictionless contact) rows, and
// elliptic contacts.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/solver.py
// _make_kernel (:1041, launched by _solve_tiles :1126 from solve_batched
// :1145) in both its forms: solve_kernel for models without elliptic
// contacts, solve_ell_kernel for elliptic cones.  The Newton loop and the
// linesearch are newton_warp.cuh, on the per-row code of newton.cuh that
// K4 shares.  The rows stay in the model's order: where the Pallas kernel
// permutes each condim's elliptic contacts into a contiguous block
// (_ell_perm :70), a per-row table (kind ROW_ELL, the row's place in its
// contact, the contact's dim and index; uploaded once per model) lets the
// row walk visit a contact's rows together.
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

#include "newton_warp.cuh"

struct SolveParams {
  int W, nv, nefc, ncon, iterations, ls_iterations;
  float tol, ls_tol, meaninertia;
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

  __device__ __forceinline__ SolveRows(const SolveParams& p,
                                       const SolveLayout& l, float* b,
                                       int lane_)
      : kind_(p.kind), etab_(p.etab), nrow(p.nefc), nv(p.nv), ld(l.ld),
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
    lcon = acon + (E ? p.ncon : 0);
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
    SolveRows<E> R(p, lay, b, lane);
    R.init();
    float* v = b + lay.vec;
    const WarpVecs x{v, v + nv, v + 2 * nv, v + 3 * nv, v + 4 * nv,
                     v + 5 * nv};
    const float niter = newton_solve_warp<MWT_MAX_NV>(
        R, R.M, x, nv, p.iterations, p.ls_iterations, p.tol, p.ls_tol,
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
