// The standalone Newton solver kernel of the general step, one thread per
// world, over an assembled dense EFC system: equality, friction-loss and
// inequality (limit, pyramidal and frictionless contact) rows, and
// elliptic contacts.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/solver.py
// _make_kernel (:1041, launched by _solve_tiles :1126 from solve_batched
// :1145) in both its forms: solve_kernel for models without elliptic
// contacts, solve_ell_kernel for elliptic cones.  The Newton loop, the
// linesearch and the factor reuse are newton.cuh, shared with K4.  The
// rows stay in the model's order: where the Pallas kernel permutes each
// condim's elliptic contacts into a contiguous block (_ell_perm :70), a
// per-row table (kind ROW_ELL, the row's place in its contact, the
// contact's dim and index; uploaded once per model) lets the row walk
// visit a contact's rows together.  The middle-zone cone block
// dm [J rows]^T C [J rows] of each contact is built in registers from its
// Jaref and row scales when H is built; the linesearch's per-contact
// terms live in per-world scratch rows.
//
// Bound.  Per world it reads J (nefc nv), D, aref, fl (nefc each), the
// row scales s (nefc, elliptic only), M (nv^2) and two nv vectors, and
// writes qacc, qfrc_constraint (nv each), efc_force (nefc) and niter: at
// the constraints scene (nefc 14, nv 13) 1.7 KB per world, 14 MB at 8192
// worlds (4 us at 3.35 TB/s).  Each Newton iteration costs ~nefc nv^2 / 2
// flops for H and ~nv^3 / 3 for its factor when a row flips (every
// iteration with elliptic contacts), a few thousand to tens of thousands
// of flops per world; with one thread per world the kernel is
// latency-bound by its dependent chain of scratch accesses, like K4.

#include "newton.cuh"

struct SolveParams {
  int W, nv, nefc, iterations, ls_iterations;
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
  // (3 nefc + nv nv, W): jaref, jv, quad, L; the elliptic form adds
  // (nefc + EC_N ncon, W): efrc, then coef per contact
  float* scr;
  const int* kind;     // (nefc,) ROW_INEQ, ROW_EQ, ROW_FRI or ROW_ELL
  // the elliptic form's inputs, null for the other form
  const float* s;      // (nefc, W) elliptic row scales
  const int* etab;     // (nefc, 3) off, dim, contact
};

// dense rows read from the inputs, per-world slots in scratch
template <bool E>
struct SolveRows {
  static constexpr bool ELL = E;
  const SolveParams& p;
  int W, w, nrow;

  __device__ float J(int r, int v) const {
    return p.J[(size_t)(r * p.nv + v) * W + w];
  }
  __device__ float& slot(int base, int r) const {
    return p.scr[(size_t)(base + r) * W + w];
  }
  __device__ int kind(int r) const { return p.kind[r]; }
  __device__ float D(int r) const { return LANE(p.D, r); }
  __device__ float aref(int r) const { return LANE(p.aref, r); }
  __device__ float fl(int r) const { return LANE(p.fl, r); }
  __device__ float& jaref(int r) const { return slot(0, r); }
  __device__ float& jv(int r) const { return slot(nrow, r); }
  __device__ float& quad(int r) const { return slot(2 * nrow, r); }
  __device__ float* L() const { return p.scr + (size_t)(3 * nrow) * W; }
  // elliptic contacts
  __device__ float s(int r) const { return LANE(p.s, r); }
  __device__ int off(int r) const { return p.etab[3 * r]; }
  __device__ int dim(int r) const { return p.etab[3 * r + 1]; }
  __device__ int con(int r) const { return p.etab[3 * r + 2]; }
  __device__ float& efrc(int r) const {
    return slot(3 * nrow + p.nv * p.nv, r);
  }
  __device__ float& coef(int c, int k) const {
    return slot(4 * nrow + p.nv * p.nv, c * EC_N + k);
  }
  // J v into the slot at `base`; rows with D == 0 are zero rows
  __device__ void jvec(const float* v, int base) const {
    for (int r = 0; r < nrow; ++r) {
      float acc = 0.0f;
      if (D(r) != 0.0f)
        for (int k = 0; k < p.nv; ++k) acc = acc + J(r, k) * v[k];
      slot(base, r) = acc;
    }
  }
  __device__ void jvec_jaref(const float* v) const { jvec(v, 0); }
  __device__ void jvec_jv(const float* v) const { jvec(v, nrow); }
  // J^T f of the current row forces; zero forces add exact zeros
  __device__ void jtforce(float* out) const {
    for (int v = 0; v < p.nv; ++v) out[v] = 0.0f;
    for (int r = 0; r < nrow; ++r) {
      const float f = row_force(*this, r);
      if (f == 0.0f) continue;
      for (int v = 0; v < p.nv; ++v) out[v] = out[v] + J(r, v) * f;
    }
  }
  // the middle-zone cone block of the elliptic contact at normal row r0
  // (pallas/solver.py :471-485, _cone_col :499-519) added to the lower
  // triangle Lb: H += [J rows]^T C [J rows] with, for q_j = u_j f_j and
  // the weight dm, C00 = dm mu^2, C0j = -(dm mu^2 / t) q_j,
  // Cjk = (dm mu N / t^3) q_j q_k + dm (mu^2 - N mu / t) f_j^2 delta_jk
  __device__ void cone_block(int r0, float* Lb) const {
    const int nv = p.nv, dim = this->dim(r0);
    const float mu = s(r0);
    float N, TT, T;
    ell_state(*this, r0, &N, &TT, &T);
    if (ell_zone(N, TT, mu, T) != ZONE_MID) return;
    const float wt = ell_dm(*this, r0);  // the block's weight dm
    if (wt == 0.0f) return;
    const float t = fmaxf(T, MWT_MINVAL);
    const float ttt = fmaxf(t * t * t, MWT_MINVAL);
    float qv[6], f2[6], C0[6];
    const float c0s = -wt * mu * mu / t;
    for (int k = 1; k < dim; ++k) {
      const float sk = s(r0 + k);
      qv[k] = (jaref(r0 + k) * sk) * sk;
      f2[k] = sk * sk;
      C0[k] = c0s * qv[k];
    }
    const float C00 = wt * mu * mu;
    const float pp = wt * mu * N / ttt;
    const float dg = wt * (mu * mu - N * mu / t);
    float col[6];
    for (int i = 0; i < nv; ++i) {
      const float J0 = J(r0, i);
      float pJ = 0.0f, c0 = 0.0f;
      for (int k = 1; k < dim; ++k) {
        const float Jk = J(r0 + k, i);
        pJ = pJ + qv[k] * Jk;
        c0 = c0 + C0[k] * Jk;
      }
      col[0] = C00 * J0 + c0;
      bool any = col[0] != 0.0f;
      for (int k = 1; k < dim; ++k) {
        col[k] = C0[k] * J0 + pp * qv[k] * pJ + dg * f2[k] * J(r0 + k, i);
        any = any || col[k] != 0.0f;
      }
      if (!any) continue;
      for (int kk = 0; kk <= i; ++kk) {
        float acc = 0.0f;
        for (int k = 0; k < dim; ++k) acc = acc + col[k] * J(r0 + k, kk);
        LANE(Lb, i * nv + kk) = LANE(Lb, i * nv + kk) + acc;
      }
    }
  }
  // H = M + J^T diag(D quad) J (+ the cone blocks) on the lower triangle,
  // factored in place
  __device__ void factor() const {
    const int nv = p.nv;
    float* Lb = L();
    for (int i = 0; i < nv; ++i)
      for (int k = 0; k <= i; ++k) LANE(Lb, i * nv + k) = 0.0f;
    float jr[MWT_MAX_NV];
    for (int r = 0; r < nrow; ++r) {
      const float dq = D(r) * quad(r);
      if (dq == 0.0f) continue;
      for (int v = 0; v < nv; ++v) jr[v] = J(r, v);
      for (int i = 0; i < nv; ++i) {
        const float jd = jr[i] * dq;
        if (jd == 0.0f) continue;
        for (int k = 0; k <= i; ++k)
          LANE(Lb, i * nv + k) = LANE(Lb, i * nv + k) + jd * jr[k];
      }
    }
    if constexpr (ELL) {
      for (int r = 0; r < nrow; ++r)
        if (kind(r) == ROW_ELL && off(r) == 0) cone_block(r, Lb);
    }
    for (int i = 0; i < nv; ++i)
      for (int k = 0; k <= i; ++k)
        LANE(Lb, i * nv + k) = LANE(p.M, i * nv + k) + LANE(Lb, i * nv + k);
    chol_lanes(Lb, Lb, nv, W, w);
  }
};

// One body for both forms, inlined into each named kernel, so the
// pyramidal kernel compiles without any of the elliptic form's code.
template <bool E>
__device__ __forceinline__ void solve_world(const SolveParams& p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  const int nv = p.nv;
  const SolveRows<E> R{p, W, w, p.nefc};
  float qacc[MWT_MAX_NV];
  const float niter =
      newton_solve(R, p.M, p.qfs, p.qacc0, qacc, nv, p.iterations,
                   p.ls_iterations, p.tol, p.ls_tol, p.meaninertia, W, w);
  float qfrc[MWT_MAX_NV];
  for (int v = 0; v < nv; ++v) qfrc[v] = 0.0f;
  for (int r = 0; r < p.nefc; ++r) {
    const float f = row_force(R, r);
    LANE(p.force_out, r) = f;
    for (int v = 0; v < nv; ++v) qfrc[v] = qfrc[v] + R.J(r, v) * f;
  }
  for (int v = 0; v < nv; ++v) {
    LANE(p.qacc_out, v) = qacc[v];
    LANE(p.qfrc_out, v) = qfrc[v];
  }
  LANE(p.niter_out, 0) = (int)niter;
}

__global__ void __launch_bounds__(128) solve_kernel(const SolveParams p) {
  solve_world<false>(p);
}

__global__ void __launch_bounds__(128) solve_ell_kernel(const SolveParams p) {
  solve_world<true>(p);
}

extern "C" {

int mwt_solve_params_size() { return (int)sizeof(SolveParams); }

// scratch rows per world; ncon > 0 selects the elliptic form's extra rows
int mwt_solve_scratch_rows(int nefc, int nv, int ncon) {
  return 3 * nefc + nv * nv + (ncon > 0 ? nefc + EC_N * ncon : 0);
}

// Launches the solve on `stream` (the elliptic form when p->s is set);
// returns cudaGetLastError() of the launch.
int mwt_solve_launch(const SolveParams* p, void* stream) {
  const int threads = 128;
  const int blocks = (p->W + threads - 1) / threads;
  if (p->s != nullptr)
    solve_ell_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  else
    solve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
