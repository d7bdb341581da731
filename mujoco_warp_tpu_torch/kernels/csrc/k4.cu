// K4 of the fused step: constraint rows (joint-equality, one-hot joint
// limits, frictionless and pyramidal contacts with exact KBI), the Newton
// solve with Cholesky-factor reuse and the bracketed 3-point linesearch,
// then damped Euler or implicitfast and the quaternion integrate, one
// thread per world.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/fused.py _make_k4
// (:1247, launched by _k4_call :1538) with
// mujoco_warp_tpu/pallas/solver.py solve_core (:269), _chol_tile (:158)
// and _chol_solve_tile (:176).  The Newton solve lives in newton.cuh,
// shared with the standalone solver kernel (solve.cu).
//
// Design.  The Pallas kernel ran every loop at the pace of the slowest
// world of its 128-world tile; here each thread leaves the Newton and the
// linesearch loops when its own world is done.  Done worlds were frozen
// there and factor reuse is exact per world, so each world's iterates are
// the same as the tile's.  Row tables come from the wrapper (kernels/k4.py);
// the rows' Jacobian J (dense rows x nv), D, aref, Jaref, J*search, the
// constraint-state mask and the Cholesky factor live in a lanes-last
// global scratch buffer (thread w owns column w: coalesced), and the
// nv-sized vectors (qacc, Ma, grad, search, M*search) in local arrays.
//
// Bound.  The H = M + J^T D J rebuild dominates: ~nrow * nv^2 / 2 FMAs and
// twice as many scratch loads per world per refactor (108 x 27^2 / 2 at
// the humanoid).  With one thread per world the kernel is latency-bound:
// each thread walks a long chain of dependent scratch accesses, and on an
// H100 spreading 8192 worlds over twice the SMs (64-thread blocks) gained
// only ~11%.  A warp per world, H in shared memory and wgmma for the H
// product are later work.

#include "newton.cuh"

struct K4Params {
  int W, nq, nv, njnt, nlim, neq, ncon, nrow, ncr, iterations, ls_iterations,
      damped, refsafe, has_rows;
  float tol, ls_tol, meaninertia, h, impratio_inv;
  const float* qM;   // (nv*nv, W)
  const float* qLD;  // (nv*nv, W), read only when has_rows == 0
  const float* qfs;  // (nv, W) smooth force
  const float* ws;   // (nv, W) warmstart
  const float* qvel;
  const float* qpos;
  const float* cdof;  // (6 nv, W)
  // compacted contacts, per slot
  const float* c_dist;   // (ncon, W)
  const float* c_pos;    // (3 ncon, W)
  const float* c_frame;  // (9 ncon, W)
  const float* c_im;     // (ncon, W)
  const float* c_fri;    // (5 ncon, W)
  const float* c_solref; // (2 ncon, W)
  const float* c_solimp; // (5 ncon, W)
  const float* c_invw;   // (ncon, W)
  const float* c_mask1;  // (nv ncon, W)
  const float* c_mask2;
  const float* c_com1;  // (3 ncon, W)
  const float* c_com2;
  // outputs
  float* qpos_out;
  float* qvel_out;
  float* warm_out;
  float* qacc_out;
  int* niter_out;
  float* scr;  // (k4_scratch_rows, W)
  // tables
  const int* lim_i;    // (nlim, 2): qposadr, dofadr
  const float* lim_f;  // (nlim, 11): lo, hi, margin, solref 2, solimp 5, invw
  const int* eq_i;     // (neq, 5): qadr1, dadr1, has2, qadr2, dadr2
  const float* eq_f;   // (neq, 15): q01, q02, data 5, solref 2, solimp 5, invw
  const int* con_dim;  // (ncon,)
  const float* damping;  // (nv,)
  const int* jnt_type;
  const int* jnt_qposadr;
  const int* jnt_dofadr;
};

struct K4Scratch {
  int J, D, aref, jaref, jv, quad, sgn, L, rows;
  __device__ __host__ K4Scratch(int nrow, int ncr, int nlim, int nv) {
    J = 0;
    D = J + ncr * nv;
    aref = D + nrow;
    jaref = aref + nrow;
    jv = jaref + nrow;
    quad = jv + nrow;
    sgn = quad + nrow;
    L = sgn + nlim;
    rows = L + nv * nv;
  }
};

#define MINIMP 0.0001f
#define MAXIMP 0.9999f

// stiffness, damping and impedance of a row (fused.py _kbi_lane)
__device__ void kbi(float tc, float dr, const float* si, float pos, float h,
                    bool refsafe, float* k, float* b, float* imp) {
  float dmin = clampf(si[0], MINIMP, MAXIMP);
  float dmax = clampf(si[1], MINIMP, MAXIMP);
  float width = fmaxf(si[2], MWT_MINVAL);
  float mid = clampf(si[3], MINIMP, MAXIMP);
  float power = fmaxf(si[4], 1.0f);
  float tce = refsafe ? fmaxf(tc, 2.0f * h) : tc;
  float dmax_sq = dmax * dmax;
  float kk = 1.0f / fmaxf(dmax_sq * tce * tce * dr * dr, MWT_MINVAL);
  float bb = 2.0f / fmaxf(dmax * tce, MWT_MINVAL);
  if (tc <= 0.0f) kk = -tc / dmax_sq;
  if (dr <= 0.0f) bb = -dr / dmax;
  float x = fabsf(pos) / width;
  float ia = (1.0f / powf(mid, power - 1.0f)) * powf(x, power);
  float ib = 1.0f - (1.0f / powf(1.0f - mid, power - 1.0f)) *
                        powf(1.0f - x, power);
  float im = dmin + (x < mid ? ia : ib) * (dmax - dmin);
  im = fminf(fmaxf(im, dmin), dmax);
  if (x > 1.0f) im = dmax;
  *k = kk;
  *b = bb;
  *imp = im;
}

// K4's rows for the shared Newton (newton.cuh): one-hot limit rows first,
// then dense joint-equality and contact rows, all in scratch
struct Rows {
  static constexpr bool ELL = false;  // pyramidal and frictionless only
  const K4Params& p;
  const K4Scratch& s;
  int W, w, nrow;

  __device__ float J(int r, int v) const {
    return p.scr[(size_t)(s.J + r * p.nv + v) * W + w];
  }
  __device__ float& at(int base, int r) const {
    return p.scr[(size_t)(base + r) * W + w];
  }
  __device__ bool is_eq(int r) const {
    return r >= p.nlim && r < p.nlim + p.neq;
  }
  __device__ int kind(int r) const { return is_eq(r) ? ROW_EQ : ROW_INEQ; }
  __device__ float D(int r) const { return at(s.D, r); }
  __device__ float aref(int r) const { return at(s.aref, r); }
  __device__ float fl(int r) const { return 0.0f; }
  __device__ float& jaref(int r) const { return at(s.jaref, r); }
  __device__ float& jv(int r) const { return at(s.jv, r); }
  __device__ float& quad(int r) const { return at(s.quad, r); }
  __device__ float* L() const { return p.scr + (size_t)s.L * W; }
  // J v for every row into scratch row block `out`.  Inactive contact
  // rows (D == 0) are zero rows: their product is an exact zero.
  __device__ void jvec(const float* v, int out) const {
    for (int l = 0; l < p.nlim; ++l)
      at(out, l) = at(s.sgn, l) * v[p.lim_i[2 * l + 1]];
    for (int r = 0; r < p.ncr; ++r) {
      float acc = 0.0f;
      if (at(s.D, p.nlim + r) != 0.0f)
        for (int k = 0; k < p.nv; ++k) acc = acc + J(r, k) * v[k];
      at(out, p.nlim + r) = acc;
    }
  }
  __device__ void jvec_jaref(const float* v) const { jvec(v, s.jaref); }
  __device__ void jvec_jv(const float* v) const { jvec(v, s.jv); }
  // J^T f with f the current row forces; rows with zero force add exact
  // zeros and are skipped (J is read row by row, once)
  __device__ void jtforce(float* out) const {
    for (int v = 0; v < p.nv; ++v) out[v] = 0.0f;
    for (int r = 0; r < p.ncr; ++r) {
      const float f = row_force(*this, p.nlim + r);
      if (f == 0.0f) continue;
      for (int v = 0; v < p.nv; ++v) out[v] = out[v] + J(r, v) * f;
    }
    for (int v = 0; v < p.nv; ++v) {
      float corr = 0.0f;
      bool any = false;
      for (int l = 0; l < p.nlim; ++l) {
        if (p.lim_i[2 * l + 1] != v) continue;
        float t = at(s.sgn, l) * row_force(*this, l);
        corr = any ? corr + t : t;
        any = true;
      }
      if (any) out[v] = out[v] + corr;
    }
  }
  // H = M + J^T diag(D quad) J on the lower triangle, factored in place.
  // J is read row by row, once; rows with D quad == 0 and zero entries
  // add exact zeros and are skipped.
  __device__ void factor() const {
    const int nv = p.nv;
    float* Lb = p.scr + (size_t)s.L * W;
    for (int i = 0; i < nv; ++i)
      for (int k = 0; k <= i; ++k) LANE(Lb, i * nv + k) = 0.0f;
    float jr[MWT_MAX_NV];
    for (int r = 0; r < p.ncr; ++r) {
      const int g = p.nlim + r;
      const float dq = at(s.D, g) * at(s.quad, g);
      if (dq == 0.0f) continue;
      for (int v = 0; v < nv; ++v) jr[v] = J(r, v);
      for (int i = 0; i < nv; ++i) {
        const float jd = jr[i] * dq;
        if (jd == 0.0f) continue;
        for (int k = 0; k <= i; ++k)
          LANE(Lb, i * nv + k) = LANE(Lb, i * nv + k) + jd * jr[k];
      }
    }
    for (int i = 0; i < nv; ++i) {
      float add = 0.0f;
      bool any = false;
      for (int l = 0; l < p.nlim; ++l) {
        if (p.lim_i[2 * l + 1] != i) continue;
        float sg = at(s.sgn, l);
        float t = sg * sg * (at(s.D, l) * at(s.quad, l));
        add = any ? add + t : t;
        any = true;
      }
      for (int k = 0; k <= i; ++k) {
        float acc = LANE(Lb, i * nv + k);
        if (i == k && any) acc = acc + add;
        LANE(Lb, i * nv + k) = LANE(p.qM, i * nv + k) + acc;
      }
    }
    chol_lanes(Lb, Lb, nv, W, w);
  }
};

__global__ void __launch_bounds__(128) k4_kernel(const K4Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  const int nv = p.nv;
  const K4Scratch s(p.nrow, p.ncr, p.nlim, nv);
  const Rows R{p, s, W, w, p.nrow};
  const float h = p.h;
  const bool refsafe = p.refsafe != 0;

  float qacc[MWT_MAX_NV];
  float niter = 0.0f;

  if (p.has_rows) {
    // ---- joint-limit rows: one-hot, dof ± 1 when active
    for (int l = 0; l < p.nlim; ++l) {
      const float* F = p.lim_f + 11 * l;
      const float q = LANE(p.qpos, p.lim_i[2 * l]);
      const float dmin_ = q - F[0], dmax_ = F[1] - q;
      const float pos = fminf(dmin_, dmax_) - F[2];
      const float active = pos < 0.0f ? 1.0f : 0.0f;
      const float sign = dmin_ < dmax_ ? 1.0f : -1.0f;
      const float vel = sign * LANE(p.qvel, p.lim_i[2 * l + 1]);
      float k, b, imp;
      kbi(F[3], F[4], F + 5, pos, h, refsafe, &k, &b, &imp);
      const float D = 1.0f / fmaxf(F[10] * (1.0f - imp) / imp, MWT_MINVAL);
      R.at(s.D, l) = D * active;
      R.at(s.aref, l) = (-k * imp * pos - b * vel) * active;
      R.at(s.sgn, l) = sign * active;
    }
    // ---- joint-equality rows: J = e_dof1 - poly'(q2) e_dof2
    for (int e = 0; e < p.neq; ++e) {
      const int* I = p.eq_i + 5 * e;
      const float* F = p.eq_f + 15 * e;
      const float* dd = F + 2;
      const float q1 = LANE(p.qpos, I[0]);
      float pos, vel, deriv2 = 0.0f;
      if (I[2]) {
        const float dif = LANE(p.qpos, I[3]) - F[1];
        const float rhs =
            dd[0] + dif * (dd[1] + dif * (dd[2] + dif * (dd[3] + dif * dd[4])));
        deriv2 = dd[1] + dif * (2.0f * dd[2] +
                                dif * (3.0f * dd[3] + dif * 4.0f * dd[4]));
        pos = q1 - F[0] - rhs;
        vel = LANE(p.qvel, I[1]) - deriv2 * LANE(p.qvel, I[4]);
      } else {
        pos = q1 - F[0] - dd[0];
        vel = LANE(p.qvel, I[1]);
      }
      for (int v = 0; v < nv; ++v) {
        float j = (v == I[1] ? 1.0f : 0.0f);
        if (I[2] && v == I[4]) j = j + (-deriv2);
        R.at(s.J, e * nv + v) = j;
      }
      float k, b, imp;
      kbi(F[7], F[8], F + 9, pos, h, refsafe, &k, &b, &imp);
      R.at(s.D, p.nlim + e) =
          1.0f / fmaxf(F[14] * (1.0f - imp) / imp, MWT_MINVAL);
      R.at(s.aref, p.nlim + e) = -k * imp * pos - b * vel;
    }
    // ---- contact rows, per compact slot
    int row = p.neq;  // dense row index
    for (int c = 0; c < p.ncon; ++c) {
      const int dim = p.con_dim[c];
      const float d = LANE(p.c_dist, c), im = LANE(p.c_im, c);
      const float active = d < im ? 1.0f : 0.0f;
      const float cp = d - im;
      float fr[9], ps[3], o1[3], o2[3];
      for (int k = 0; k < 9; ++k) fr[k] = LANE(p.c_frame, 9 * c + k);
      for (int k = 0; k < 3; ++k) {
        ps[k] = LANE(p.c_pos, 3 * c + k);
        o1[k] = ps[k] - LANE(p.c_com1, 3 * c + k);
        o2[k] = ps[k] - LANE(p.c_com2, 3 * c + k);
      }
      // directions: n, then [t1, t2, rot n, rot t1, rot t2][:dim-1]
      const int ndir = dim == 1 ? 0 : dim - 1;
      float u1[3][3], u2[3][3];  // o x t for the three frame axes
      for (int a = 0; a < 3; ++a) {
        cross3(o1, fr + 3 * a, u1[a]);
        cross3(o2, fr + 3 * a, u2[a]);
      }
      float fric[5];
      for (int k = 0; k < ndir; ++k) fric[k] = LANE(p.c_fri, 5 * c + k);
      float veln = 0.0f, veld[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int v = 0; v < nv; ++v) {
        const float m1 = LANE(p.c_mask1, c * nv + v);
        const float m2 = LANE(p.c_mask2, c * nv + v);
        const float dm = m2 - m1;
        float ang[3], lin[3];
        for (int k = 0; k < 3; ++k) {
          ang[k] = LANE(p.cdof, 6 * v + k);
          lin[k] = LANE(p.cdof, 6 * v + 3 + k);
        }
        float Jax[3];  // translational rows along n, t1, t2
        for (int a = 0; a < 3; ++a) {
          const float* t = fr + 3 * a;
          const float lt = lin[0] * t[0] + lin[1] * t[1] + lin[2] * t[2];
          const float au1 = ang[0] * u1[a][0] + ang[1] * u1[a][1] + ang[2] * u1[a][2];
          const float au2 = ang[0] * u2[a][0] + ang[1] * u2[a][1] + ang[2] * u2[a][2];
          Jax[a] = dm * lt + m2 * au2 - m1 * au1;
        }
        const float qv = LANE(p.qvel, v);
        const float Jn = Jax[0];
        veln = v == 0 ? Jn * qv : veln + Jn * qv;
        if (dim == 1) {
          R.at(s.J, row * nv + v) = Jn * active;
          continue;
        }
        for (int k = 0; k < ndir; ++k) {
          float Jd;
          if (k < 2) {
            Jd = Jax[1 + k];
          } else {
            const float* t = fr + 3 * (k - 2);
            Jd = dm * (ang[0] * t[0] + ang[1] * t[1] + ang[2] * t[2]);
          }
          veld[k] = v == 0 ? Jd * qv : veld[k] + Jd * qv;
          R.at(s.J, (row + 2 * k) * nv + v) = (Jn + fric[k] * Jd) * active;
          R.at(s.J, (row + 2 * k + 1) * nv + v) = (Jn - fric[k] * Jd) * active;
        }
      }
      float iw;
      if (dim == 1) {
        iw = LANE(p.c_invw, c);
      } else {
        const float f0 = LANE(p.c_fri, 5 * c), iw0 = LANE(p.c_invw, c);
        iw = (iw0 + f0 * f0 * iw0) * 2.0f * f0 * f0 * p.impratio_inv;
      }
      float sr[2] = {LANE(p.c_solref, 2 * c), LANE(p.c_solref, 2 * c + 1)};
      float si[5];
      for (int k = 0; k < 5; ++k) si[k] = LANE(p.c_solimp, 5 * c + k);
      float k, b, imp;
      kbi(sr[0], sr[1], si, cp, h, refsafe, &k, &b, &imp);
      const float D = active / fmaxf(iw * (1.0f - imp) / imp, MWT_MINVAL);
      const float kic = -k * imp * cp;
      const int g0 = p.nlim + row;
      if (dim == 1) {
        R.at(s.D, g0) = D;
        R.at(s.aref, g0) = (kic - b * veln) * active;
        row += 1;
      } else {
        for (int kd = 0; kd < ndir; ++kd) {
          R.at(s.D, g0 + 2 * kd) = D;
          R.at(s.D, g0 + 2 * kd + 1) = D;
          R.at(s.aref, g0 + 2 * kd) =
              (kic - b * (veln + fric[kd] * veld[kd])) * active;
          R.at(s.aref, g0 + 2 * kd + 1) =
              (kic - b * (veln - fric[kd] * veld[kd])) * active;
        }
        row += 2 * ndir;
      }
    }

    // ---- Newton solve (newton.cuh, pallas/solver.py solve_core)
    niter = newton_solve(R, p.qM, p.qfs, p.ws, qacc, nv, p.iterations,
                         p.ls_iterations, p.tol, p.ls_tol, p.meaninertia,
                         W, w);
  } else {
    float b[MWT_MAX_NV];
    for (int i = 0; i < nv; ++i) b[i] = LANE(p.qfs, i);
    chol_solve_lanes(p.qLD, b, qacc, nv, W, w);
  }

  // ---- integrate: damped Euler / implicitfast, then positions
  float qacc_i[MWT_MAX_NV];
  if (p.damped) {
    float* Ld = p.scr + (size_t)s.L * W;
    for (int i = 0; i < nv; ++i)
      for (int k = 0; k <= i; ++k)
        LANE(Ld, i * nv + k) =
            LANE(p.qM, i * nv + k) + (i == k ? h * p.damping[i] : 0.0f);
    chol_lanes(Ld, Ld, nv, W, w);
    float rhs[MWT_MAX_NV];
    for (int i = 0; i < nv; ++i) {
      float acc = 0.0f;
      for (int k = 0; k < nv; ++k) acc = acc + LANE(p.qM, i * nv + k) * qacc[k];
      rhs[i] = acc;
    }
    chol_solve_lanes(Ld, rhs, qacc_i, nv, W, w);
  } else {
    for (int i = 0; i < nv; ++i) qacc_i[i] = qacc[i];
  }
  for (int i = 0; i < nv; ++i) {
    const float vn = LANE(p.qvel, i) + h * qacc_i[i];
    LANE(p.qvel_out, i) = vn;
    LANE(p.warm_out, i) = qacc[i];
    LANE(p.qacc_out, i) = qacc_i[i];
  }
  for (int j = 0; j < p.njnt; ++j) {
    const int qa = p.jnt_qposadr[j], da = p.jnt_dofadr[j];
    if (p.jnt_type[j] == 0) {  // FREE
      for (int a = 0; a < 3; ++a)
        LANE(p.qpos_out, qa + a) =
            LANE(p.qpos, qa + a) + h * LANE(p.qvel_out, da + a);
      float q[4], wv[3];
      for (int a = 0; a < 4; ++a) q[a] = LANE(p.qpos, qa + 3 + a);
      qnormalize(q);
      for (int a = 0; a < 3; ++a) wv[a] = LANE(p.qvel_out, da + 3 + a);
      // mju_quatIntegrate: rotate by w h in the local frame
      const float angle = sqrtf(fmaxf(wv[0] * wv[0] + wv[1] * wv[1] + wv[2] * wv[2], 0.0f));
      float qrot[4] = {1.0f, 0.0f, 0.0f, 0.0f};
      if (angle > 1e-9f) {
        const float den = fmaxf(angle, 1e-9f);
        const float half = 0.5f * angle * h;
        const float sn = sinf(half);
        qrot[0] = cosf(half);
        for (int a = 0; a < 3; ++a) qrot[1 + a] = (wv[a] / den) * sn;
      }
      qmul(q, qrot, q);
      qnormalize(q);
      for (int a = 0; a < 4; ++a) LANE(p.qpos_out, qa + 3 + a) = q[a];
    } else {
      LANE(p.qpos_out, qa) = LANE(p.qpos, qa) + h * LANE(p.qvel_out, da);
    }
  }
  LANE(p.niter_out, 0) = (int)niter;
}

extern "C" {

int mwt_k4_params_size() { return (int)sizeof(K4Params); }

int mwt_k4_scratch_rows(int nrow, int ncr, int nlim, int nv) {
  return K4Scratch(nrow, ncr, nlim, nv).rows;
}

// Launches K4 on `stream`; returns cudaGetLastError() of the launch.
int mwt_k4_launch(const K4Params* p, void* stream) {
  const int threads = 128;
  const int blocks = (p->W + threads - 1) / threads;
  k4_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
