// K4 of the fused step: constraint rows (one-hot joint limits, joint
// equality, frictionless and pyramidal contacts with exact KBI), the
// Newton solve with Cholesky-factor reuse and the bracketed 3-point
// linesearch, then damped Euler or implicitfast and the quaternion
// integrate, one warp per world.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/fused.py _make_k4
// (:1247, launched by _k4_call :1538) with _kbi_lane (:1141),
// _quat_integrate_lane (:1491) and mujoco_warp_tpu/pallas/solver.py
// solve_core (:269), _chol_tile (:158) and _chol_solve_tile (:176).
//
// Bound.  Per world it reads qM (nv^2), qfs, the warmstart, qvel, qpos,
// cdof (6 nv) and the live contact slots (33 floats and two nv-long body
// masks each), and writes qpos, qvel, the warmstart, qacc and niter: at
// the humanoid (nv 27, 36 slots, nrow 129) at most 17 KB per world, 139 MB
// at 8192 worlds (41 us at 3.35 TB/s).  Its float operations, some 0.2
// million per world at three Newton iterations (chip_smoke.py
// newton_flops), take less.  What bounds it is each world's dependent
// chain of row build, Newton and linesearch steps and factors.
//
// Design.  Each world gets one warp and the solve kernel's shared layout
// (solve_rows.cuh SolveLayout, no elliptic contacts) with qpos and qvel beside
// it: 24.4 KB at the humanoid, 4 worlds per block and 8 per SM (warp.cuh
// occupancy_worlds, balanced over the SM's four schedulers: at 3 per block
// and 9 per SM one scheduler idles, and K4 ran 8% longer on an H100,
// kerneltime.py).  The block copies qM, the warmstart, qfs, qvel, qpos and
// cdof (lanes-last) into shared memory with cp.async, the world as the fastest
// thread index; cdof sits in the L region, which the Newton first writes after
// the rows are built.  The lanes build the rows into J, D and aref: one lane
// per limit row (a dense one-hot J row, so that the solve kernel's row set
// serves K4 unchanged), per equality row and per contact slot, in the row order
// limits, equality, contacts by slot (a slot's first row from a per-model
// table).  A contact lane walks its slot's dofs in order, so that its normal
// and tangent velocities sum in dof order; a dead slot (dist >= includemargin)
// is read no further: its rows get D = 0 and aref = 0, and the row lists skip
// them.  Then the Newton of the solve kernel (newton_warp.cuh newton_solve_warp
// over SolveRows<false>, row kinds from a per-model table), and the integrator
// in the warp: M + h diag(damping) into L's lower triangle, chol_warp, M qacc
// by in-order dots and chol_subst; without rows, qLD (from K1) into L and one
// substitution.  qpos takes one lane per joint.  A block barrier ends the loads
// and begins the stores (lanes-last, the world as the fastest thread index),
// and every thread reaches both.

#include "solve_rows.cuh"

struct K4Params {
  int W, nq, nv, njnt, nlim, neq, ncon, nrow, iterations, ls_iterations,
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
  // tables
  const int* lim_i;    // (nlim, 2): qposadr, dofadr
  const float* lim_f;  // (nlim, 11): lo, hi, margin, solref 2, solimp 5, invw
  const int* eq_i;     // (neq, 5): qadr1, dadr1, has2, qadr2, dadr2
  const float* eq_f;   // (neq, 15): q01, q02, data 5, solref 2, solimp 5, invw
  const int* con_dim;  // (ncon,)
  const int* con_row;  // (ncon,) the slot's first row
  const int* kind;     // (nrow,) ROW_INEQ, or ROW_EQ for equality rows
  const float* damping;  // (nv,)
  const int* jnt_type;
  const int* jnt_qposadr;
  const int* jnt_dofadr;
};

// One world's shared floats: the solve kernel's layout of nrow rows, then
// qpos and qvel; cdof in the L region where it fits, else after them.
struct K4Layout {
  SolveLayout s;
  int qpos, qvel, cdof, total;
  __host__ __device__ K4Layout(int nrow, int nv, int nq) : s(nrow, nv, 0) {
    qpos = s.total;
    qvel = qpos + nq;
    total = qvel + nv;
    cdof = s.L;
    if (6 * nv > nv * s.ld) {
      cdof = total;
      total += 6 * nv;
    }
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

// The rows of world w into J, D, aref (and fl = 0) of the world's floats
// b, by the warp's lanes; qpos, qvel and cdof are in b.
__device__ __forceinline__ void k4_rows(const K4Params& p, const K4Layout& l,
                                        float* b, int w, int lane) {
  MWT_SHARED(b);
  const int W = p.W, nv = p.nv, ld = l.s.ld;
  const float h = p.h;
  const bool refsafe = p.refsafe != 0;
  float* Jm = b + l.s.J;
  float* Dv = b + l.s.D;
  float* ar = b + l.s.aref;
  const float* qpos = b + l.qpos;
  const float* qvel = b + l.qvel;
  const float* cdof = b + l.cdof;
  for (int r = lane; r < p.nrow; r += 32) b[l.s.fl + r] = 0.0f;
  // ---- joint-limit rows: one-hot, dof +- 1 when active
  for (int i = lane; i < p.nlim; i += 32) {
    const float* F = p.lim_f + 11 * i;
    const int dof = p.lim_i[2 * i + 1];
    const float q = qpos[p.lim_i[2 * i]];
    const float dmin_ = q - F[0], dmax_ = F[1] - q;
    const float pos = fminf(dmin_, dmax_) - F[2];
    const float active = pos < 0.0f ? 1.0f : 0.0f;
    const float sign = dmin_ < dmax_ ? 1.0f : -1.0f;
    const float vel = sign * qvel[dof];
    float k, bb, imp;
    kbi(F[3], F[4], F + 5, pos, h, refsafe, &k, &bb, &imp);
    const float D = 1.0f / fmaxf(F[10] * (1.0f - imp) / imp, MWT_MINVAL);
    const float sg = sign * active;
    for (int v = 0; v < nv; ++v) Jm[i * ld + v] = v == dof ? sg : 0.0f;
    Dv[i] = D * active;
    ar[i] = (-k * imp * pos - bb * vel) * active;
  }
  // ---- joint-equality rows: J = e_dof1 - poly'(q2) e_dof2
  for (int e = lane; e < p.neq; e += 32) {
    const int* I = p.eq_i + 5 * e;
    const float* F = p.eq_f + 15 * e;
    const float* dd = F + 2;
    const int r = p.nlim + e;
    const float q1 = qpos[I[0]];
    float pos, vel, deriv2 = 0.0f;
    if (I[2]) {
      const float dif = qpos[I[3]] - F[1];
      const float rhs =
          dd[0] + dif * (dd[1] + dif * (dd[2] + dif * (dd[3] + dif * dd[4])));
      deriv2 = dd[1] + dif * (2.0f * dd[2] +
                              dif * (3.0f * dd[3] + dif * 4.0f * dd[4]));
      pos = q1 - F[0] - rhs;
      vel = qvel[I[1]] - deriv2 * qvel[I[4]];
    } else {
      pos = q1 - F[0] - dd[0];
      vel = qvel[I[1]];
    }
    for (int v = 0; v < nv; ++v) {
      float j = (v == I[1] ? 1.0f : 0.0f);
      if (I[2] && v == I[4]) j = j + (-deriv2);
      Jm[r * ld + v] = j;
    }
    float k, bb, imp;
    kbi(F[7], F[8], F + 9, pos, h, refsafe, &k, &bb, &imp);
    Dv[r] = 1.0f / fmaxf(F[14] * (1.0f - imp) / imp, MWT_MINVAL);
    ar[r] = -k * imp * pos - bb * vel;
  }
  // ---- contact rows, one lane per compact slot; n, then [t1, t2, rot n,
  // rot t1, rot t2][:dim-1] as pyramid pairs
  for (int c = lane; c < p.ncon; c += 32) {
    const int dim = p.con_dim[c], g0 = p.con_row[c];
    const int ndir = dim == 1 ? 0 : dim - 1;
    const float d = LANE(p.c_dist, c), im = LANE(p.c_im, c);
    if (!(d < im)) {  // dead: empty rows, the slot is not read again
      for (int r = g0; r < g0 + (dim == 1 ? 1 : 2 * ndir); ++r)
        Dv[r] = ar[r] = 0.0f;
      continue;
    }
    const float cp = d - im;
    float fr[9], ps[3], o1[3], o2[3];
    for (int k = 0; k < 9; ++k) fr[k] = LANE(p.c_frame, 9 * c + k);
    for (int k = 0; k < 3; ++k) {
      ps[k] = LANE(p.c_pos, 3 * c + k);
      o1[k] = ps[k] - LANE(p.c_com1, 3 * c + k);
      o2[k] = ps[k] - LANE(p.c_com2, 3 * c + k);
    }
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
      const float* ang = cdof + 6 * v;
      const float* lin = ang + 3;
      float Jax[3];  // translational rows along n, t1, t2
      for (int a = 0; a < 3; ++a) {
        const float* t = fr + 3 * a;
        const float lt = lin[0] * t[0] + lin[1] * t[1] + lin[2] * t[2];
        const float au1 =
            ang[0] * u1[a][0] + ang[1] * u1[a][1] + ang[2] * u1[a][2];
        const float au2 =
            ang[0] * u2[a][0] + ang[1] * u2[a][1] + ang[2] * u2[a][2];
        Jax[a] = dm * lt + m2 * au2 - m1 * au1;
      }
      const float qv = qvel[v];
      const float Jn = Jax[0];
      veln = v == 0 ? Jn * qv : veln + Jn * qv;
      if (dim == 1) {
        Jm[g0 * ld + v] = Jn;
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
        Jm[(g0 + 2 * k) * ld + v] = Jn + fric[k] * Jd;
        Jm[(g0 + 2 * k + 1) * ld + v] = Jn - fric[k] * Jd;
      }
    }
    float iw;
    if (dim == 1) {
      iw = LANE(p.c_invw, c);
    } else {
      const float f0 = LANE(p.c_fri, 5 * c), iw0 = LANE(p.c_invw, c);
      iw = (iw0 + f0 * f0 * iw0) * 2.0f * f0 * f0 * p.impratio_inv;
    }
    float si[5];
    for (int k = 0; k < 5; ++k) si[k] = LANE(p.c_solimp, 5 * c + k);
    float k, bb, imp;
    kbi(LANE(p.c_solref, 2 * c), LANE(p.c_solref, 2 * c + 1), si, cp, h,
        refsafe, &k, &bb, &imp);
    const float D = 1.0f / fmaxf(iw * (1.0f - imp) / imp, MWT_MINVAL);
    const float kic = -k * imp * cp;
    if (dim == 1) {
      Dv[g0] = D;
      ar[g0] = kic - bb * veln;
    } else {
      for (int kd = 0; kd < ndir; ++kd) {
        Dv[g0 + 2 * kd] = D;
        Dv[g0 + 2 * kd + 1] = D;
        ar[g0 + 2 * kd] = kic - bb * (veln + fric[kd] * veld[kd]);
        ar[g0 + 2 * kd + 1] = kic - bb * (veln - fric[kd] * veld[kd]);
      }
    }
  }
  __syncwarp();
}

// The integrator of one world in its floats b, by the warp: qacc_i into
// x.grad, qvel and qpos advanced in place.
__device__ __forceinline__ void k4_integrate(const K4Params& p,
                                             const K4Layout& l, float* b,
                                             const WarpVecs& x, int lane) {
  MWT_SHARED(b);
  const int nv = p.nv, ld = l.s.ld;
  const float h = p.h;
  const float* M = b + l.s.M;
  float* L = b + l.s.L;
  float* qi = x.grad;
  float* qpos = b + l.qpos;
  float* qvel = b + l.qvel;
  if (p.damped) {  // (M + h diag(damping))^-1 M qacc
    for (int f = lane; f < nv * nv; f += 32) {
      const int i = f / nv, k = f - i * nv;
      if (k <= i)
        L[i * ld + k] = M[i * ld + k] + (i == k ? h * p.damping[i] : 0.0f);
    }
    chol_warp<MWT_MAX_NV>(L, nv, AtStrided{ld}, lane);
    matvec_warp(M, ld, x.qacc, qi, nv, lane);
    chol_subst<MWT_MAX_NV>(L, qi, nv, ld, lane);
  } else {
    for (int i = lane; i < nv; i += 32) qi[i] = x.qacc[i];
    __syncwarp();
  }
  for (int i = lane; i < nv; i += 32) qvel[i] = qvel[i] + h * qi[i];
  __syncwarp();
  for (int j = lane; j < p.njnt; j += 32) {
    const int qa = p.jnt_qposadr[j], da = p.jnt_dofadr[j];
    if (p.jnt_type[j] == 0) {  // FREE
      for (int a = 0; a < 3; ++a)
        qpos[qa + a] = qpos[qa + a] + h * qvel[da + a];
      float q[4], wv[3];
      for (int a = 0; a < 4; ++a) q[a] = qpos[qa + 3 + a];
      qnormalize(q);
      for (int a = 0; a < 3; ++a) wv[a] = qvel[da + 3 + a];
      // mju_quatIntegrate: rotate by w h in the local frame
      const float angle =
          sqrtf(fmaxf(wv[0] * wv[0] + wv[1] * wv[1] + wv[2] * wv[2], 0.0f));
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
      for (int a = 0; a < 4; ++a) qpos[qa + 3 + a] = q[a];
    } else {
      qpos[qa] = qpos[qa] + h * qvel[da];
    }
  }
}

__global__ void k4_kernel(const K4Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.W, nv = p.nv, nq = p.nq;
  const K4Layout lay(p.nrow, nv, nq);
  const int wf = lay.total, ld = lay.s.ld;
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), W - w0);
  // each input lanes-last: world stride 1, element stride W
  load_block(p.qM, 1, W, w0, nw, nv * nv, nv, false, AtStrided{ld},
             smem + lay.s.M, wf);
  load_block(p.ws, 1, W, w0, nw, nv, nv, false, AtVector{},
             smem + lay.s.vec, wf);
  load_block(p.qfs, 1, W, w0, nw, nv, nv, false, AtVector{},
             smem + lay.s.vec + 5 * nv, wf);
  load_block(p.qvel, 1, W, w0, nw, nv, nv, false, AtVector{},
             smem + lay.qvel, wf);
  load_block(p.qpos, 1, W, w0, nw, nq, nq, false, AtVector{},
             smem + lay.qpos, wf);
  if (p.has_rows)
    load_block(p.cdof, 1, W, w0, nw, 6 * nv, 6 * nv, false, AtVector{},
               smem + lay.cdof, wf);
  else
    load_block(p.qLD, 1, W, w0, nw, nv * nv, nv, true, AtStrided{ld},
               smem + lay.s.L, wf);
  copies_done();
  if (warp < nw) {
    float* b = smem + warp * wf;
    float* v = b + lay.s.vec;
    const WarpVecs x{v, v + nv, v + 2 * nv, v + 3 * nv, v + 4 * nv,
                     v + 5 * nv};
    float niter = 0.0f;
    if (p.has_rows) {
      k4_rows(p, lay, b, w0 + warp, lane);
      SolveRows<false> R(p.kind, nullptr, p.nrow, nv, 0, lay.s, b, lane);
      R.init();
      niter = newton_solve_warp<MWT_MAX_NV>(
          R, R.M, x, nv, p.iterations, p.ls_iterations, p.tol, p.ls_tol,
          p.meaninertia, lane);
    } else {  // qacc = qLD^-1 qfs
      for (int i = lane; i < nv; i += 32) x.qacc[i] = x.qfs[i];
      chol_subst<MWT_MAX_NV>(b + lay.s.L, x.qacc, nv, ld, lane);
    }
    k4_integrate(p, lay, b, x, lane);
    if (lane == 0) v[6 * nv] = niter;
  }
  __syncthreads();
  // qpos, qvel, warmstart, qacc and niter, lanes-last, the world as the
  // fastest thread index
  float* outs[4] = {p.qpos_out, p.qvel_out, p.warm_out, p.qacc_out};
  const int out_at[4] = {lay.qpos, lay.qvel, lay.s.vec, lay.s.vec + 2 * nv};
  const int out_rows[4] = {nq, nv, nv, nv};
  for (int k = 0; k < 4; ++k)
    for (int f = threadIdx.x; f < out_rows[k] * nw; f += blockDim.x) {
      const int r = f / nw, l = f - r * nw;
      outs[k][(size_t)r * W + w0 + l] = smem[l * wf + out_at[k] + r];
    }
  for (int l = threadIdx.x; l < nw; l += blockDim.x)
    p.niter_out[w0 + l] = (int)smem[l * wf + lay.s.vec + 6 * nv];
}

// shared bytes per world and worlds per block for p's sizes: the count
// that keeps all four schedulers of an SM busy
static void k4_config(const K4Params* p, size_t* per_world, int* wpb) {
  *per_world = (size_t)K4Layout(p->nrow, p->nv, p->nq).total * sizeof(float);
  *wpb = occupancy_worlds(*per_world, true);
}

extern "C" {

int mwt_k4_params_size() { return (int)sizeof(K4Params); }

// shared floats of one world
int mwt_k4_world_floats(int nrow, int nv, int nq) {
  return K4Layout(nrow, nv, nq).total;
}

// Launches K4 on `stream`; returns cudaGetLastError() of the launch.
int mwt_k4_launch(const K4Params* p, void* stream) {
  size_t per_world;
  int wpb;
  k4_config(p, &per_world, &wpb);
  return launch_worlds(k4_kernel, p, p->W, wpb, per_world, stream);
}

// the kernel's registers per thread, worlds per block and shared bytes per
// block for p's sizes, into out[0..2]
int mwt_k4_info(const K4Params* p, int* out) {
  size_t per_world;
  int wpb;
  k4_config(p, &per_world, &wpb);
  return kernel_info(k4_kernel, wpb, per_world, out);
}

}  // extern "C"
