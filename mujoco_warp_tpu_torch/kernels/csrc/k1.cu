// K1 of the fused step: forward kinematics -> com quantities -> geom
// frames -> lane narrowphase -> mass chain (crb, qM + armature, optional
// Cholesky, com_vel, cdof_dot, RNE bias), one thread per world.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/fused.py _make_k1
// (:986, launched by _k1_call :1075) together with
// mujoco_warp_tpu/pallas/smooth.py mass_chain_core (:43), which lives in
// mass_chain.cuh, shared with the standalone mass-chain kernel.
//
// Design.  Pallas unrolled the model at trace time and folded its
// constants; here the kernel walks device tables the wrapper uploads once
// per model (kernels/k1.py), so one binary serves every model inside the
// fused gate (nv <= 64, nbody <= 32, ncand <= 512).  All threads of a warp
// walk the same body, joint, pair group and pair at the same time, so the
// collider switch never diverges.  Per-world intermediates (body frames,
// cinert, crb, velocities) live in a lanes-last global scratch buffer:
// thread w owns column w, so every access is coalesced across the warp.
//
// Bound.  Per world the kernel does O(nbody * 36 + ncand * 50 + nv^2 * 6)
// flops and moves ~(2 nv^2 + 60 nbody + 13 ncand) * 4 bytes; at the
// humanoid (nv 27, nbody 17, ncand 177) that is ~17 KB per world, far
// below what would bound it at 8192 worlds; with one thread per world the
// kernel is latency-bound by each thread's chain of dependent scratch
// accesses.  Keeping the scratch in shared memory or registers is later
// work.

#include "mass_chain.cuh"

struct K1Params {
  int W, nq, nv, nbody, njnt, ngeom, ngroup, need_qld, run_col, no_gravity;
  // state
  const float* qpos;  // (nq, W)
  const float* qvel;  // (nv, W)
  // outputs
  float* qM;      // (nv*nv, W)
  float* qLD;     // (nv*nv, W) or null
  float* bias;    // (nv, W)
  float* cdof;    // (6 nv, W)
  float* dist;    // (ncand, W)
  float* cpos;    // (3 ncand, W)
  float* cframe;  // (9 ncand, W)
  float* stcom;   // (3 nbody, W)
  float* scr;     // (k1_scratch_rows, W)
  // bodies
  const int* topo;         // (nbody-1,) bodies by tree depth
  const int* body_parent;  // (nbody,)
  const int* body_jntadr;
  const int* body_jntnum;
  const int* body_rootid;
  const int* body_dofadr;  // first dof of the body
  const int* body_dofnum;
  const int* subtree;        // (nbody, nbody) 0/1, j in subtree(i)
  const float* body_pos;     // (nbody, 3)
  const float* body_quat;    // (nbody, 4)
  const float* body_ipos;    // (nbody, 3)
  const float* body_iquat;   // (nbody, 4)
  const float* body_mass;    // (nbody,)
  const float* body_inertia; // (nbody, 3)
  const float* body_inv_stm; // (nbody,) 1 / max(subtreemass, 1e-12), f64->f32
  // joints
  const int* jnt_type;
  const int* jnt_qposadr;
  const int* jnt_dofadr;
  const int* jnt_bodyid;
  const float* jnt_pos;    // (njnt, 3)
  const float* jnt_axis;   // (njnt, 3)
  const float* jnt_qpos0;  // (njnt,) qpos0 at the joint's first coordinate
  // dofs
  const int* dof_bodyid;
  const int* ancestor;  // (nv, nv) 0/1: j is i or an ancestor of i
  const int* cdofdot;   // (nv, nv) 0/1: dofs feeding cdof_dot[i]
  const float* armature;
  const float* gravity;  // (3,)
  // geoms and candidate pairs
  const int* geom_bodyid;
  const float* geom_pos;   // (ngeom, 3)
  const float* geom_quat;  // (ngeom, 4)
  const float* geom_size;  // (ngeom, 3)
  const int* group;        // (ngroup, 5): type1, type2, npair, slot, pair offset
  const int* pair_g1;      // geom ids per pair, groups back to back
  const int* pair_g2;
};

enum { FREE = 0, BALL = 1, SLIDE = 2, HINGE = 3 };
enum { PLANE = 0, SPHERE = 2, CAPSULE = 3, BOX = 6 };

// scratch row offsets (same formula as k1_scratch_rows below)
struct K1Scratch {
  int xpos, xquat, xipos, ximat, xanchor, xaxis, cinert, crb, f, cvel, cdotd,
      cacc, cfrc, gx, gmat, rows;
  __device__ __host__ K1Scratch(int nb, int njnt, int nv, int ngeom) {
    xpos = 0;
    xquat = xpos + 3 * nb;
    xipos = xquat + 4 * nb;
    ximat = xipos + 3 * nb;
    xanchor = ximat + 9 * nb;
    xaxis = xanchor + 3 * njnt;
    cinert = xaxis + 3 * njnt;
    crb = cinert + 36 * nb;
    f = crb + 36 * nb;
    cvel = f + 6 * nv;
    cdotd = cvel + 6 * nb;
    cacc = cdotd + 6 * nv;
    cfrc = cacc + 6 * nb;
    gx = cfrc + 6 * nb;
    gmat = gx + 3 * ngeom;
    rows = gmat + 9 * ngeom;
  }
};

// contact frame rows [n, t1, t2] from a normal (fused.py _make_frame_g)
__device__ void make_frame(const float* normal, float* fr) {
  float nn = norm3(normal);
  float a[3] = {normal[0] / nn, normal[1] / nn, normal[2] / nn};
  float y[3] = {0.0f, 0.0f, 0.0f};
  if (fabsf(a[1]) < 0.9f) y[1] = 1.0f; else y[2] = 1.0f;
  float ay = dot3(a, y);
  float b[3] = {y[0] - a[0] * ay, y[1] - a[1] * ay, y[2] - a[2] * ay};
  float bn = norm3(b);
  b[0] = b[0] / bn;
  b[1] = b[1] / bn;
  b[2] = b[2] / bn;
  float c[3];
  cross3(a, b, c);
  for (int k = 0; k < 3; ++k) {
    fr[k] = a[k];
    fr[3 + k] = b[k];
    fr[6 + k] = c[k];
  }
}

__device__ void closest_seg_point(const float* a, const float* b,
                                  const float* p, float* out) {
  float ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  float pa[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
  float t = dot3(pa, ab) / fmaxf(dot3(ab, ab), MWT_MINVAL);
  t = clampf(t, 0.0f, 1.0f);
  for (int k = 0; k < 3; ++k) out[k] = a[k] + ab[k] * t;
}

// dist, pos, normal of two spheres (fused.py _sphere_sphere_g)
__device__ float sphere_sphere(const float* p1, float r1, const float* p2,
                               float r2, float* pos, float* n) {
  float vec[3] = {p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]};
  float ln = norm3(vec);
  for (int k = 0; k < 3; ++k) n[k] = vec[k] / ln;
  float dist = ln - (r1 + r2);
  for (int k = 0; k < 3; ++k) pos[k] = p1[k] + n[k] * (r1 + 0.5f * dist);
  return dist;
}

__device__ void write_contact(const K1Params& p, int W, int w, int slot,
                              float dist, const float* pos, const float* fr) {
  LANE(p.dist, slot) = dist;
  STORE(p.cpos, 3 * slot, pos, 3);
  STORE(p.cframe, 9 * slot, fr, 9);
}

__device__ void zcol(const float* R, float* z) {
  z[0] = R[2];
  z[1] = R[5];
  z[2] = R[8];
}

__device__ void narrowphase_pair(const K1Params& p, const K1Scratch& s, int W,
                                 int w, int t1, int t2, int n, int slot0,
                                 int pl, int g1, int g2) {
  float P1[3], P2[3], M1[9], M2[9];
  LOAD(P1, p.scr, s.gx + 3 * g1, 3);
  LOAD(P2, p.scr, s.gx + 3 * g2, 3);
  LOAD(M1, p.scr, s.gmat + 9 * g1, 9);
  LOAD(M2, p.scr, s.gmat + 9 * g2, 9);
  const float* sz1 = p.geom_size + 3 * g1;
  const float* sz2 = p.geom_size + 3 * g2;
  float fr[9], pos[3], nrm[3];
  if (t1 == PLANE && t2 == SPHERE) {
    zcol(M1, nrm);
    float r = sz2[0];
    float d[3] = {P2[0] - P1[0], P2[1] - P1[1], P2[2] - P1[2]};
    float dist = dot3(nrm, d) - r;
    for (int k = 0; k < 3; ++k) pos[k] = P2[k] - nrm[k] * (r + 0.5f * dist);
    make_frame(nrm, fr);
    write_contact(p, W, w, slot0 + pl, dist, pos, fr);
  } else if (t1 == PLANE && t2 == CAPSULE) {
    float axis[3];
    zcol(M1, nrm);
    zcol(M2, axis);
    float r = sz2[0], half = sz2[1];
    float na = dot3(nrm, axis);
    float b[3] = {axis[0] - nrm[0] * na, axis[1] - nrm[1] * na,
                  axis[2] - nrm[2] * na};
    float bn = norm3(b);
    if (bn < 0.5f) {
      bool ny = fabsf(nrm[1]) < 0.5f;
      b[0] = 0.0f;
      b[1] = ny ? 1.0f : 0.0f;
      b[2] = ny ? 0.0f : 1.0f;
    } else {
      b[0] = b[0] / bn;
      b[1] = b[1] / bn;
      b[2] = b[2] / bn;
    }
    float c[3];
    cross3(nrm, b, c);
    for (int k = 0; k < 3; ++k) {
      fr[k] = nrm[k];
      fr[3 + k] = b[k];
      fr[6 + k] = c[k];
    }
    for (int e = 0; e < 2; ++e) {
      float cen[3], d[3];
      for (int k = 0; k < 3; ++k) {
        float seg = axis[k] * half;
        cen[k] = e == 0 ? P2[k] + seg : P2[k] + (-seg);
        d[k] = cen[k] - P1[k];
      }
      float dist = dot3(nrm, d) - r;
      for (int k = 0; k < 3; ++k) pos[k] = cen[k] - nrm[k] * (r + 0.5f * dist);
      write_contact(p, W, w, slot0 + e * n + pl, dist, pos, fr);
    }
  } else if (t1 == PLANE && t2 == BOX) {
    // the 4 deepest of the 8 corners, index-tracked, first index wins ties
    zcol(M1, nrm);
    float h[8], cw[8][3];
    int k = 0;
    for (int ia = 0; ia < 2; ++ia)
      for (int ib = 0; ib < 2; ++ib)
        for (int ic = 0; ic < 2; ++ic, ++k) {
          float l[3] = {(ia ? 1.0f : -1.0f) * sz2[0],
                        (ib ? 1.0f : -1.0f) * sz2[1],
                        (ic ? 1.0f : -1.0f) * sz2[2]};
          float rl[3], d[3];
          matvec3(M2, l, rl);
          for (int q = 0; q < 3; ++q) {
            cw[k][q] = P2[q] + rl[q];
            d[q] = cw[k][q] - P1[q];
          }
          h[k] = dot3(nrm, d);
        }
    make_frame(nrm, fr);
    bool taken[8] = {false, false, false, false, false, false, false, false};
    for (int pick = 0; pick < 4; ++pick) {
      int im = 0;
      float hmin = taken[0] ? MWT_BIGW : h[0];
      for (int q = 1; q < 8; ++q) {
        float hq = taken[q] ? MWT_BIGW : h[q];
        if (hq < hmin) {
          hmin = hq;
          im = q;
        }
      }
      taken[im] = true;
      for (int q = 0; q < 3; ++q) pos[q] = cw[im][q] - nrm[q] * (0.5f * hmin);
      write_contact(p, W, w, slot0 + pick * n + pl, hmin, pos, fr);
    }
  } else if (t1 == SPHERE && t2 == BOX) {
    float r = sz1[0];
    float dv[3] = {P1[0] - P2[0], P1[1] - P2[1], P1[2] - P2[2]};
    float loc[3], cl[3], fd[3];
    matTvec3(M2, dv, loc);
    bool inside = true;
    for (int q = 0; q < 3; ++q) {
      cl[q] = fminf(fmaxf(loc[q], -sz2[q]), sz2[q]);
      inside = inside && (fabsf(loc[q]) < sz2[q]);
      fd[q] = sz2[q] - fabsf(loc[q]);
    }
    int k01 = fd[0] <= fd[1] ? 0 : 1;
    float fd01 = fminf(fd[0], fd[1]);
    int kmin = fd01 <= fd[2] ? k01 : 2;
    float cll[3];
    for (int q = 0; q < 3; ++q) {
      float sg = loc[q] > 0.0f ? 1.0f : (loc[q] < 0.0f ? -1.0f : 1.0f);
      cll[q] = (inside && kmin == q) ? sg * sz2[q] : cl[q];
    }
    float rc[3], vec[3];
    matvec3(M2, cll, rc);
    for (int q = 0; q < 3; ++q) vec[q] = (P2[q] + rc[q]) - P1[q];
    float ln = norm3(vec);
    for (int q = 0; q < 3; ++q) nrm[q] = vec[q] / ln;
    float dist = inside ? -(ln + r) : ln - r;
    if (inside)
      for (int q = 0; q < 3; ++q) nrm[q] = -nrm[q];
    for (int q = 0; q < 3; ++q) pos[q] = P1[q] + nrm[q] * (r + 0.5f * dist);
    make_frame(nrm, fr);
    write_contact(p, W, w, slot0 + pl, dist, pos, fr);
  } else if (t1 == CAPSULE && t2 == BOX) {
    // sphere-box probes at both ends and at the point nearest the box
    // center; the 2 deepest, index-tracked
    float axis[3];
    zcol(M1, axis);
    float r = sz1[0], half = sz1[1];
    float cen[3][3];
    for (int q = 0; q < 3; ++q) {
      float seg = axis[q] * half;
      cen[0][q] = P1[q] - seg;
      cen[1][q] = P1[q] + seg;
    }
    closest_seg_point(cen[0], cen[1], P2, cen[2]);
    float pd[3], pp[3][3], pn[3][3];
    for (int e = 0; e < 3; ++e) {
      float d[3], rel[3], cl[3], rc[3], vec[3];
      for (int q = 0; q < 3; ++q) d[q] = cen[e][q] - P2[q];
      matTvec3(M2, d, rel);
      for (int q = 0; q < 3; ++q) cl[q] = fminf(fmaxf(rel[q], -sz2[q]), sz2[q]);
      matvec3(M2, cl, rc);
      for (int q = 0; q < 3; ++q) vec[q] = (P2[q] + rc[q]) - cen[e][q];
      float ln = norm3(vec);
      for (int q = 0; q < 3; ++q) pn[e][q] = vec[q] / ln;
      pd[e] = ln - r;
      for (int q = 0; q < 3; ++q)
        pp[e][q] = cen[e][q] + pn[e][q] * (r + 0.5f * pd[e]);
    }
    bool taken[3] = {false, false, false};
    for (int pick = 0; pick < 2; ++pick) {
      int im = 0;
      float dmin = taken[0] ? MWT_BIGW : pd[0];
      for (int q = 1; q < 3; ++q) {
        float dq = taken[q] ? MWT_BIGW : pd[q];
        if (dq < dmin) {
          dmin = dq;
          im = q;
        }
      }
      taken[im] = true;
      make_frame(pn[im], fr);
      write_contact(p, W, w, slot0 + pick * n + pl, dmin, pp[im], fr);
    }
  } else if (t1 == SPHERE && t2 == SPHERE) {
    float dist = sphere_sphere(P1, sz1[0], P2, sz2[0], pos, nrm);
    make_frame(nrm, fr);
    write_contact(p, W, w, slot0 + pl, dist, pos, fr);
  } else if (t1 == SPHERE && t2 == CAPSULE) {
    float axis[3], a[3], b[3], pt[3];
    zcol(M2, axis);
    for (int q = 0; q < 3; ++q) {
      float seg = axis[q] * sz2[1];
      a[q] = P2[q] - seg;
      b[q] = P2[q] + seg;
    }
    closest_seg_point(a, b, P1, pt);
    float dist = sphere_sphere(P1, sz1[0], pt, sz2[0], pos, nrm);
    make_frame(nrm, fr);
    write_contact(p, W, w, slot0 + pl, dist, pos, fr);
  } else {  // CAPSULE-CAPSULE: closest points of the two segments
    float z1[3], z2[3], a0[3], a1[3], b0[3], b1[3];
    zcol(M1, z1);
    zcol(M2, z2);
    for (int q = 0; q < 3; ++q) {
      float e1 = z1[q] * sz1[1], e2 = z2[q] * sz2[1];
      a0[q] = P1[q] - e1;
      a1[q] = P1[q] + e1;
      b0[q] = P2[q] - e2;
      b1[q] = P2[q] + e2;
    }
    float da[3], db[3], rr[3];
    for (int q = 0; q < 3; ++q) {
      da[q] = a1[q] - a0[q];
      db[q] = b1[q] - b0[q];
      rr[q] = a0[q] - b0[q];
    }
    float A = dot3(da, da), B = dot3(da, db), C = dot3(db, db);
    float D = dot3(da, rr), E = dot3(db, rr);
    float denom = A * C - B * B;
    float sv = denom > 1e-12f ? (B * E - C * D) / fmaxf(denom, MWT_MINVAL) : 0.0f;
    sv = clampf(sv, 0.0f, 1.0f);
    float t = clampf((B * sv + E) / fmaxf(C, MWT_MINVAL), 0.0f, 1.0f);
    float s2 = clampf((B * t - D) / fmaxf(A, MWT_MINVAL), 0.0f, 1.0f);
    float pa[3], pb[3];
    for (int q = 0; q < 3; ++q) {
      pa[q] = a0[q] + da[q] * s2;
      pb[q] = b0[q] + db[q] * t;
    }
    float dist = sphere_sphere(pa, sz1[0], pb, sz2[0], pos, nrm);
    make_frame(nrm, fr);
    write_contact(p, W, w, slot0 + pl, dist, pos, fr);
  }
}

__global__ void __launch_bounds__(128) k1_kernel(const K1Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  const int nb = p.nbody, nv = p.nv;
  const K1Scratch s(nb, p.njnt, nv, p.ngeom);
  float* S = p.scr;

  // ---- forward kinematics, bodies in tree order
  for (int k = 0; k < 3; ++k) LANE(S, s.xpos + k) = 0.0f;
  LANE(S, s.xquat) = 1.0f;
  for (int k = 1; k < 4; ++k) LANE(S, s.xquat + k) = 0.0f;
  for (int t = 0; t < nb - 1; ++t) {
    const int b = p.topo[t], par = p.body_parent[b];
    float pq[4], pp[3], R[9], rv[3], pos[3], quat[4];
    LOAD(pq, S, s.xquat + 4 * par, 4);
    LOAD(pp, S, s.xpos + 3 * par, 3);
    q2mat(pq, R);
    matvec3(R, p.body_pos + 3 * b, rv);
    for (int k = 0; k < 3; ++k) pos[k] = pp[k] + rv[k];
    qmul(pq, p.body_quat + 4 * b, quat);
    for (int jj = 0; jj < p.body_jntnum[b]; ++jj) {
      const int j = p.body_jntadr[b] + jj, qa = p.jnt_qposadr[j];
      const int jt = p.jnt_type[j];
      float anchor[3], axis[3];
      if (jt == FREE) {
        LOAD(pos, p.qpos, qa, 3);
        LOAD(quat, p.qpos, qa + 3, 4);
        qnormalize(quat);
        for (int k = 0; k < 3; ++k) anchor[k] = pos[k];
        axis[0] = 0.0f;
        axis[1] = 0.0f;
        axis[2] = 1.0f;
      } else {
        q2mat(quat, R);
        matvec3(R, p.jnt_axis + 3 * j, axis);
        matvec3(R, p.jnt_pos + 3 * j, rv);
        for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + rv[k];
        float disp = LANE(p.qpos, qa) - p.jnt_qpos0[j];
        if (jt == SLIDE) {
          for (int k = 0; k < 3; ++k) pos[k] = pos[k] + axis[k] * disp;
        } else {  // HINGE
          float half = 0.5f * disp;
          float sn = sinf(half);
          const float* ax = p.jnt_axis + 3 * j;
          float qloc[4] = {cosf(half), sn * ax[0], sn * ax[1], sn * ax[2]};
          qmul(quat, qloc, quat);
          q2mat(quat, R);
          matvec3(R, p.jnt_pos + 3 * j, rv);
          for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - rv[k];
        }
      }
      STORE(S, s.xanchor + 3 * j, anchor, 3);
      STORE(S, s.xaxis + 3 * j, axis, 3);
    }
    qnormalize(quat);
    STORE(S, s.xpos + 3 * b, pos, 3);
    STORE(S, s.xquat + 4 * b, quat, 4);
  }

  // ---- com quantities: xipos/ximat, subtree com, cinert, cdof
  for (int b = 0; b < nb; ++b) {
    float q[4], R[9], rv[3], xp[3], qi[4], Ri[9];
    LOAD(q, S, s.xquat + 4 * b, 4);
    LOAD(xp, S, s.xpos + 3 * b, 3);
    q2mat(q, R);
    matvec3(R, p.body_ipos + 3 * b, rv);
    for (int k = 0; k < 3; ++k) LANE(S, s.xipos + 3 * b + k) = xp[k] + rv[k];
    qmul(q, p.body_iquat + 4 * b, qi);
    q2mat(qi, Ri);
    STORE(S, s.ximat + 9 * b, Ri, 9);
  }
  for (int b = 0; b < nb; ++b) {
    float acc[3] = {0.0f, 0.0f, 0.0f};
    bool any = false;
    for (int j = 0; j < nb; ++j) {
      const float mj = p.body_mass[j];
      if (!p.subtree[b * nb + j] || mj == 0.0f) continue;
      for (int k = 0; k < 3; ++k) {
        float t = LANE(S, s.xipos + 3 * j + k) * mj;
        acc[k] = any ? acc[k] + t : t;
      }
      any = true;
    }
    for (int k = 0; k < 3; ++k)
      LANE(p.stcom, 3 * b + k) = acc[k] * p.body_inv_stm[b];
  }
  for (int b = 0; b < nb; ++b) {
    float R[9], c[3], xi[3], com[3];
    LOAD(R, S, s.ximat + 9 * b, 9);
    LOAD(xi, S, s.xipos + 3 * b, 3);
    LOAD(com, p.stcom, 3 * p.body_rootid[b], 3);
    for (int k = 0; k < 3; ++k) c[k] = xi[k] - com[k];
    const float mss = p.body_mass[b];
    const float* I = p.body_inertia + 3 * b;
    float ic[3][3];
    for (int a = 0; a < 3; ++a)
      for (int bb = a; bb < 3; ++bb) {
        float acc = 0.0f;
        bool any = false;
        for (int k = 0; k < 3; ++k) {
          if (I[k] == 0.0f) continue;
          float t = R[3 * a + k] * R[3 * bb + k] * I[k];
          acc = any ? acc + t : t;
          any = true;
        }
        ic[a][bb] = ic[bb][a] = acc;
      }
    float cc = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    float ch[3][3] = {{0.0f, -mss * c[2], mss * c[1]},
                      {mss * c[2], 0.0f, -mss * c[0]},
                      {-mss * c[1], mss * c[0], 0.0f}};
    float ci[36];
    for (int a = 0; a < 3; ++a) {
      for (int bb = 0; bb < 3; ++bb) {
        ci[6 * a + bb] = a == bb ? ic[a][bb] + mss * (cc - c[a] * c[bb])
                                 : ic[a][bb] - mss * c[a] * c[bb];
        ci[6 * a + 3 + bb] = ch[a][bb];
        ci[6 * (3 + a) + bb] = -ch[a][bb];
        ci[6 * (3 + a) + 3 + bb] = a == bb ? mss : 0.0f;
      }
    }
    STORE(S, s.cinert + 36 * b, ci, 36);
  }
  for (int j = 0; j < p.njnt; ++j) {
    const int b = p.jnt_bodyid[j], da = p.jnt_dofadr[j], jt = p.jnt_type[j];
    float com[3];
    LOAD(com, p.stcom, 3 * p.body_rootid[b], 3);
    float cd[6];
    if (jt == FREE) {
      for (int a = 0; a < 3; ++a) {
        for (int k = 0; k < 6; ++k) cd[k] = (k == 3 + a) ? 1.0f : 0.0f;
        STORE(p.cdof, 6 * (da + a), cd, 6);
      }
      float q[4], R[9], xp[3], off[3];
      LOAD(q, S, s.xquat + 4 * b, 4);
      LOAD(xp, S, s.xpos + 3 * b, 3);
      q2mat(q, R);
      for (int k = 0; k < 3; ++k) off[k] = xp[k] - com[k];
      for (int a = 0; a < 3; ++a) {
        float axis[3] = {R[a], R[3 + a], R[6 + a]};
        cross3(off, axis, cd + 3);
        for (int k = 0; k < 3; ++k) cd[k] = axis[k];
        STORE(p.cdof, 6 * (da + 3 + a), cd, 6);
      }
    } else {
      float axis[3];
      LOAD(axis, S, s.xaxis + 3 * j, 3);
      if (jt == SLIDE) {
        for (int k = 0; k < 3; ++k) {
          cd[k] = 0.0f;
          cd[3 + k] = axis[k];
        }
      } else {
        float anc[3], off[3];
        LOAD(anc, S, s.xanchor + 3 * j, 3);
        for (int k = 0; k < 3; ++k) off[k] = anc[k] - com[k];
        for (int k = 0; k < 3; ++k) cd[k] = axis[k];
        cross3(off, axis, cd + 3);
      }
      STORE(p.cdof, 6 * da, cd, 6);
    }
  }

  // ---- geom frames and the narrowphase, in candidate-slot order
  if (p.run_col) {
    for (int g = 0; g < p.ngeom; ++g) {
      const int b = p.geom_bodyid[g];
      float q[4], R[9], rv[3], xp[3], qg[4], Rg[9];
      LOAD(q, S, s.xquat + 4 * b, 4);
      LOAD(xp, S, s.xpos + 3 * b, 3);
      q2mat(q, R);
      matvec3(R, p.geom_pos + 3 * g, rv);
      for (int k = 0; k < 3; ++k) LANE(S, s.gx + 3 * g + k) = xp[k] + rv[k];
      qmul(q, p.geom_quat + 4 * g, qg);
      q2mat(qg, Rg);
      STORE(S, s.gmat + 9 * g, Rg, 9);
    }
    for (int gi = 0; gi < p.ngroup; ++gi) {
      const int* G = p.group + 5 * gi;
      for (int pl = 0; pl < G[2]; ++pl)
        narrowphase_pair(p, s, W, w, G[0], G[1], G[2], G[3], pl,
                         p.pair_g1[G[4] + pl], p.pair_g2[G[4] + pl]);
    }
  }

  // ---- mass chain: crb, qM, [Cholesky], com_vel, cdof_dot, RNE
  const MassChainTables mt{nb, nv, p.no_gravity, p.topo, p.body_parent,
                           p.body_dofadr, p.body_dofnum, p.dof_bodyid,
                           p.ancestor, p.cdofdot, p.armature, p.gravity};
  const MassChainBufs mb{S + (size_t)s.cinert * W, p.cdof, p.qvel,
                         S + (size_t)s.crb * W, S + (size_t)s.f * W,
                         S + (size_t)s.cvel * W, S + (size_t)s.cdotd * W,
                         S + (size_t)s.cacc * W, S + (size_t)s.cfrc * W,
                         p.qM, p.need_qld ? p.qLD : nullptr, p.bias};
  mass_chain_world(mt, mb, W, w);
}

extern "C" {

int mwt_k1_params_size() { return (int)sizeof(K1Params); }

int mwt_k1_scratch_rows(int nbody, int njnt, int nv, int ngeom) {
  return K1Scratch(nbody, njnt, nv, ngeom).rows;
}

// Launches K1 on `stream`; returns cudaGetLastError() of the launch.
int mwt_k1_launch(const K1Params* p, void* stream) {
  const int threads = 128;
  const int blocks = (p->W + threads - 1) / threads;
  k1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
