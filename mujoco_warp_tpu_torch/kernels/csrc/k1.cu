// K1 of the fused step: forward kinematics -> com quantities -> geom
// frames -> lane narrowphase -> mass chain (crb, qM + armature, optional
// Cholesky, com_vel, cdof_dot, RNE bias), one warp per world.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/fused.py _make_k1
// (:986, launched by _k1_call :1075) together with
// mujoco_warp_tpu/pallas/smooth.py mass_chain_core (:43), which lives in
// mass_chain.cuh, shared with the standalone mass-chain kernel.
//
// Bound.  Per world the kernel reads qpos and qvel and writes qM, [qLD],
// bias, cdof, subtree_com and ncand contacts of 13 floats: at the humanoid
// (nq 28, nv 27, nbody 17, ncand 177) 13.1 KB per world, 107 MB at 8192
// worlds (32 us at 3.35 TB/s); its flops (~400 per body, ~100 per
// candidate, the mass chain's) take less.  What bounds it is each world's
// chain of dependent steps down the tree.
//
// Design.  Pallas unrolled the model at trace time and folded its
// constants; here the kernel walks device tables the wrapper uploads once
// per model (kernels/k1.py), so one binary serves every model inside the
// fused gate (nv <= 64, nbody <= 32, ncand <= 512, and one world within
// a block's shared memory).  Each world gets one warp, and a block 8
// worlds where they fit (warp.cuh sector_worlds: whole 32-byte sectors of
// each lanes-last row per block).
// The block copies qpos and qvel (lanes-last) into shared memory with
// cp.async, and every intermediate stays in the world's shared floats
// (K1Layout).  The lanes take one body of a tree level each for the
// kinematics (a __syncwarp between levels), then a body each for xipos,
// subtree com and cinert, a joint each for cdof, a geom each for the geom
// frames, and a candidate pair each for the narrowphase, group by group,
// so that a warp's lanes take one collider's branch; each lane keeps the
// one-thread-per-world kernel's order of operations, so every output is
// the same to the last bit.  After the narrowphase a block barrier, and
// the contacts are stored lanes-last (the world as the fastest thread
// index, so a block's worlds write whole sectors of each row); the mass
// chain (mass_chain_qm, mass_chain_rne) then takes the frames' and
// contacts' floats.
// After a last barrier qM, qLD, bias, cdof and subtree_com are stored the
// same way.

#include "mass_chain.cuh"

struct K1Params {
  // ngeom, ncand and ngroup 0 without collision
  int W, nq, nv, nbody, njnt, ngeom, ncand, ngroup, nlevel, need_qld,
      no_gravity;
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
  // bodies
  const int* topo;         // (nbody-1,) bodies by tree depth, level by level
  const int* level_adr;    // (nlevel+1,) each level's first index in topo
  const int* body_parent;  // (nbody,)
  const int* body_jntadr;
  const int* body_jntnum;
  const int* body_rootid;
  const int* body_dofadr;  // first dof of the body
  const int* body_dofnum;
  const unsigned* subtree_bits;  // (nbody, ceil(nbody / 32)) bit rows: j in
                                 // subtree(i)
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
  const unsigned* anc_bits;      // (nv, ceil(nv / 32)) bit rows, as in
  const unsigned* rel_bits;      // mass_chain.cuh MassChainTables
  const unsigned* cdofdot_bits;
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

// One world's shared floats (ngeom and ncand 0 without collision): qpos,
// qvel, subtree_com, cinert, cdof and bias first; then the frames' region,
// the geom frames and either the body and joint frames or, once the geom
// frames are formed, the contacts in the same floats; the mass chain's
// region (qM, crb, f, cvel, cdof_dot, [factor]) takes over the frames'
// once the contacts are stored.  An odd total, so that the block's loads
// and stores, the world the fastest index, touch distinct banks.  At the
// humanoid 3449 floats, so that two blocks of 8 worlds fit in an SM.
struct K1Layout {
  int qpos, qvel, stcom, cinert, cdof, bias;
  int gx, gmat, xpos, xquat, xipos, ximat, xanchor, xaxis, dist, cpos,
      cframe;
  int qM, crb, f, cvel, cdotd, L;
  int total;
  __host__ __device__ K1Layout(int nq, int nv, int nb, int njnt, int ngeom,
                               int ncand, bool factor) {
    qpos = 0;
    qvel = qpos + nq;
    stcom = qvel + nv;
    cinert = stcom + 3 * nb;
    cdof = cinert + 36 * nb;
    bias = cdof + 6 * nv;
    const int region = bias + nv;
    gx = region;
    gmat = gx + 3 * ngeom;
    const int over = gmat + 9 * ngeom;  // body frames, then contacts
    xpos = over;
    xquat = xpos + 3 * nb;
    xipos = xquat + 4 * nb;
    ximat = xipos + 3 * nb;
    xanchor = ximat + 9 * nb;
    xaxis = xanchor + 3 * njnt;
    dist = over;
    cpos = dist + ncand;
    cframe = cpos + 3 * ncand;
    const int frames_end = max(xaxis + 3 * njnt, cframe + 9 * ncand);
    qM = region;
    crb = qM + nv * nv;
    f = crb + 36 * nb;
    cvel = f + 6 * nv;
    cdotd = cvel + 6 * nb;
    L = cdotd + 6 * nv;
    const int chain_end = L + (factor ? nv * chol_stride(nv) : 0);
    total = max(frames_end, chain_end) | 1;
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

// the world's contact outputs in shared memory
struct K1Contacts {
  float* dist;    // (ncand)
  float* cpos;    // (3 ncand)
  float* cframe;  // (9 ncand)
};

__device__ void write_contact(const K1Contacts& out, int slot, float dist,
                              const float* pos, const float* fr) {
  out.dist[slot] = dist;
  for (int k = 0; k < 3; ++k) out.cpos[3 * slot + k] = pos[k];
  for (int k = 0; k < 9; ++k) out.cframe[9 * slot + k] = fr[k];
}

__device__ void zcol(const float* R, float* z) {
  z[0] = R[2];
  z[1] = R[5];
  z[2] = R[8];
}

// Candidate pair pl of a group of n pairs whose slots start at slot0,
// between geoms g1 and g2 of types t1 and t2, from the geom frames gx
// (3 ngeom) and gmat (9 ngeom) into the contact outputs.
__device__ void narrowphase_pair(const K1Params& p, const float* gx,
                                 const float* gmat, const K1Contacts& out,
                                 int t1, int t2, int n, int slot0, int pl,
                                 int g1, int g2) {
  float P1[3], P2[3], M1[9], M2[9];
  for (int k = 0; k < 3; ++k) {
    P1[k] = gx[3 * g1 + k];
    P2[k] = gx[3 * g2 + k];
  }
  for (int k = 0; k < 9; ++k) {
    M1[k] = gmat[9 * g1 + k];
    M2[k] = gmat[9 * g2 + k];
  }
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
    write_contact(out, slot0 + pl, dist, pos, fr);
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
      write_contact(out, slot0 + e * n + pl, dist, pos, fr);
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
      write_contact(out, slot0 + pick * n + pl, hmin, pos, fr);
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
    write_contact(out, slot0 + pl, dist, pos, fr);
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
      write_contact(out, slot0 + pick * n + pl, dmin, pp[im], fr);
    }
  } else if (t1 == SPHERE && t2 == SPHERE) {
    float dist = sphere_sphere(P1, sz1[0], P2, sz2[0], pos, nrm);
    make_frame(nrm, fr);
    write_contact(out, slot0 + pl, dist, pos, fr);
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
    write_contact(out, slot0 + pl, dist, pos, fr);
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
    write_contact(out, slot0 + pl, dist, pos, fr);
  }
}

// Forward kinematics, com quantities, cdof and (with collision) the geom
// frames of one world in its floats b, by the warp's lanes.
__device__ __forceinline__ void k1_frames(const K1Params& p,
                                          const K1Layout& l, float* b,
                                          int lane) {
  MWT_SHARED(b);
  const int nb = p.nbody;
  const float* qpos = b + l.qpos;
  float* xpos = b + l.xpos;
  float* xquat = b + l.xquat;
  float* xipos = b + l.xipos;
  float* ximat = b + l.ximat;
  float* xanchor = b + l.xanchor;
  float* xaxis = b + l.xaxis;
  float* stcom = b + l.stcom;
  float* cinert = b + l.cinert;
  float* cdof = b + l.cdof;

  // ---- forward kinematics, a tree level at a time, a body per lane
  if (lane < 3) xpos[lane] = 0.0f;
  if (lane < 4) xquat[lane] = lane == 0 ? 1.0f : 0.0f;
  __syncwarp();
  for (int lv = 0; lv < p.nlevel; ++lv) {
    for (int t = p.level_adr[lv] + lane; t < p.level_adr[lv + 1];
         t += 32) {
      const int bd = p.topo[t], par = p.body_parent[bd];
      float pq[4], pp[3], R[9], rv[3], pos[3], quat[4];
      for (int k = 0; k < 4; ++k) pq[k] = xquat[4 * par + k];
      for (int k = 0; k < 3; ++k) pp[k] = xpos[3 * par + k];
      q2mat(pq, R);
      matvec3(R, p.body_pos + 3 * bd, rv);
      for (int k = 0; k < 3; ++k) pos[k] = pp[k] + rv[k];
      qmul(pq, p.body_quat + 4 * bd, quat);
      for (int jj = 0; jj < p.body_jntnum[bd]; ++jj) {
        const int j = p.body_jntadr[bd] + jj, qa = p.jnt_qposadr[j];
        const int jt = p.jnt_type[j];
        float anchor[3], axis[3];
        if (jt == FREE) {
          for (int k = 0; k < 3; ++k) pos[k] = qpos[qa + k];
          for (int k = 0; k < 4; ++k) quat[k] = qpos[qa + 3 + k];
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
          float disp = qpos[qa] - p.jnt_qpos0[j];
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
        for (int k = 0; k < 3; ++k) {
          xanchor[3 * j + k] = anchor[k];
          xaxis[3 * j + k] = axis[k];
        }
      }
      qnormalize(quat);
      for (int k = 0; k < 3; ++k) xpos[3 * bd + k] = pos[k];
      for (int k = 0; k < 4; ++k) xquat[4 * bd + k] = quat[k];
    }
    __syncwarp();
  }

  // ---- com quantities: xipos/ximat, subtree com, cinert, cdof
  for (int bd = lane; bd < nb; bd += 32) {
    float R[9], rv[3], qi[4];
    const float* q = xquat + 4 * bd;
    q2mat(q, R);
    matvec3(R, p.body_ipos + 3 * bd, rv);
    for (int k = 0; k < 3; ++k) xipos[3 * bd + k] = xpos[3 * bd + k] + rv[k];
    qmul(q, p.body_iquat + 4 * bd, qi);
    q2mat(qi, ximat + 9 * bd);
  }
  __syncwarp();
  const int nbw = (nb + 31) >> 5;
  for (int bd = lane; bd < nb; bd += 32) {
    float acc[3] = {0.0f, 0.0f, 0.0f};
    bool any = false;
    for (int q = 0; q < nbw; ++q)
      for (unsigned bits = p.subtree_bits[bd * nbw + q]; bits;
           bits &= bits - 1) {
        const int j = 32 * q + __ffs(bits) - 1;
        const float mj = p.body_mass[j];
        if (mj == 0.0f) continue;
        for (int k = 0; k < 3; ++k) {
          float t = xipos[3 * j + k] * mj;
          acc[k] = any ? acc[k] + t : t;
        }
        any = true;
      }
    for (int k = 0; k < 3; ++k)
      stcom[3 * bd + k] = acc[k] * p.body_inv_stm[bd];
  }
  __syncwarp();
  for (int bd = lane; bd < nb; bd += 32) {
    const float* R = ximat + 9 * bd;
    const float* com = stcom + 3 * p.body_rootid[bd];
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = xipos[3 * bd + k] - com[k];
    const float mss = p.body_mass[bd];
    const float* I = p.body_inertia + 3 * bd;
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
    float* ci = cinert + 36 * bd;
    for (int a = 0; a < 3; ++a) {
      for (int bb = 0; bb < 3; ++bb) {
        ci[6 * a + bb] = a == bb ? ic[a][bb] + mss * (cc - c[a] * c[bb])
                                 : ic[a][bb] - mss * c[a] * c[bb];
        ci[6 * a + 3 + bb] = ch[a][bb];
        ci[6 * (3 + a) + bb] = -ch[a][bb];
        ci[6 * (3 + a) + 3 + bb] = a == bb ? mss : 0.0f;
      }
    }
  }
  for (int j = lane; j < p.njnt; j += 32) {
    const int bd = p.jnt_bodyid[j], da = p.jnt_dofadr[j], jt = p.jnt_type[j];
    const float* com = stcom + 3 * p.body_rootid[bd];
    float cd[6];
    if (jt == FREE) {
      for (int a = 0; a < 3; ++a)
        for (int k = 0; k < 6; ++k)
          cdof[6 * (da + a) + k] = (k == 3 + a) ? 1.0f : 0.0f;
      float R[9], off[3];
      q2mat(xquat + 4 * bd, R);
      for (int k = 0; k < 3; ++k) off[k] = xpos[3 * bd + k] - com[k];
      for (int a = 0; a < 3; ++a) {
        float axis[3] = {R[a], R[3 + a], R[6 + a]};
        cross3(off, axis, cd + 3);
        for (int k = 0; k < 3; ++k) cd[k] = axis[k];
        for (int k = 0; k < 6; ++k) cdof[6 * (da + 3 + a) + k] = cd[k];
      }
    } else {
      const float* axis = xaxis + 3 * j;
      if (jt == SLIDE) {
        for (int k = 0; k < 3; ++k) {
          cd[k] = 0.0f;
          cd[3 + k] = axis[k];
        }
      } else {
        float off[3];
        for (int k = 0; k < 3; ++k) off[k] = xanchor[3 * j + k] - com[k];
        for (int k = 0; k < 3; ++k) cd[k] = axis[k];
        cross3(off, axis, cd + 3);
      }
      for (int k = 0; k < 6; ++k) cdof[6 * da + k] = cd[k];
    }
  }

  // ---- geom frames (none without collision), a geom per lane
  float* gx = b + l.gx;
  float* gmat = b + l.gmat;
  for (int g = lane; g < p.ngeom; g += 32) {
    const int bd = p.geom_bodyid[g];
    float R[9], rv[3], qg[4];
    const float* q = xquat + 4 * bd;
    q2mat(q, R);
    matvec3(R, p.geom_pos + 3 * g, rv);
    for (int k = 0; k < 3; ++k) gx[3 * g + k] = xpos[3 * bd + k] + rv[k];
    qmul(q, p.geom_quat + 4 * g, qg);
    q2mat(qg, gmat + 9 * g);
  }
  __syncwarp();
}

__global__ void k1_kernel(const K1Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.W, nb = p.nbody, nv = p.nv;
  const K1Layout lay(p.nq, nv, nb, p.njnt, p.ngeom, p.ncand,
                     p.need_qld != 0);
  const int wf = lay.total;
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), W - w0);
  // qpos and qvel lanes-last: world stride 1, element stride W
  load_block(p.qpos, 1, W, w0, nw, p.nq, p.nq, false, AtVector{},
             smem + lay.qpos, wf);
  load_block(p.qvel, 1, W, w0, nw, nv, nv, false, AtVector{},
             smem + lay.qvel, wf);
  copies_done();
  float* b = smem + warp * wf;
  if (warp < nw) {
    k1_frames(p, lay, b, lane);
    // ---- the narrowphase, a group at a time, a candidate pair per lane
    const K1Contacts c{b + lay.dist, b + lay.cpos, b + lay.cframe};
    for (int gi = 0; gi < p.ngroup; ++gi) {
      const int* G = p.group + 5 * gi;
      for (int pl = lane; pl < G[2]; pl += 32)
        narrowphase_pair(p, b + lay.gx, b + lay.gmat, c, G[0], G[1], G[2],
                         G[3], pl, p.pair_g1[G[4] + pl],
                         p.pair_g2[G[4] + pl]);
    }
  }
  if (p.ncand) {  // the contacts, before the mass chain takes their floats
    __syncthreads();
    store_block(p.dist, W, w0, nw, p.ncand, smem + lay.dist, wf);
    store_block(p.cpos, W, w0, nw, 3 * p.ncand, smem + lay.cpos, wf);
    store_block(p.cframe, W, w0, nw, 9 * p.ncand, smem + lay.cframe, wf);
    __syncthreads();
  }
  if (warp < nw) {
    // ---- mass chain: crb, qM, [Cholesky], com_vel, cdof_dot, RNE
    const MassChainTables t{nb, nv, p.nlevel, p.no_gravity, p.topo,
                            p.level_adr, p.body_parent, p.body_dofadr,
                            p.body_dofnum, p.dof_bodyid, p.anc_bits,
                            p.rel_bits, p.cdofdot_bits, p.armature,
                            p.gravity};
    const MassChainSmem s{b + lay.cinert, b + lay.cdof, b + lay.qvel,
                          b + lay.crb, b + lay.f, b + lay.cvel,
                          b + lay.cdotd, b + lay.qM, nv,
                          p.need_qld ? b + lay.L : nullptr, b + lay.bias};
    mass_chain_qm(t, s, nullptr, lane);
    mass_chain_rne(t, s, lane);
  }
  __syncthreads();
  // the outputs lanes-last, the world as the fastest thread index
  store_block(p.qM, W, w0, nw, nv * nv, smem + lay.qM, wf);
  if (p.need_qld)
    store_block_matrix(p.qLD, W, w0, nw, nv, smem + lay.L, chol_stride(nv),
                       wf, true);
  store_block(p.bias, W, w0, nw, nv, smem + lay.bias, wf);
  store_block(p.cdof, W, w0, nw, 6 * nv, smem + lay.cdof, wf);
  store_block(p.stcom, W, w0, nw, 3 * nb, smem + lay.stcom, wf);
}

// shared bytes per world and worlds per block for p's sizes
static void k1_config(const K1Params* p, size_t* per_world, int* wpb) {
  *per_world = (size_t)K1Layout(p->nq, p->nv, p->nbody, p->njnt, p->ngeom,
                                p->ncand, p->need_qld != 0)
                   .total *
               sizeof(float);
  *wpb = sector_worlds(*per_world);
}

extern "C" {

int mwt_k1_params_size() { return (int)sizeof(K1Params); }

// shared floats of one world (ngeom and ncand 0 without collision)
int mwt_k1_world_floats(int nq, int nv, int nbody, int njnt, int ngeom,
                        int ncand, int factor) {
  return K1Layout(nq, nv, nbody, njnt, ngeom, ncand, factor != 0).total;
}

// Launches K1 on `stream`; returns cudaGetLastError() of the launch.
int mwt_k1_launch(const K1Params* p, void* stream) {
  size_t per_world;
  int wpb;
  k1_config(p, &per_world, &wpb);
  return launch_worlds(k1_kernel, p, p->W, wpb, per_world, stream);
}

// the kernel's registers per thread, worlds per block and shared bytes per
// block for p's sizes, into out[0..2]
int mwt_k1_info(const K1Params* p, int* out) {
  size_t per_world;
  int wpb;
  k1_config(p, &per_world, &wpb);
  return kernel_info(k1_kernel, wpb, per_world, out);
}

}  // extern "C"
