// The mass chain shared by K1 (k1.cu) and the standalone mass-chain
// kernel (mass_chain.cu), for one world: crb -> qM + armature ->
// [Cholesky] -> com_vel -> cdof_dot -> RNE bias.  Counterpart of
// mujoco_warp_tpu/pallas/smooth.py mass_chain_core (:43), small-tree form.
//
// Bodies are walked in tree order from device tables; each body's dofs are
// the contiguous range body_dofadr .. + body_dofnum (3 for a ball joint,
// 6 for a free joint), and cdof_dot takes its feeding dofs from the
// cdofdot table, so no body is assumed to carry one dof.
#pragma once

#include "common.cuh"

#define LOAD(dst, ptr, r0, n) \
  for (int _k = 0; _k < (n); ++_k) (dst)[_k] = LANE(ptr, (r0) + _k)
#define STORE(ptr, r0, src, n) \
  for (int _k = 0; _k < (n); ++_k) LANE(ptr, (r0) + _k) = (src)[_k]

struct MassChainTables {
  int nb, nv, no_gravity;
  const int* topo;         // (nbody-1,) bodies by tree depth
  const int* body_parent;  // (nbody,)
  const int* body_dofadr;  // first dof of the body
  const int* body_dofnum;
  const int* dof_bodyid;
  const int* ancestor;  // (nv, nv) 0/1: j is i or an ancestor of i
  const int* cdofdot;   // (nv, nv) 0/1: dofs feeding cdof_dot[i]
  const float* armature;
  const float* gravity;  // (3,)
};

// per-world buffers, each lanes-last with row stride W
struct MassChainBufs {
  const float* cinert;  // (36 nbody, W)
  const float* cdof;    // (6 nv, W)
  const float* qvel;    // (nv, W)
  float* crb;           // (36 nbody, W) scratch
  float* f;             // (6 nv, W) scratch
  float* cvel;          // (6 nbody, W)
  float* cdotd;         // (6 nv, W) cdof_dot
  float* cacc;          // (6 nbody, W) scratch
  float* cfrc;          // (6 nbody, W) scratch
  float* qM;            // (nv nv, W)
  float* qLD;           // (nv nv, W), or null: no factor
  float* bias;          // (nv, W)
};

// 6x6 row-major (lanes-last at row r0) times a 6-vector
__device__ __forceinline__ void mat6vec(const float* base, int r0,
                                        const float* v, float* out, int W,
                                        int w) {
  for (int r = 0; r < 6; ++r) {
    float acc = 0.0f;
    for (int c = 0; c < 6; ++c) acc = acc + LANE(base, r0 + 6 * r + c) * v[c];
    out[r] = acc;
  }
}

static __device__ void mass_chain_world(const MassChainTables& t,
                                        const MassChainBufs& b, int W,
                                        int w) {
  const int nb = t.nb, nv = t.nv;
  for (int r = 0; r < 36 * nb; ++r) LANE(b.crb, r) = LANE(b.cinert, r);
  for (int n = nb - 2; n >= 0; --n) {
    const int bd = t.topo[n], par = t.body_parent[bd];
    for (int r = 0; r < 36; ++r)
      LANE(b.crb, 36 * par + r) =
          LANE(b.crb, 36 * par + r) + LANE(b.crb, 36 * bd + r);
  }
  for (int i = 0; i < nv; ++i) {
    float cd[6], f[6];
    LOAD(cd, b.cdof, 6 * i, 6);
    mat6vec(b.crb, 36 * t.dof_bodyid[i], cd, f, W, w);
    STORE(b.f, 6 * i, f, 6);
  }
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) {
      float v = 0.0f;
      const bool ij = t.ancestor[i * nv + j], ji = t.ancestor[j * nv + i];
      if (ij || ji) {
        const int jj = ij ? j : i, ii = ij ? i : j;
        for (int k = 0; k < 6; ++k)
          v = v + LANE(b.cdof, 6 * jj + k) * LANE(b.f, 6 * ii + k);
      }
      if (i == j) v = v + t.armature[i];
      LANE(b.qM, i * nv + j) = v;
    }
  if (b.qLD) chol_lanes(b.qM, b.qLD, nv, W, w);

  for (int k = 0; k < 6; ++k) LANE(b.cvel, k) = 0.0f;
  for (int n = 0; n < nb - 1; ++n) {
    const int bd = t.topo[n], par = t.body_parent[bd];
    float acc[6];
    LOAD(acc, b.cvel, 6 * par, 6);
    for (int i = t.body_dofadr[bd]; i < t.body_dofadr[bd] + t.body_dofnum[bd]; ++i) {
      const float qv = LANE(b.qvel, i);
      for (int k = 0; k < 6; ++k) acc[k] = acc[k] + LANE(b.cdof, 6 * i + k) * qv;
    }
    STORE(b.cvel, 6 * bd, acc, 6);
  }
  for (int i = 0; i < nv; ++i) {
    float vb[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool any = false;
    for (int j = 0; j < nv; ++j) {
      if (!t.cdofdot[i * nv + j]) continue;
      const float qv = LANE(b.qvel, j);
      for (int k = 0; k < 6; ++k) {
        float tv = LANE(b.cdof, 6 * j + k) * qv;
        vb[k] = any ? vb[k] + tv : tv;
      }
      any = true;
    }
    float u[6], out[6], t1[3], t2[3];
    LOAD(u, b.cdof, 6 * i, 6);
    cross3(vb, u, out);
    cross3(vb + 3, u, t1);
    cross3(vb, u + 3, t2);
    for (int k = 0; k < 3; ++k) out[3 + k] = t1[k] + t2[k];
    STORE(b.cdotd, 6 * i, out, 6);
  }
  for (int k = 0; k < 6; ++k) {
    LANE(b.cacc, k) = (k < 3 || t.no_gravity) ? 0.0f : -t.gravity[k - 3];
    LANE(b.cfrc, k) = 0.0f;
  }
  for (int n = 0; n < nb - 1; ++n) {
    const int bd = t.topo[n], par = t.body_parent[bd];
    float acc[6], cv[6], iv[6], ia[6];
    LOAD(acc, b.cacc, 6 * par, 6);
    for (int i = t.body_dofadr[bd]; i < t.body_dofadr[bd] + t.body_dofnum[bd]; ++i) {
      const float qv = LANE(b.qvel, i);
      for (int k = 0; k < 6; ++k) acc[k] = acc[k] + LANE(b.cdotd, 6 * i + k) * qv;
    }
    STORE(b.cacc, 6 * bd, acc, 6);
    LOAD(cv, b.cvel, 6 * bd, 6);
    mat6vec(b.cinert, 36 * bd, cv, iv, W, w);
    mat6vec(b.cinert, 36 * bd, acc, ia, W, w);
    float a1[3], a2[3], a3[3];
    cross3(cv, iv, a1);
    cross3(cv + 3, iv + 3, a2);
    cross3(cv, iv + 3, a3);
    for (int k = 0; k < 3; ++k) {
      LANE(b.cfrc, 6 * bd + k) = ia[k] + (a1[k] + a2[k]);
      LANE(b.cfrc, 6 * bd + 3 + k) = ia[3 + k] + a3[k];
    }
  }
  for (int n = nb - 2; n >= 0; --n) {
    const int bd = t.topo[n], par = t.body_parent[bd];
    for (int k = 0; k < 6; ++k)
      LANE(b.cfrc, 6 * par + k) =
          LANE(b.cfrc, 6 * par + k) + LANE(b.cfrc, 6 * bd + k);
  }
  for (int i = 0; i < nv; ++i) {
    float v = 0.0f;
    const int bd = t.dof_bodyid[i];
    for (int k = 0; k < 6; ++k)
      v = v + LANE(b.cfrc, 6 * bd + k) * LANE(b.cdof, 6 * i + k);
    LANE(b.bias, i) = v;
  }
}
