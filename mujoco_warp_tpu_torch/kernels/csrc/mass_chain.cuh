// The mass chain shared by K1 (k1.cu) and the standalone mass-chain
// kernel (mass_chain.cu): crb -> qM + armature -> [Cholesky] -> com_vel
// -> cdof_dot -> RNE bias, for one world, by the 32 lanes of its warp on
// the world's floats in shared memory.  Counterpart of
// mujoco_warp_tpu/pallas/smooth.py mass_chain_core (:43).
//
// Bodies are walked from device tables; each body's dofs are the
// contiguous range body_dofadr .. + body_dofnum (3 for a ball joint, 6 for
// a free joint), and cdof_dot takes its feeding dofs from a bit table, so
// no body is assumed to carry one dof.  The dof relations are bit rows (a
// row's words the same for the lanes of consecutive columns, and a few
// hundred bytes in all, so that they stay in the L1 cache beside the
// shared memory the kernels take).  The lanes take the
// chain's independent entries: the 36 (or 6) entries of a subtree sum,
// each walking the bodies in reverse tree order; f and bias by dof; qM by
// entry; cvel and cacc by (body of one tree level, entry), level after
// level; cdof_dot by dof and cfrc by body.  Every entry keeps the order
// of sums of the one-thread-per-world chain this replaced, so qM, bias,
// cvel and cdof_dot are the same to the last bit; the factor takes
// chol_warp's order (warp.cuh), which is chol_batched's.
#pragma once

#include "warp.cuh"

struct MassChainTables {
  int nb, nv, nlevel, no_gravity;
  const int* topo;       // (nbody-1,) bodies by tree depth, level by level
  const int* level_adr;  // (nlevel+1,) each level's first index in topo
  const int* body_parent;  // (nbody,)
  const int* body_dofadr;  // first dof of the body
  const int* body_dofnum;
  const int* dof_bodyid;
  // bit rows (nv, ceil(nv / 32)), bit j of row i in word j / 32:
  const unsigned* anc_bits;      // j is i or an ancestor of i
  const unsigned* rel_bits;      // i and j on one branch: either is the
                                 // other or an ancestor of it
  const unsigned* cdofdot_bits;  // dof j feeds cdof_dot[i]
  const float* armature;
  const float* gravity;  // (3,)
};

// bit j of row i of a table of bit rows, nw words each
__device__ __forceinline__ bool bit_at(const unsigned* rows, int i, int j,
                                       int nw) {
  return (rows[i * nw + (j >> 5)] >> (j & 31)) & 1u;
}

// One world's floats of the chain in shared memory.
struct MassChainSmem {
  const float* cinert;  // (36 nbody)
  const float* cdof;    // (6 nv)
  const float* qvel;    // (nv)
  float* crb;           // (36 nbody); cacc and cfrc (6 nbody each) once f is
                        // formed
  float* f;             // (6 nv) crb cdof
  float* cvel;          // (6 nbody)
  float* cdotd;         // (6 nv) cdof_dot
  float* qM;            // (nv qld), or null: qM goes to global memory
  int qld;              // qM's row stride
  float* L;             // (nv chol_stride(nv)) lower triangle, or null: no
                        // factor; L == qM factors qM in place
  float* bias;          // (nv)
};

// qM entry (i, j): cdof of the ancestor dof dotted with f of the other,
// k = 0..5 in order (a structural zero off the ancestor relation), plus the
// armature on the diagonal
__device__ __forceinline__ float mc_qm_entry(const MassChainTables& t,
                                             const MassChainSmem& s, int i,
                                             int j) {
  const int nw = (t.nv + 31) >> 5;
  float v = 0.0f;
  if (bit_at(t.rel_bits, i, j, nw)) {
    const bool ij = bit_at(t.anc_bits, i, j, nw);
    const int jj = ij ? j : i, ii = ij ? i : j;
    v = dot_in_order(v, s.cdof + 6 * jj, s.f + 6 * ii, 6);
  }
  if (i == j) v = v + t.armature[i];
  return v;
}

// x[par] += x[b] for the bodies b in reverse tree order, n floats per
// body: each lane takes entries r, r + 32, ... and walks every body, so
// each entry sums in the tree order of the thread chain
__device__ __forceinline__ void mc_subtree_sums(const MassChainTables& t,
                                                float* x, int n, int lane) {
  MWT_SHARED(x);
  for (int r = lane; r < n; r += 32)
    for (int k = t.nb - 2; k >= 0; --k) {
      const int b = t.topo[k], par = t.body_parent[b];
      x[n * par + r] = x[n * par + r] + x[n * b + r];
    }
  __syncwarp();
}

// x[6 b + k] = x[6 par + k] + v[6 i + k] qvel[i] over b's dofs i in
// order, level by level; lanes over (body of the level, k)
__device__ __forceinline__ void mc_levels(const MassChainTables& t,
                                          const float* v, const float* qvel,
                                          float* x, int lane) {
  MWT_SHARED(x);
  for (int lv = 0; lv < t.nlevel; ++lv) {
    const int a0 = t.level_adr[lv], n = 6 * (t.level_adr[lv + 1] - a0);
    for (int e = lane; e < n; e += 32) {
      const int q = e / 6, k = e - 6 * q;
      const int b = t.topo[a0 + q], d0 = t.body_dofadr[b];
      float acc = x[6 * t.body_parent[b] + k];
      for (int i = d0; i < d0 + t.body_dofnum[b]; ++i)
        acc = acc + v[6 * i + k] * qvel[i];
      x[6 * b + k] = acc;
    }
    __syncwarp();
  }
}

// The chain's first half, crb -> qM, of one world by its warp's lanes,
// called by all 32 together: with s.qM null, qM goes world-major to qMg
// (nv nv floats, the entries consecutive over the lanes), else into s.qM
// (and its lower triangle into a separate s.L).
__device__ __forceinline__ void mass_chain_qm(const MassChainTables& t,
                                              const MassChainSmem& s,
                                              float* qMg, int lane) {
  const int nb = t.nb, nv = t.nv;
  // ---- crb: cinert summed over each subtree
  for (int r = lane; r < 36 * nb; r += 32) s.crb[r] = s.cinert[r];
  __syncwarp();
  mc_subtree_sums(t, s.crb, 36, lane);
  // ---- f = crb cdof, lanes over (dof, row)
  for (int e = lane; e < 6 * nv; e += 32) {
    const int i = e / 6, r = e - 6 * i;
    s.f[e] = dot_in_order(0.0f, s.crb + 36 * t.dof_bodyid[i] + 6 * r,
                          s.cdof + 6 * i, 6);
  }
  __syncwarp();
  // ---- qM (+ armature), and its lower triangle for the factor
  if (s.qM == nullptr) {
    for (int e = lane; e < nv * nv; e += 32) {
      const int i = e / nv;
      qMg[e] = mc_qm_entry(t, s, i, e - i * nv);
    }
  } else {
    // lanes over the packed lower triangle; (i, j) of packed index p
    // = i (i + 1) / 2 + j, j <= i; the entry mirrored above the diagonal
    const int ld = chol_stride(nv);
    int i = 0, j = lane;
    while (j > i) j -= ++i;
    while (i < nv) {
      const float v = mc_qm_entry(t, s, i, j);
      s.qM[i * s.qld + j] = v;
      s.qM[j * s.qld + i] = v;
      if (s.L && s.L != s.qM) s.L[i * ld + j] = v;
      j += 32;
      while (j > i) j -= ++i;
    }
  }
  __syncwarp();
}

// The chain's second half, [factor] -> com_vel -> cdof_dot -> RNE bias,
// after mass_chain_qm (and whatever the caller does with qM between the
// two): s.L's lower triangle is factored in place when s.L is set.
__device__ __forceinline__ void mass_chain_rne(const MassChainTables& t,
                                               const MassChainSmem& s,
                                               int lane) {
  const int nb = t.nb, nv = t.nv;
  if (s.L) chol_warp<MWT_MAX_NV>(s.L, nv, AtStrided{chol_stride(nv)}, lane);

  // ---- com_vel: cvel[b] = cvel[parent] + cdof qvel over b's dofs
  if (lane < 6) s.cvel[lane] = 0.0f;
  __syncwarp();
  mc_levels(t, s.cdof, s.qvel, s.cvel, lane);
  // ---- cdof_dot: the velocity of the feeding dofs (in dof order)
  // crossed with cdof
  const int nw = (nv + 31) >> 5;
  for (int i = lane; i < nv; i += 32) {
    float vb[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool any = false;
    for (int q = 0; q < nw; ++q)
      for (unsigned bits = t.cdofdot_bits[i * nw + q]; bits;
           bits &= bits - 1) {
        const int j = 32 * q + __ffs(bits) - 1;
        const float qv = s.qvel[j];
        for (int k = 0; k < 6; ++k) {
          const float tv = s.cdof[6 * j + k] * qv;
          vb[k] = any ? vb[k] + tv : tv;
        }
        any = true;
      }
    const float* u = s.cdof + 6 * i;
    float out[6], t1[3], t2[3];
    cross3(vb, u, out);
    cross3(vb + 3, u, t1);
    cross3(vb, u + 3, t2);
    for (int k = 0; k < 3; ++k) out[3 + k] = t1[k] + t2[k];
    for (int k = 0; k < 6; ++k) s.cdotd[6 * i + k] = out[k];
  }
  // ---- RNE: cacc by level, cfrc by body, then summed over each subtree
  float* cacc = s.crb;
  float* cfrc = s.crb + 6 * nb;
  if (lane < 6) {
    cacc[lane] = (lane < 3 || t.no_gravity) ? 0.0f : -t.gravity[lane - 3];
    cfrc[lane] = 0.0f;
  }
  __syncwarp();
  mc_levels(t, s.cdotd, s.qvel, cacc, lane);
  for (int n = lane; n < nb - 1; n += 32) {
    const int bd = t.topo[n];
    const float* ci = s.cinert + 36 * bd;
    const float* cv = s.cvel + 6 * bd;
    const float* acc = cacc + 6 * bd;
    float iv[6], ia[6];
    for (int r = 0; r < 6; ++r) {
      iv[r] = dot_in_order(0.0f, ci + 6 * r, cv, 6);
      ia[r] = dot_in_order(0.0f, ci + 6 * r, acc, 6);
    }
    float a1[3], a2[3], a3[3];
    cross3(cv, iv, a1);
    cross3(cv + 3, iv + 3, a2);
    cross3(cv, iv + 3, a3);
    for (int k = 0; k < 3; ++k) {
      cfrc[6 * bd + k] = ia[k] + (a1[k] + a2[k]);
      cfrc[6 * bd + 3 + k] = ia[3 + k] + a3[k];
    }
  }
  __syncwarp();
  mc_subtree_sums(t, cfrc, 6, lane);
  for (int i = lane; i < nv; i += 32)
    s.bias[i] = dot_in_order(0.0f, cfrc + 6 * t.dof_bodyid[i],
                             s.cdof + 6 * i, 6);
  __syncwarp();
}
