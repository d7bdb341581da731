// The standalone mass-chain kernel of the general step: crb -> qM +
// armature -> Cholesky (qLD) -> com_vel (cvel) -> cdof_dot -> RNE bias,
// one thread per world, from the cinert and cdof of the position stages.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/smooth.py _make_kernel
// (:211, launched by mass_chain :286) in both its forms: the small tree
// (nv <= 48 and nbody <= 32) with its factor, and the large tree, whose
// qM the Pallas kernel builds with the ancm selector (the same entries
// as the ancestor walk here) and factors apart (pallas/linalg.py
// chol_batched, linalg.cu here): the wrapper passes qLD = null and the
// factor is skipped.  The per-world chain is mass_chain.cuh, shared with
// K1; no per-thread array grows with nv or nbody.
//
// Bound.  Per world it reads 36 nbody + 7 nv floats and writes 2 nv^2 +
// 6 nbody + 7 nv (nv^2 without the factor): 6.6 KB at the constraints
// scene (nv 13, nbody 7; 54 MB at 8192 worlds, 16 us at 3.35 TB/s) and
// 25 KB at clutter_arm (nv 75, nbody 16; 101 MB at 4096 worlds, 30 us);
// the flops (~nv^3 / 3 for the factor plus ~100 nbody + 12 nv^2) are far
// below the card's rate.  With one thread per world the kernel is
// latency-bound by each thread's chain of dependent scratch accesses.

#include "mass_chain.cuh"

struct MassChainParams {
  int W, nb, nv, no_gravity;
  const float* cinert;  // (36 nbody, W)
  const float* cdof;    // (6 nv, W)
  const float* qvel;    // (nv, W)
  float* qM;            // (nv nv, W)
  float* qLD;           // (nv nv, W)
  float* cvel;          // (6 nbody, W)
  float* cdof_dot;      // (6 nv, W)
  float* bias;          // (nv, W)
  float* scr;           // (mwt_mass_chain_scratch_rows, W)
  const int* topo;
  const int* body_parent;
  const int* body_dofadr;
  const int* body_dofnum;
  const int* dof_bodyid;
  const int* ancestor;
  const int* cdofdot;
  const float* armature;
  const float* gravity;
};

// scratch rows: crb 36 nb | f 6 nv | cacc 6 nb | cfrc 6 nb
static __host__ __device__ int mc_scratch_rows(int nb, int nv) {
  return 48 * nb + 6 * nv;
}

__global__ void __launch_bounds__(128) mass_chain_kernel(
    const MassChainParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  const int nb = p.nb, nv = p.nv;
  float* S = p.scr;
  const MassChainTables mt{nb, nv, p.no_gravity, p.topo, p.body_parent,
                           p.body_dofadr, p.body_dofnum, p.dof_bodyid,
                           p.ancestor, p.cdofdot, p.armature, p.gravity};
  const MassChainBufs mb{p.cinert, p.cdof, p.qvel, S,
                         S + (size_t)(36 * nb) * W,
                         p.cvel, p.cdof_dot,
                         S + (size_t)(36 * nb + 6 * nv) * W,
                         S + (size_t)(42 * nb + 6 * nv) * W,
                         p.qM, p.qLD, p.bias};
  mass_chain_world(mt, mb, W, w);
}

extern "C" {

int mwt_mass_chain_params_size() { return (int)sizeof(MassChainParams); }

int mwt_mass_chain_scratch_rows(int nb, int nv) {
  return mc_scratch_rows(nb, nv);
}

// Launches the mass chain on `stream`; returns cudaGetLastError().
int mwt_mass_chain_launch(const MassChainParams* p, void* stream) {
  const int threads = 128;
  const int blocks = (p->W + threads - 1) / threads;
  mass_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
