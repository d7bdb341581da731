// The standalone mass-chain kernel of the general step: crb -> qM +
// armature -> Cholesky (qLD) -> com_vel (cvel) -> cdof_dot -> RNE bias,
// one warp per world, from the cinert and cdof of the position stages.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/smooth.py _make_kernel
// (:211, launched by mass_chain :286) in both its forms: the small tree
// (nv <= 48 and nbody <= 32) with its factor, and the large tree, whose
// qM the Pallas kernel builds with the ancm selector (the same entries
// as the ancestor walk here) and factors apart (pallas/linalg.py
// chol_batched, linalg.cu here).  The chain is mass_chain.cuh's, shared
// with K1.
//
// Bound.  Per world it reads 36 nbody + 7 nv floats and writes 2 nv^2 +
// 6 nbody + 7 nv (nv^2 without the factor): 6.6 KB at the constraints
// scene (nv 13, nbody 7; 54 MB at 8192 worlds, 16 us at 3.35 TB/s) and
// 25 KB at clutter_arm (nv 75, nbody 16; 101 MB at 4096 worlds, 30 us);
// the flops (~nv^3 / 3 for the factor plus ~100 nbody + 12 nv^2) are far
// below the card's rate.  What bounds it is each world's chain of
// dependent steps.
//
// Design.  Each world gets one warp, and a block 8 worlds where they fit
// (warp.cuh sector_worlds), so that the block reads and writes whole
// 32-byte sectors of each lanes-last row.  The block copies cinert, cdof
// and qvel into shared memory with cp.async, the world as the fastest
// thread index; the world's intermediates stay there (MassChainLayout),
// and its lanes run mass_chain_qm and mass_chain_rne (mass_chain.cuh).
// The small tree's qM is built at the factor's row stride; after a block
// barrier the block stores it lanes-last, the world as the fastest thread
// index, and after another the lanes factor it in place, so that qM and
// its factor share their floats (10.4 KB per world at nv 36, 2 blocks per
// SM); cvel, cdof_dot, bias and the factor are stored the same way at the
// end.  The large tree's qM (nv^2 floats, 22.5 KB at nv 75) is not
// staged: each warp writes its world's qM world-major, its lanes on
// consecutive entries, and chol_batched reads it there in place.
//
// Per-world parameters.  The armature and gravity are read where the
// Model holds them, at a world stride: nv and 3 for a model whose worlds
// carry their own (domain randomization), 0 for one set shared by every
// world.  Each warp offsets the two pointers by its world, so the chain
// itself (mass_chain.cuh, shared with K1, which passes stride 0) reads
// one world's values as before.

#include "mass_chain.cuh"

struct MassChainParams {
  int W, nb, nv, nlevel, no_gravity, small;
  int arm_ws, grav_ws;  // world strides of armature and gravity (0: shared)
  const float* cinert;  // (36 nbody, W)
  const float* cdof;    // (6 nv, W)
  const float* qvel;    // (nv, W)
  float* qM;            // small: (nv nv, W); large: (W, nv nv) world-major
  float* qLD;           // (nv nv, W), small tree only
  float* cvel;          // (6 nbody, W)
  float* cdof_dot;      // (6 nv, W)
  float* bias;          // (nv, W)
  const int* topo;
  const int* level_adr;
  const int* body_parent;
  const int* body_dofadr;
  const int* body_dofnum;
  const int* dof_bodyid;
  const unsigned* anc_bits;
  const unsigned* rel_bits;
  const unsigned* cdofdot_bits;
  const float* armature;  // (W or 1, nv)
  const float* gravity;   // (W or 1, 3)
};

// One world's shared floats: the inputs, the chain's intermediates, bias,
// and for the small tree qM, then its factor, at row stride
// chol_stride(nv); an odd total, so that the block's loads and stores,
// the world the fastest index, touch distinct banks.
struct MassChainLayout {
  int cinert, cdof, qvel, crb, f, cvel, cdotd, bias, M, total;
  __host__ __device__ MassChainLayout(int nb, int nv, bool small) {
    cinert = 0;
    cdof = cinert + 36 * nb;
    qvel = cdof + 6 * nv;
    crb = qvel + nv;
    f = crb + 36 * nb;
    cvel = f + 6 * nv;
    cdotd = cvel + 6 * nb;
    bias = cdotd + 6 * nv;
    M = bias + nv;
    total = (M + (small ? nv * chol_stride(nv) : 0)) | 1;
  }
};

__global__ void mass_chain_kernel(const MassChainParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.W, nb = p.nb, nv = p.nv;
  const bool small = p.small != 0;
  const MassChainLayout lay(nb, nv, small);
  const int wf = lay.total, ld = chol_stride(nv);
  const int w0 = blockIdx.x * (blockDim.x >> 5);
  const int nw = min((int)(blockDim.x >> 5), W - w0);
  // each input lanes-last: world stride 1, element stride W
  load_block(p.cinert, 1, W, w0, nw, 36 * nb, 36 * nb, false, AtVector{},
             smem + lay.cinert, wf);
  load_block(p.cdof, 1, W, w0, nw, 6 * nv, 6 * nv, false, AtVector{},
             smem + lay.cdof, wf);
  load_block(p.qvel, 1, W, w0, nw, nv, nv, false, AtVector{},
             smem + lay.qvel, wf);
  copies_done();
  float* b = smem + warp * wf;
  // this warp's world's armature and gravity (read only for warp < nw)
  const size_t w = (size_t)(w0 + warp);
  const MassChainTables t{nb, nv, p.nlevel, p.no_gravity, p.topo,
                          p.level_adr, p.body_parent, p.body_dofadr,
                          p.body_dofnum, p.dof_bodyid, p.anc_bits,
                          p.rel_bits, p.cdofdot_bits,
                          p.armature + w * p.arm_ws,
                          p.gravity + w * p.grav_ws};
  const MassChainSmem s{b + lay.cinert, b + lay.cdof, b + lay.qvel,
                        b + lay.crb, b + lay.f, b + lay.cvel, b + lay.cdotd,
                        small ? b + lay.M : nullptr, ld,
                        small ? b + lay.M : nullptr, b + lay.bias};
  if (warp < nw)
    mass_chain_qm(t, s, p.qM + (size_t)(w0 + warp) * nv * nv, lane);
  if (small) {  // qM lanes-last, before the factor takes its floats
    __syncthreads();
    store_block_matrix(p.qM, W, w0, nw, nv, smem + lay.M, ld, wf, false);
    __syncthreads();
  }
  if (warp < nw) mass_chain_rne(t, s, lane);
  __syncthreads();
  // the outputs lanes-last, the world as the fastest thread index
  store_block(p.cvel, W, w0, nw, 6 * nb, smem + lay.cvel, wf);
  store_block(p.cdof_dot, W, w0, nw, 6 * nv, smem + lay.cdotd, wf);
  store_block(p.bias, W, w0, nw, nv, smem + lay.bias, wf);
  if (small)
    store_block_matrix(p.qLD, W, w0, nw, nv, smem + lay.M, ld, wf, true);
}

// shared bytes per world and worlds per block for p's sizes
static void mass_chain_config(const MassChainParams* p, size_t* per_world,
                              int* wpb) {
  *per_world = (size_t)MassChainLayout(p->nb, p->nv, p->small != 0).total *
               sizeof(float);
  *wpb = sector_worlds(*per_world);
}

extern "C" {

int mwt_mass_chain_params_size() { return (int)sizeof(MassChainParams); }

// shared floats of one world
int mwt_mass_chain_world_floats(int nb, int nv, int small) {
  return MassChainLayout(nb, nv, small != 0).total;
}

// Launches the mass chain on `stream`; returns cudaGetLastError().
int mwt_mass_chain_launch(const MassChainParams* p, void* stream) {
  size_t per_world;
  int wpb;
  mass_chain_config(p, &per_world, &wpb);
  return launch_worlds(mass_chain_kernel, p, p->W, wpb, per_world, stream);
}

// the kernel's registers per thread, worlds per block and shared bytes per
// block for p's sizes, into out[0..2]
int mwt_mass_chain_info(const MassChainParams* p, int* out) {
  size_t per_world;
  int wpb;
  mass_chain_config(p, &per_world, &wpb);
  return kernel_info(mass_chain_kernel, wpb, per_world, out);
}

}  // extern "C"
