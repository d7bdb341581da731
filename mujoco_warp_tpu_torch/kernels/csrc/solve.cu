// The standalone Newton solver kernel of the general step, one thread per
// world, over an assembled dense EFC system: equality, friction-loss and
// inequality (limit, pyramidal and frictionless contact) rows.
//
// Replaces the Pallas kernel mujoco_warp_tpu/pallas/solver.py
// _make_kernel (:1041, launched by _solve_tiles :1126 from solve_batched
// :1145) for pyramidal and frictionless rows; elliptic cones (_ell_perm
// :70) are not ported.  The Newton loop, the linesearch and the factor
// reuse are newton.cuh, shared with K4.
//
// Bound.  Per world it reads J (nefc nv), D, aref, fl (nefc each), M
// (nv^2) and two nv vectors, and writes qacc, qfrc_constraint (nv each),
// efc_force (nefc) and niter: at the constraints scene (nefc 14, nv 13)
// 1.7 KB per world, 14 MB at 8192 worlds (4 us at 3.35 TB/s).  Each
// Newton iteration costs ~nefc nv^2 / 2 flops for H and ~nv^3 / 3 for its
// factor when a row flips, a few thousand flops per world; with one
// thread per world the kernel is latency-bound by its dependent chain of
// scratch accesses, like K4.

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
  float* scr;          // (3 nefc + nv nv, W): jaref, jv, quad, L
  const int* kind;     // (nefc,) ROW_INEQ, ROW_EQ or ROW_FRI
};

// dense rows read from the inputs, per-world slots in scratch
struct SolveRows {
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
  // H = M + J^T diag(D quad) J on the lower triangle, factored in place
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
    for (int i = 0; i < nv; ++i)
      for (int k = 0; k <= i; ++k)
        LANE(Lb, i * nv + k) = LANE(p.M, i * nv + k) + LANE(Lb, i * nv + k);
    chol_lanes(Lb, Lb, nv, W, w);
  }
};

__global__ void __launch_bounds__(128) solve_kernel(const SolveParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = p.W;
  if (w >= W) return;
  const int nv = p.nv;
  const SolveRows R{p, W, w, p.nefc};
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

extern "C" {

int mwt_solve_params_size() { return (int)sizeof(SolveParams); }

int mwt_solve_scratch_rows(int nefc, int nv) { return 3 * nefc + nv * nv; }

// Launches the solve on `stream`; returns cudaGetLastError() of the launch.
int mwt_solve_launch(const SolveParams* p, void* stream) {
  const int threads = 128;
  const int blocks = (p->W + threads - 1) / threads;
  solve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
