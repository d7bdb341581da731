"""The plain versions of the general step's Cholesky-solve kernels
against the JAX Pallas kernels in interpret mode, at 128 worlds and nv 13
(the constraints scene's mass matrices at the parity state).

``chol_solve_batched`` (x = (L L^T)^-1 b) and ``damped_solve_batched``
((M + h diag(damping))^-1 M qacc) call the JAX functions directly.  Bar:
atol 1e-5 + rtol 1e-4 of each world's largest |x| (the same lane Cholesky
and substitutions, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import torch

from mujoco_warp_tpu.pallas import linalg as plinalg
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.fused import k4_ref
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_smooth import states


def mass_matrices():
  mj, m, dj, d = states(128, 2)
  d = kmass.mass_chain(m, forward.pre(m, d))
  rng = np.random.default_rng(3)
  b = rng.standard_normal((128, m.nv)).astype(np.float32)
  return mj, m, d, b


def check(got, want, name):
  parity.check_world_scale(got.T, np.asarray(want).T, name,
                           parity.SOLVE_ATOL, parity.SOLVE_RTOL)


def test_chol_solve_matches_pallas_interpret():
  mj, m, d, b = mass_matrices()
  n = klinalg.launches['chol_solve']
  got = klinalg.chol_solve_batched(m, d.qLD, torch.as_tensor(b))
  assert klinalg.launches['chol_solve'] == n
  want = plinalg.chol_solve_batched(mj, jnp.asarray(d.qLD.numpy()),
                                    jnp.asarray(b), interpret=True)
  check(got, want, 'chol_solve')


def test_damped_solve_matches_pallas_interpret():
  mj, m, d, b = mass_matrices()
  assert k4_ref.damped(m)
  got = klinalg.damped_solve_batched(m, d.qM, torch.as_tensor(b))
  want = plinalg.damped_solve_batched(
      mj, jnp.asarray(d.qM.numpy()), mj.dof_damping, mj.opt.timestep,
      jnp.asarray(b), interpret=True)
  check(got, want, 'damped_solve')
