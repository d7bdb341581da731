"""The plain versions of the general step's Cholesky-solve kernels
against the JAX Pallas kernels in interpret mode, at 128 worlds and nv 13
(the constraints scene's mass matrices at the parity state).

``chol_solve_batched`` (x = (L L^T)^-1 b) and ``damped_solve_batched``
((M + h diag(damping))^-1 M qacc) call the JAX functions directly.  Each
takes its operands in the two layouts the kernels read in place: world-
major, and a ``world()`` view of lanes-last (``layout``); the JAX
reference is computed once for both.  Bar: atol 1e-5 + rtol 1e-4 of each
world's largest |x| (the same lane Cholesky and substitutions, summed in
another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu.pallas import linalg as plinalg
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.fused import k4_ref
from mujoco_warp_tpu_torch.kernels import lanes, world
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_smooth import states


@functools.lru_cache(maxsize=None)
def mass_matrices():
  mj, m, dj, d = states(128, 2)
  d = kmass.mass_chain(m, forward.pre(m, d))
  rng = np.random.default_rng(3)
  b = rng.standard_normal((128, m.nv)).astype(np.float32)
  return mj, m, d, b


def layout(x, kind):
  """World-major (W, ...) x, contiguous ('world') or as a ``world()``
  view of its lanes-last copy ('lanes')."""
  if kind == 'world':
    return x.contiguous()
  return world(lanes(x, int(np.prod(x.shape[1:]))), *x.shape[1:])


@functools.lru_cache(maxsize=None)
def pallas_chol_solve():
  mj, m, d, b = mass_matrices()
  return plinalg.chol_solve_batched(mj, jnp.asarray(d.qLD.numpy()),
                                    jnp.asarray(b), interpret=True)


@functools.lru_cache(maxsize=None)
def pallas_damped_solve():
  mj, m, d, b = mass_matrices()
  return plinalg.damped_solve_batched(
      mj, jnp.asarray(d.qM.numpy()), mj.dof_damping, mj.opt.timestep,
      jnp.asarray(b), interpret=True)


def check(got, want, name):
  parity.check_world_scale(got.T, np.asarray(want).T, name,
                           parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.parametrize('kind', ['world', 'lanes'])
def test_chol_solve_matches_pallas_interpret(kind):
  _, m, d, b = mass_matrices()
  n = klinalg.launches['chol_solve']
  got = klinalg.chol_solve_batched(m, layout(d.qLD, kind),
                                   layout(torch.as_tensor(b), kind))
  assert klinalg.launches['chol_solve'] == n
  check(got, pallas_chol_solve(), 'chol_solve')


@pytest.mark.parametrize('kind', ['world', 'lanes'])
def test_damped_solve_matches_pallas_interpret(kind):
  _, m, d, b = mass_matrices()
  assert k4_ref.damped(m)
  got = klinalg.damped_solve_batched(m, layout(d.qM, kind),
                                     layout(torch.as_tensor(b), kind))
  check(got, pallas_damped_solve(), 'damped_solve')
