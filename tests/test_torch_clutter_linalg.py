"""The large-tree kernels' plain versions against the JAX Pallas kernels in
interpret mode, at 128 worlds.

- ``chol_batched`` (L L^T = A + jitter I) at n 75 (the Pallas loop form,
  ``_chol_big``) and n 27 (the unrolled form, ``_chol_tile``), jitter
  1e-12 (the mass factor) and 1e-15 (the Newton H), on seeded SPD
  matrices.  Bar: atol 1e-5 + rtol 1e-4 of each world's largest |L| (the
  same right-looking updates; XLA may fuse a product and a difference).
- ``chol_solve`` and ``damped_solve`` at n 75 on clutter_arm's mass
  matrices, each operand in the layouts of ``test_torch_linalg.layout``
  (world-major, a ``world()`` view of lanes-last, every other world of
  a wider tensor): the same bar on x.
- The big-tree mass chain (``ancm`` qM, then ``chol_batched`` for qLD)
  against ``psmooth.mass_chain(m, d, interpret=True)`` on the contact-
  rich clutter state: qM, qLD, cvel, cdof_dot and qfrc_bias within 1e-4
  of each output's largest magnitude, as the constraints scene's test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu.pallas import linalg as plinalg
from mujoco_warp_tpu.pallas import smooth as psmooth
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward, smooth
from tests.test_torch_clutter_io import states
from tests.test_torch_linalg import LAYOUTS, layout
from tests.torch_threads import few_threads  # noqa: F401

W = 128


def spd(n, seed):
  """128 seeded SPD matrices G G^T / n + 0.1 I, float32."""
  g = np.random.default_rng(seed).standard_normal((W, n, n))
  a = g @ g.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
  return a.astype(np.float32)


def world_scale(got, want, name):
  """(W, ...) outputs within atol + rtol of each world's largest |want|."""
  w = lambda x: np.asarray(x).reshape(W, -1).T
  parity.check_world_scale(w(got), w(want), name, parity.SOLVE_ATOL,
                           parity.SOLVE_RTOL)


@pytest.mark.parametrize('n', [75, 27])
@pytest.mark.parametrize('jitter', [1e-12, 1e-15])
def test_chol_batched_matches_pallas_interpret(n, jitter):
  mj = states(W, 0)[0]
  A = spd(n, n)
  launches = klinalg.launches['chol_batched']
  got = klinalg.chol_batched(None, torch.as_tensor(A), jitter=jitter)
  assert klinalg.launches['chol_batched'] == launches  # the plain version
  want = plinalg.chol_batched(mj, jnp.asarray(A), jitter=jitter,
                              interpret=True)
  assert np.all(np.triu(got.numpy(), 1) == 0.0)
  world_scale(got.numpy(), want, f'L (n {n}, jitter {jitter})')


@functools.lru_cache(maxsize=None)
def mass_chains():
  mj, m, dj, d = states(W, 2)
  dj = jax.jit(jax.vmap(lambda x: jsmooth.com_pos(
      mj, jsmooth.kinematics(mj, x))))(dj)
  dj = psmooth.mass_chain(mj, dj, interpret=True)
  n = kmass.launches
  d = kmass.mass_chain(m, smooth.com_pos(m, smooth.kinematics(m, d)))
  assert kmass.launches == n
  return mj, m, dj, d


def test_big_tree_mass_chain_matches_pallas_interpret():
  mj, m, dj, d = mass_chains()
  assert kmass.big_tree(m) and psmooth._big_tree(mj)
  for name in ('qM', 'qLD', 'cvel', 'cdof_dot', 'qfrc_bias'):
    want = np.asarray(getattr(dj, name))
    np.testing.assert_allclose(
        getattr(d, name).numpy(), want, rtol=0.0,
        atol=1e-4 * max(1.0, float(np.abs(want).max())), err_msg=name)


@functools.lru_cache(maxsize=None)
def chol_solve_n75():
  """(b, the Pallas x) on mass_chains()'s qLD, once for both layouts."""
  mj, m, _, d = mass_chains()
  b = np.random.default_rng(4).standard_normal((W, m.nv)).astype(np.float32)
  return b, plinalg.chol_solve_batched(mj, jnp.asarray(d.qLD.numpy()),
                                       jnp.asarray(b), interpret=True)


@functools.lru_cache(maxsize=None)
def damped_solve_n75():
  """(qacc, the Pallas x) on mass_chains()'s qM, once for both layouts."""
  mj, m, _, d = mass_chains()
  a = np.random.default_rng(5).standard_normal((W, m.nv)).astype(np.float32)
  return a, plinalg.damped_solve_batched(
      mj, jnp.asarray(d.qM.numpy()), mj.dof_damping, mj.opt.timestep,
      jnp.asarray(a), interpret=True)


@pytest.mark.parametrize('kind', LAYOUTS)
def test_chol_solve_n75_matches_pallas_interpret(kind):
  _, m, _, d = mass_chains()
  b, want = chol_solve_n75()
  got = klinalg.chol_solve_batched(m, layout(d.qLD, kind),
                                   layout(torch.as_tensor(b), kind))
  world_scale(got.numpy(), want, 'chol_solve n 75')


@pytest.mark.parametrize('kind', LAYOUTS)
def test_damped_solve_n75_matches_pallas_interpret(kind):
  _, m, _, d = mass_chains()
  a, want = damped_solve_n75()
  got = klinalg.damped_solve_batched(m, layout(d.qM, kind),
                                     layout(torch.as_tensor(a), kind))
  world_scale(got.numpy(), want, 'damped_solve n 75')
