"""The contact rows and the large-system Newton of the port against the
JAX package on clutter_arm_nosleep (nefc 732, nv 75: nefc * nv 54,900,
beyond the Pallas solver's 12,000), at 32 worlds of the contact-rich
state, on the CPU.

- Rows: efc_J, efc_D, efc_aref, efc_pos and efc_margin of
  ``constraint.make_constraint`` after ``collision`` against JAX
  ``make_constraint(collision(.))`` under ``vmap``, each within 1e-4 of
  its largest magnitude (the frame-projected Jacobian and the impedance
  in float32, summed in another order: they agree to 4e-6 relative), and
  the same active rows.
- Newton: ``ops/solver.solve`` against JAX ``ops/solver.solve`` under
  ``vmap`` on the same rows, mass matrix and warmstart (the JAX side
  factors H with LAPACK on a CPU, the port with its lane Cholesky): qacc,
  qfrc_constraint and efc_force at the K4 bars of ``parity`` (1e-4 +
  1e-3 of each world's scale), Newton counts at its 'contact' bar.  The
  state needs 5-9 Newton iterations per world.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_warp_tpu.ops import collision_driver as jcd
from mujoco_warp_tpu.ops import constraint as jcon
from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu.ops import solver as jsolver
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import collision_driver, constraint, forward
from mujoco_warp_tpu_torch.ops import solver as osolver
from tests.test_torch_clutter_io import states
from tests.torch_threads import few_threads  # noqa: F401

W = 32
ROWS = ('efc_J', 'efc_D', 'efc_aref', 'efc_pos', 'efc_margin')


@functools.lru_cache(maxsize=None)
def rows():
  mj, m, dj, d = states(W, 3)
  dj = jax.jit(jax.vmap(lambda x: jcon.make_constraint(mj, jcd.collision(
      mj, jsmooth.com_pos(mj, jsmooth.kinematics(mj, x))))))(dj)
  d = forward.pre(m, d)
  return mj, m, dj, d, constraint.make_constraint(
      m, collision_driver.collision(m, d))


def test_contact_rows_match_jax():
  _, m, dj, _, d = rows()
  active = d.efc_active.numpy()
  np.testing.assert_array_equal(active, np.asarray(dj.efc_active))
  assert active.sum(axis=1).min() >= 100
  for name in ROWS:
    want = np.asarray(getattr(dj, name))
    np.testing.assert_allclose(
        getattr(d, name).numpy(), want, rtol=0.0,
        atol=1e-4 * max(1.0, float(np.abs(want).max())), err_msg=name)


def test_newton_matches_jax_solve():
  mj, m, dj, d0, _ = rows()
  d = forward.mid(m, kmass.mass_chain(m, d0))
  ws = 0.1 * np.random.default_rng(6).standard_normal((W, m.nv))
  d = d.replace(
      qacc_smooth=klinalg.chol_solve_batched(m, d.qLD, d.qfrc_smooth),
      qacc_warmstart=torch.as_tensor(ws, dtype=torch.float32))
  inputs = ('qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss',
            'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')
  dj = dj.replace(**{k: jnp.asarray(getattr(d, k).numpy()) for k in inputs})
  want = jax.jit(jax.vmap(lambda x: jsolver.solve(mj, x)))(dj)
  trips = osolver.trips
  got = osolver.solve(m, d)
  niter = got.solver_niter.numpy()
  assert osolver.trips - trips == niter.max() and niter.min() > 1
  for name in ('qacc', 'qfrc_constraint', 'efc_force'):
    parity.check_world_scale(getattr(got, name).T,
                             np.asarray(getattr(want, name)).T, name)
  parity.check_niter(niter, np.asarray(want.solver_niter), 'contact')
  assert int(got.overflow.max()) == 0
