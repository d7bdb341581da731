"""The port's plain Newton solve of the general step against the JAX
standalone solver, and K4's plain solve unchanged by friction rows.

``solver_ref.solve_batched`` (the plain counterpart of the solver kernel,
with friction-loss rows) is held against
``psolver.solve_batched(m, d, interpret=True)`` on the state
``tests/test_pallas_solver.py`` builds for ``constraints.xml`` (3 connect,
1 joint and 6 weld equality rows, 2 friction-loss rows, 2 joint limits),
broadcast to 128 worlds with 0.02 N velocity noise.  Bars: those of that
test (qacc atol/rtol 5e-3, qfrc_constraint 5e-2) and the 'constraints'
Newton-count bars of ``mujoco_warp_tpu_torch.parity`` (why that scene has
its own share is written there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import models
from mujoco_warp_tpu.ops import forward as fwd
from mujoco_warp_tpu.pallas import solver as psolver
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.kernels import solver as ksolver
from tests.oracle import assert_close
from tests.torch_threads import few_threads  # noqa: F401

_FIELDS = ('efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qM',
           'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')


def jax_state(seed):
  """The JAX Data of the constraints fixture at 128 worlds, after the
  stages before the solve."""
  mjm, _, mj, d = models.fixture('constraints.xml', qpos_noise=0.3,
                                 qvel_noise=0.5, nstep=3)
  W = psolver.TILE_W
  db = jax.tree.map(lambda x: jnp.broadcast_to(x, (W,) + x.shape), d)
  rng = np.random.default_rng(seed)
  db = db.replace(qvel=db.qvel + 0.02 * jnp.asarray(
      rng.standard_normal((W, mjm.nv)).astype(np.float32)))
  pre = jax.jit(jax.vmap(lambda x: fwd.fwd_acceleration(mj, fwd.fwd_actuation(
      mj, fwd.fwd_velocity(mj, fwd.fwd_position(mj, x))))))
  return mjm, mj, jax.block_until_ready(pre(db))


@pytest.mark.parametrize('seed', [0, 1])
def test_solve_batched_matches_jax(seed):
  mjm, mj, db = jax_state(seed)
  m = tio.put_model(mjm, device='cpu')
  assert (m.ne, m.nf, m.nl, m.nefc) == (10, 2, 2, 14)
  W = db.qpos.shape[0]
  d = types.Data(qpos=torch.as_tensor(np.array(db.qpos)),
                 overflow=torch.zeros(W, dtype=torch.int32),
                 **{k: torch.as_tensor(np.array(getattr(db, k)))
                    for k in _FIELDS})
  assert float(d.efc_frictionloss.abs().max()) > 0
  n = ksolver.launches
  out = ksolver.solve_batched(m, d)  # CPU tensors: the plain version
  assert ksolver.launches == n
  ref = jax.jit(lambda dd: psolver.solve_batched(mj, dd, interpret=True))(db)
  assert_close(out.qacc.numpy(), np.asarray(ref.qacc), 'qacc', atol=5e-3,
               rtol=5e-3)
  assert_close(out.qfrc_constraint.numpy(), np.asarray(ref.qfrc_constraint),
               'qfrc_constraint', atol=5e-2, rtol=5e-2)
  assert_close(out.efc_force.numpy(), np.asarray(ref.efc_force),
               'efc_force', atol=5e-2, rtol=5e-2)
  parity.check_niter(out.solver_niter, np.asarray(ref.solver_niter),
                     'constraints')
  np.testing.assert_array_equal(out.overflow.numpy(),
                                np.asarray(ref.overflow))


def test_friction_rows_leave_frictionless_solves_unchanged():
  """With no friction-loss row marked, solve_core is K4's solve: passing
  w_fri=None or a zero mask gives the same iterates bit for bit."""
  mjm, mj, db = jax_state(0)
  m = tio.put_model(mjm, device='cpu')
  lanes = lambda k: torch.as_tensor(np.moveaxis(
      np.asarray(getattr(db, k)), 0, -1).copy())
  J, D, aref, M = lanes('efc_J'), lanes('efc_D'), lanes('efc_aref'), \
      lanes('qM')
  w_eq, _ = solver_ref.row_weights(m, 'cpu')
  tol, ls_tol, mi = solver_ref.scalars(m, 'cpu')
  args = (m, J, D, aref, M, lanes('qfrc_smooth'), lanes('qacc_warmstart'),
          w_eq, tol, ls_tol, mi)
  a = solver_ref.solve_core(*args)
  b = solver_ref.solve_core(*args, w_fri=torch.zeros_like(w_eq),
                            fl=lanes('efc_frictionloss'))
  for x, y in zip(a, b):
    assert torch.equal(x, y)
