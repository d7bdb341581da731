"""The port's plain Newton solve on the spheres scenes against the JAX
standalone solver kernel, pyramidal and elliptic cones.

``solver_ref.solve_batched`` (the plain counterpart of the solve kernel;
for elliptic cones the zones, cone blocks and per-contact linesearch
segments of ``pallas/solver.py`` ``solve_core``) is held against
``psolver.solve_batched(m, d, interpret=True)`` on the same assembled
system: the seeded contact state of ``parity.spheres_state`` at 128
worlds, through the JAX package's stages before the solve.  Bars: those
of ``tests/test_torch_solver.py`` (qacc atol/rtol 5e-3, efc_force and
qfrc_constraint 5e-2) and the 'elliptic' Newton-count bars of
``mujoco_warp_tpu_torch.parity`` (measured there on this state).  With
elliptic cones the state must hold live contacts in each of the three
zones at the solution (top: lifting off, no force; middle: sliding on
the cone; bottom: sticking inside it), or a kernel with wrong cone
blocks could pass.

A float64 run of the same plain solve arbitrates qacc in at most
``MAX_ARBITRATED`` world of each 128 with elliptic cones, and in none
with pyramidal cones: in 1 of 128 worlds in seeds 0, 2 and 5 of 0-5 the
two float32 solves stop after the same Newton count on different
linesearch paths (a contact on a zone edge) and the port's qacc misses
the JAX kernel's by up to 0.053, while it lies within 6e-5-3.3e-3 of the
float64 solve and the JAX kernel's 0.011-0.052 from it.  In such a world
the Newton counts must be equal, and the port must meet the same qacc
bar against the float64 solve and be the closer of the two; any other
world that misses the JAX kernel's qacc fails.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu.pallas import solver as psolver
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.kernels import lanes
from mujoco_warp_tpu_torch.kernels import solver as ksolver
from tests.oracle import assert_close
from tests.test_torch_spheres_io import CONES, models, states
from tests.torch_threads import few_threads  # noqa: F401

# worlds of 128 whose qacc the float64 solve may arbitrate, per cone
MAX_ARBITRATED = {types.ConeType.PYRAMIDAL: 0, types.ConeType.ELLIPTIC: 1}
_FIELDS = ('efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qM',
           'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')


@functools.lru_cache(maxsize=None)
def jax_fns(scene):
  mj, _ = models(scene)
  pre = jax.jit(jax.vmap(lambda x: jfwd.fwd_acceleration(mj, jfwd.fwd_actuation(
      mj, jfwd.fwd_velocity(mj, jfwd.fwd_position(mj, x))))))
  solve = jax.jit(lambda dd: psolver.solve_batched(mj, dd, interpret=True))
  return pre, solve


def solve64(m, d):
  """The plain solve of d's system in float64."""
  d64 = d.replace(contact=types.Contact(friction=d.contact.friction.double()),
                  **{k: getattr(d, k).double() for k in _FIELDS})
  scalars = solver_ref.scalars
  try:
    solver_ref.scalars = lambda m, dev: [x.double() for x in scalars(m, dev)]
    return solver_ref.solve_batched(m, d64)
  finally:
    solver_ref.scalars = scalars


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('scene', sorted(CONES))
def test_spheres_solve_matches_jax(scene, seed):
  _, m, dj, _ = states(scene, psolver.TILE_W, seed)
  pre, solve = jax_fns(scene)
  db = pre(dj)
  W = db.qpos.shape[0]
  d = types.Data(
      qpos=torch.as_tensor(np.array(db.qpos)),
      overflow=torch.zeros(W, dtype=torch.int32),
      contact=types.Contact(
          friction=torch.as_tensor(np.array(db.contact.friction))),
      **{k: torch.as_tensor(np.array(getattr(db, k))) for k in _FIELDS})
  n = ksolver.launches
  out = ksolver.solve_batched(m, d)  # CPU tensors: the plain version
  assert ksolver.launches == n
  ref = solve(db)
  got, want = out.qacc.numpy(), np.asarray(ref.qacc)
  off = (np.abs(got - want) > 5e-3 + 5e-3 * np.abs(want)).any(axis=1)
  assert off.sum() <= MAX_ARBITRATED[CONES[scene]], (
      f'qacc misses the JAX kernel in {int(off.sum())} worlds')
  if off.any():
    np.testing.assert_array_equal(out.solver_niter.numpy()[off],
                                  np.asarray(ref.solver_niter)[off])
    exact = solve64(m, d).qacc.numpy()[off]
    assert_close(got[off], exact, 'qacc (float64 solve)', atol=5e-3,
                 rtol=5e-3)
    assert (np.abs(got[off] - exact).max(axis=1) <
            np.abs(want[off] - exact).max(axis=1)).all()
  assert_close(got[~off], want[~off], 'qacc', atol=5e-3, rtol=5e-3)
  assert_close(out.qfrc_constraint.numpy(), np.asarray(ref.qfrc_constraint),
               'qfrc_constraint', atol=5e-2, rtol=5e-2)
  assert_close(out.efc_force.numpy(), np.asarray(ref.efc_force),
               'efc_force', atol=5e-2, rtol=5e-2)
  parity.check_niter(out.solver_niter, np.asarray(ref.solver_niter),
                     'elliptic')
  np.testing.assert_array_equal(out.overflow.numpy(),
                                np.asarray(ref.overflow))
  assert float(d.efc_D.count_nonzero()) > 0
  if CONES[scene] == types.ConeType.ELLIPTIC:
    s = solver_ref.ell_scales(m, d.contact.friction)
    zones = solver_ref.ell_zone_counts(m, lanes(d.efc_J), lanes(d.efc_D),
                                       lanes(d.efc_aref), out.qacc.T, s)
    assert min(zones.values()) > 0, zones
