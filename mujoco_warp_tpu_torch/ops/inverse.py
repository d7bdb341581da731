"""Inverse dynamics: the applied force that gives a desired
acceleration, world-major.

Counterpart of ``mujoco_warp_tpu/ops/inverse.py``: ``_discrete_acc``
(:26) and ``inverse`` (:51) for batched Data.  The position and velocity
stages run as the general step runs them (the mass chain kernel among
them), the constraint forces follow in closed form at the given qacc
(``ops/solver._update_constraint``, elliptic cones included, no solve),
and

  qfrc_inverse = M qacc + qfrc_bias - qfrc_passive - qfrc_constraint.

Under ``EnableBit.INVDISCRETE`` the given qacc is a discrete-time
acceleration of the model's integrator and is first turned into the
continuous one by an M^-1 solve through the ``chol_solve`` kernel on qLD.
"""

from __future__ import annotations

import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import k4_ref
from mujoco_warp_tpu_torch.ops import derivative, forward, smooth
from mujoco_warp_tpu_torch.ops import solver as osolver


def _discrete_acc(m: types.Model, d: types.Data) -> torch.Tensor:
  """The continuous qacc of a discrete one (``inverse.py:26``): M^-1 (M +
  h diag(damping)) qacc under damped Euler, M^-1 (M - h qDeriv) qacc under
  IMPLICIT(FAST); RK4 raises, as in JAX."""
  dt = m.opt.timestep
  integ = m.opt.integrator
  if integ == types.IntegratorType.RK4:
    raise NotImplementedError('INVDISCRETE not supported for RK4')
  if integ == types.IntegratorType.EULER:
    if not (k4_ref.damped(m)):
      return d.qacc
    rhs = smooth.mul_m(m, d, d.qacc) + \
        dt * types.world_field(m, 'dof_damping') * d.qacc
  else:
    A = d.qM - dt * derivative.deriv_smooth_vel(m, d)
    rhs = torch.einsum('wij,wj->wi', A, d.qacc)
  return smooth.solve_m(m, d, rhs)


def inverse(m: types.Model, d: types.Data) -> types.Data:
  """qfrc_inverse of batched Data at its qpos, qvel and qacc
  (``inverse.py:51``)."""
  if d.qpos.dim() != 2:
    raise ValueError('inverse takes batched (W, nq) Data')
  why = forward.unsupported(m)
  if why is not None:
    raise NotImplementedError(f'inverse: {why} is not ported yet')
  with forward.stage('pre'):
    d = forward.pre(m, d)
  with forward.stage('mass_chain'):
    d = forward.mass_chain(m, d)
  d = forward.mid(m, d, sensors=False)
  qacc = d.qacc
  if m.opt.enableflags & types.EnableBit.INVDISCRETE:
    qacc = _discrete_acc(m, d)
  if m.nefc:
    st = osolver._static_tables(m, d.qpos)
    Jaref = osolver._mv(d.efc_J, qacc) - d.efc_aref
    force, _ = osolver._update_constraint(d, st, Jaref)
    qfrc_constraint = osolver._mv(d.efc_J.transpose(1, 2), force)
    d = d.replace(efc_force=force, qfrc_constraint=qfrc_constraint)
  else:
    qfrc_constraint = torch.zeros_like(d.qvel)
    d = d.replace(qfrc_constraint=qfrc_constraint)
  return d.replace(qfrc_inverse=smooth.mul_m(m, d, qacc) + d.qfrc_bias -
                   d.qfrc_passive - qfrc_constraint)
