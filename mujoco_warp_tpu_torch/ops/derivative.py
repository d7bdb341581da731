"""Velocity derivatives of the smooth forces and the implicit
integrators, world-major.

Counterpart of ``mujoco_warp_tpu/ops/derivative.py``:
``deriv_smooth_vel`` (:32), ``deriv_rne_vel`` (:68) and ``implicit``
(:88) for batched Data.  qDeriv = d qfrc_smooth / d qvel, dense (W, nv,
nv): minus the joint damping, minus the tendon damping through ten_J, and
the actuators' velocity gains through their moments.  IMPLICIT adds minus
the derivative of the RNE bias in qvel, taken by forward-mode AD through
the torch ``smooth.com_vel`` and ``smooth.rne`` (JAX takes ``jax.jacfwd``
of the same two stages).

The integrator solves (M - h qDeriv) qacc' = M qacc and advances with
qacc'.  For IMPLICITFAST the matrix is symmetric positive definite and
is factored by the ``chol_batched`` kernel and solved by the
``chol_solve`` kernel, as MuJoCo C factors it by Cholesky.  For IMPLICIT
the RNE term makes it unsymmetric: ``torch.linalg.solve`` solves it, as
the JAX package calls ``jnp.linalg.solve`` outside any Pallas kernel, so
there is no TPU kernel to port there.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.ops import smooth
from mujoco_warp_tpu_torch.ops.util import bmask, ix

_GT = types.GainType
_BT = types.BiasType


def deriv_smooth_vel(m: types.Model, d: types.Data) -> torch.Tensor:
  """qDeriv = d qfrc_smooth / d qvel (W, nv, nv) (``derivative.py:32``),
  the damping and the actuators' gains and biases per world where they
  are batched."""
  W, nv = d.qvel.shape
  damping = types.world_field(m, 'dof_damping')
  qderiv = -torch.diag_embed(damping.to(d.qvel.dtype).expand(W, nv))
  if m.ntendon:
    qderiv = qderiv - torch.einsum('wtv,t,wtu->wvu', d.ten_J,
                                   m.tendon_damping, d.ten_J)
  if m.nu:
    dev = d.qvel.device
    gain_v = torch.where(bmask(m.actuator_gaintype == _GT.AFFINE, dev),
                         types.world_field(m, 'actuator_gainprm')[..., 2],
                         0.0)
    bias_v = torch.where(bmask(m.actuator_biastype == _BT.AFFINE, dev),
                         types.world_field(m, 'actuator_biasprm')[..., 2],
                         0.0)
    # the input: the last act slot where the actuator has one, else ctrl
    # clamped to its range (``derivative.py:50-60``)
    from mujoco_warp_tpu_torch.ops import forward
    has_act, last = forward._act_last(m)
    u = d.ctrl
    if m.na:
      u = torch.where(bmask(has_act, dev), d.act[:, ix(last, dev)], u)
    if not (m.opt.disableflags & types.DisableBit.CLAMPCTRL):
      cr = types.world_field(m, 'actuator_ctrlrange')
      u = torch.where(bmask(np.asarray(m.actuator_ctrllimited, bool) &
                            ~has_act, dev),
                      torch.minimum(torch.maximum(u, cr[..., 0]),
                                    cr[..., 1]), u)
    dfdv = gain_v * u + bias_v
    qderiv = qderiv + torch.einsum('wuv,wu,wux->wvx', d.actuator_moment,
                                   dfdv, d.actuator_moment)
  return qderiv


def deriv_rne_vel(m: types.Model, d: types.Data) -> torch.Tensor:
  """-d qfrc_bias / d qvel (W, nv, nv) (``derivative.py:68``): one
  forward-mode pass of ``com_vel`` -> ``rne`` per dof, all dofs at once
  under ``torch.func.vmap`` (column j from the tangent e_j in every
  world)."""
  W, nv = d.qvel.shape

  def bias_of_qvel(qvel):
    return smooth.rne(m, smooth.com_vel(m, d.replace(qvel=qvel))).qfrc_bias

  eye = torch.eye(nv, dtype=d.qvel.dtype, device=d.qvel.device)
  tangents = eye[:, None, :].expand(nv, W, nv)
  cols = torch.func.vmap(
      lambda t: torch.func.jvp(bias_of_qvel, (d.qvel,), (t,))[1])(tangents)
  return -cols.permute(1, 2, 0)  # (j, w, i) -> (w, i, j)


def implicit(m: types.Model, d: types.Data) -> types.Data:
  """IMPLICIT or IMPLICITFAST integration (``derivative.py:88``): solve
  (M - h qDeriv) qacc' = M qacc, then advance with qacc'."""
  from mujoco_warp_tpu_torch.ops import forward
  dt = m.opt.timestep
  qderiv = deriv_smooth_vel(m, d)
  rhs = smooth.mul_m(m, d, d.qacc)
  if m.opt.integrator == types.IntegratorType.IMPLICIT:
    A = d.qM - dt * (qderiv + deriv_rne_vel(m, d))
    # unsymmetric: a library LU, as JAX's jnp.linalg.solve (no kernel)
    qacc = torch.linalg.solve(A, rhs)
  else:
    A = (d.qM - dt * qderiv).contiguous()
    qacc = klinalg.chol_solve_batched(m, klinalg.chol_batched(m, A), rhs)
  return forward._advance(m, d, qacc)

