"""Passive forces of the general step, world-major: joint and tendon
springs, dof and tendon dampers.

Counterpart of ``mujoco_warp_tpu/ops/passive.py`` ``passive`` (:269) with
``_spring`` (:21), the tendon terms (:286-304) and the damping term.
Fluid forces and gravity compensation are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import math
from mujoco_warp_tpu_torch.ops.util import ix

_JT = types.JointType


def _spring(m: types.Model, d: types.Data) -> torch.Tensor:
  """Joint spring torques -k (qpos - qpos_spring), per joint type."""
  dev = d.qpos.device
  qfrc = torch.zeros_like(d.qvel)
  for jt in np.unique(m.jnt_type):
    jids = np.nonzero(m.jnt_type == jt)[0]
    k = m.jnt_stiffness[ix(jids, dev)]
    qadr, dadr = m.jnt_qposadr[jids], m.jnt_dofadr[jids]
    span = lambda adr, a, b: ix(adr[:, None] + np.arange(a, b), dev)
    if jt == _JT.FREE:
      q3 = span(qadr, 0, 3)
      d3 = span(dadr, 0, 3)
      qfrc[:, d3] = qfrc[:, d3] + (-k[:, None] * (d.qpos[:, q3] -
                                                  m.qpos_spring[q3]))
      q4 = span(qadr, 3, 7)
      rotdif = math.quat_sub(math.normalize_quat(d.qpos[:, q4]),
                             math.normalize_quat(m.qpos_spring[q4]))
      d3r = span(dadr, 3, 6)
      qfrc[:, d3r] = qfrc[:, d3r] + (-k[:, None] * rotdif)
    elif jt == _JT.BALL:
      q4 = span(qadr, 0, 4)
      rotdif = math.quat_sub(math.normalize_quat(d.qpos[:, q4]),
                             math.normalize_quat(m.qpos_spring[q4]))
      d3 = span(dadr, 0, 3)
      qfrc[:, d3] = qfrc[:, d3] + (-k[:, None] * rotdif)
    else:  # SLIDE / HINGE
      qa, da = ix(qadr, dev), ix(dadr, dev)
      qfrc[:, da] = qfrc[:, da] + (-k * (d.qpos[:, qa] - m.qpos_spring[qa]))
  return qfrc


def tendon_stretch(m: types.Model, d: types.Data) -> torch.Tensor:
  """(W, ntendon): each tendon's length past its spring's deadband
  [lengthspring lo, hi], 0 inside it (``passive.py:290-293``)."""
  spring = types.world_field(m, 'tendon_lengthspring')
  lo, hi = spring[..., 0], spring[..., 1]
  L = d.ten_length
  return torch.where(L > hi, L - hi, torch.where(L < lo, L - lo, 0.0))


def passive(m: types.Model, d: types.Data) -> types.Data:
  """Spring and damper forces (``passive.py:269``), the tendons' springs
  with their deadband and their dampers among them (:286-304); the dof
  damping and spring deadbands per world where they are batched."""
  dsbl = m.opt.disableflags
  if float(types.host(m.opt.density)) or float(types.host(m.opt.viscosity)):
    raise NotImplementedError('fluid forces are not ported yet')
  if not (dsbl & types.DisableBit.GRAVITY) and \
      np.any(types.host(m.body_gravcomp) > 0):
    raise NotImplementedError('gravity compensation is not ported yet')
  zero = torch.zeros_like(d.qvel)
  qfrc_spring = zero if dsbl & types.DisableBit.SPRING else _spring(m, d)
  qfrc_damper = zero if dsbl & types.DisableBit.DAMPER else \
      -types.world_field(m, 'dof_damping') * d.qvel
  if m.ntendon:
    if not dsbl & types.DisableBit.SPRING:
      qfrc_spring = qfrc_spring + torch.einsum(
          'wtv,wt->wv', d.ten_J, -m.tendon_stiffness * tendon_stretch(m, d))
    if not dsbl & types.DisableBit.DAMPER:
      qfrc_damper = qfrc_damper + torch.einsum(
          'wtv,wt->wv', d.ten_J, -m.tendon_damping * d.ten_velocity)
  qfrc_passive = qfrc_spring + qfrc_damper + zero + zero
  return d.replace(qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
                   qfrc_gravcomp=zero, qfrc_fluid=zero,
                   qfrc_passive=qfrc_passive)
