"""Smooth dynamics stages of the general step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/smooth.py``: ``kinematics`` (:36),
``com_pos`` (:131), ``camlight`` (:189), ``transmission`` (:857) and
``factor_m`` / ``solve_m`` / ``mul_m`` (:301-330).  The mass chain (crb,
qM, its factor, com_vel and RNE) runs as one kernel
(``kernels/mass_chain.py``).  ``factor_m`` and ``solve_m`` use the plain
lane Cholesky of the kernels (``fused/solver_ref.py``), which floors the
pivots as the kernels do.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.ops import math
from mujoco_warp_tpu_torch.ops.util import fmask, ix

_JT = types.JointType


def kinematics(m: types.Model, d: types.Data) -> types.Data:
  """Forward kinematics, bodies level by level (``smooth.py:36``)."""
  qpos = d.qpos
  W, dev, dt = qpos.shape[0], qpos.device, qpos.dtype
  nb = m.nbody
  xpos = torch.zeros((W, nb, 3), dtype=dt, device=dev)
  xquat = torch.zeros((W, nb, 4), dtype=dt, device=dev)
  xquat[..., 0] = 1.0
  xanchor = torch.zeros((W, m.njnt, 3), dtype=dt, device=dev)
  xaxis = torch.zeros((W, m.njnt, 3), dtype=dt, device=dev)
  ar = lambda a, b: np.arange(a, b)

  for ids in m.tree.body_levels:
    par = ix(m.body_parentid[ids], dev)
    tid = ix(ids, dev)
    pos = xpos[:, par] + math.rot_vec_quat(m.body_pos[tid], xquat[:, par])
    quat = math.mul_quat(xquat[:, par], m.body_quat[tid])
    nj = int(m.body_jntnum[ids].max()) if ids.size else 0
    for k in range(nj):
      sub = np.nonzero(m.body_jntnum[ids] > k)[0]
      jids_all = m.body_jntadr[ids[sub]] + k
      for jt in np.unique(m.jnt_type[jids_all]):
        sel = m.jnt_type[jids_all] == jt
        s2 = ix(sub[sel], dev)
        jj_np = jids_all[sel]
        jj = ix(jj_np, dev)
        qadr = m.jnt_qposadr[jj_np]
        if jt == _JT.FREE:
          p = qpos[:, ix(qadr[:, None] + ar(0, 3), dev)]
          q = math.normalize_quat(qpos[:, ix(qadr[:, None] + ar(3, 7), dev)])
          pos[:, s2] = p
          quat[:, s2] = q
          xanchor[:, jj] = p
          xaxis[:, jj] = fmask([0.0, 0.0, 1.0], qpos)
        elif jt == _JT.BALL:
          anchor = pos[:, s2] + math.rot_vec_quat(m.jnt_pos[jj], quat[:, s2])
          axis = math.rot_vec_quat(m.jnt_axis[jj], quat[:, s2])
          qloc = math.normalize_quat(qpos[:, ix(qadr[:, None] + ar(0, 4),
                                                dev)])
          qnew = math.mul_quat(quat[:, s2], qloc)
          pos[:, s2] = anchor - math.rot_vec_quat(m.jnt_pos[jj], qnew)
          quat[:, s2] = qnew
          xanchor[:, jj] = anchor
          xaxis[:, jj] = axis
        elif jt == _JT.SLIDE:
          axis = math.rot_vec_quat(m.jnt_axis[jj], quat[:, s2])
          anchor = pos[:, s2] + math.rot_vec_quat(m.jnt_pos[jj], quat[:, s2])
          qa = ix(qadr, dev)
          pos[:, s2] = pos[:, s2] + axis * (qpos[:, qa] - m.qpos0[qa])[..., None]
          xanchor[:, jj] = anchor
          xaxis[:, jj] = axis
        else:  # HINGE
          anchor = pos[:, s2] + math.rot_vec_quat(m.jnt_pos[jj], quat[:, s2])
          axis = math.rot_vec_quat(m.jnt_axis[jj], quat[:, s2])
          qa = ix(qadr, dev)
          qloc = math.axis_angle_to_quat(m.jnt_axis[jj],
                                         qpos[:, qa] - m.qpos0[qa])
          qnew = math.mul_quat(quat[:, s2], qloc)
          pos[:, s2] = anchor - math.rot_vec_quat(m.jnt_pos[jj], qnew)
          quat[:, s2] = qnew
          xanchor[:, jj] = anchor
          xaxis[:, jj] = axis
    xpos[:, tid] = pos
    xquat[:, tid] = math.normalize_quat(quat)

  xmat = math.quat_to_mat(xquat)
  xipos = xpos + math.rot_vec_quat(m.body_ipos, xquat)
  ximat = math.quat_to_mat(math.mul_quat(xquat, m.body_iquat))
  gb = ix(m.geom_bodyid[:m.ngeom], dev)
  geom_xpos = xpos[:, gb] + math.rot_vec_quat(m.geom_pos, xquat[:, gb])
  geom_xmat = math.quat_to_mat(math.mul_quat(xquat[:, gb], m.geom_quat))
  return d.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                   ximat=ximat, xanchor=xanchor, xaxis=xaxis,
                   geom_xpos=geom_xpos, geom_xmat=geom_xmat)


def com_pos(m: types.Model, d: types.Data) -> types.Data:
  """Subtree CoM, spatial inertia and dof axes (``smooth.py:131``)."""
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  mass = m.body_mass
  wpos = mass[:, None] * d.xipos
  sub = fmask(m.tree.subtree_mask, d.qpos)
  subtree_com = (sub @ wpos) / torch.clamp(m.body_subtreemass,
                                           min=1e-12)[:, None]
  root_com = subtree_com[:, ix(m.body_rootid, dev)]
  offset = d.xipos - root_com
  cinert = math.inert_matrix(m.body_inertia, mass, offset, d.ximat)

  cdof = torch.zeros((W, m.nv, 6), dtype=dt, device=dev)
  for jt in np.unique(m.jnt_type):
    jids = np.nonzero(m.jnt_type == jt)[0]
    dadr = m.jnt_dofadr[jids]
    bid = ix(m.jnt_bodyid[jids], dev)
    com = root_com[:, bid]
    if jt == _JT.FREE:
      n = len(jids)
      eye3 = torch.eye(3, dtype=dt, device=dev)
      trans = torch.cat([torch.zeros((W, n, 3, 3), dtype=dt, device=dev),
                         eye3.expand(W, n, 3, 3)], dim=-1)
      off = d.xpos[:, bid] - com
      axes = d.xmat[:, bid].transpose(-1, -2)
      lin = math.cross(off[:, :, None, :], axes)
      rot = torch.cat([axes, lin], dim=-1)
      cdof[:, ix(dadr[:, None] + np.arange(3), dev)] = trans
      cdof[:, ix(dadr[:, None] + np.arange(3, 6), dev)] = rot
    elif jt == _JT.BALL:
      axes = d.xmat[:, bid].transpose(-1, -2)
      off = d.xanchor[:, ix(jids, dev)] - com
      lin = math.cross(off[:, :, None, :], axes)
      cdof[:, ix(dadr[:, None] + np.arange(3), dev)] = torch.cat(
          [axes, lin], dim=-1)
    elif jt == _JT.SLIDE:
      axis = d.xaxis[:, ix(jids, dev)]
      cdof[:, ix(dadr, dev)] = torch.cat([torch.zeros_like(axis), axis],
                                         dim=-1)
    else:  # HINGE
      axis = d.xaxis[:, ix(jids, dev)]
      off = d.xanchor[:, ix(jids, dev)] - com
      cdof[:, ix(dadr, dev)] = torch.cat([axis, math.cross(off, axis)],
                                         dim=-1)
  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def camlight(m: types.Model, d: types.Data) -> types.Data:
  """Camera and light frames (``smooth.py:189``): none in this slice."""
  if m.ncam or m.nlight:
    raise NotImplementedError('cameras and lights are not ported yet')
  return d


def transmission(m: types.Model, d: types.Data) -> types.Data:
  """Actuator lengths and moment arms, joint transmission
  (``smooth.py:857``)."""
  if not m.nu:
    return d
  if not np.all(m.actuator_trntype == types.TrnType.JOINT):
    raise NotImplementedError('only joint transmissions are ported')
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  tid = m.actuator_trnid[:, 0]
  jt = m.jnt_type[tid]
  gear = m.actuator_gear
  if np.all((jt == _JT.SLIDE) | (jt == _JT.HINGE)):
    qadr, dadr = m.jnt_qposadr[tid], m.jnt_dofadr[tid]
    gear0 = gear[:, 0]
    length = d.qpos[:, ix(qadr, dev)] * gear0
    moment = torch.zeros((W, m.nu, m.nv), dtype=dt, device=dev)
    moment[:, ix(np.arange(m.nu), dev), ix(dadr, dev)] = gear0
    return d.replace(actuator_length=length, actuator_moment=moment)
  length = torch.zeros((W, m.nu), dtype=dt, device=dev)
  moment = torch.zeros((W, m.nu, m.nv), dtype=dt, device=dev)
  for u in range(m.nu):
    j = int(tid[u])
    qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if jt[u] in (_JT.SLIDE, _JT.HINGE):
      length[:, u] = d.qpos[:, qadr] * gear[u, 0]
      moment[:, u, dadr] = gear[u, 0]
    elif jt[u] == _JT.BALL:
      q = math.normalize_quat(d.qpos[:, qadr:qadr + 4])
      axis_angle = math.quat_sub(q, fmask([1.0, 0.0, 0.0, 0.0], q))
      length[:, u] = torch.sum(axis_angle * gear[u, :3], dim=-1)
      moment[:, u, dadr:dadr + 3] = gear[u, :3]
    else:  # FREE
      moment[:, u, dadr:dadr + 3] = gear[u, :3]
      moment[:, u, dadr + 3:dadr + 6] = gear[u, 3:]
  return d.replace(actuator_length=length, actuator_moment=moment)


def factor_m(m: types.Model, d: types.Data) -> types.Data:
  """Cholesky factor of qM (``smooth.py:301``), plain lane Cholesky."""
  W = d.qM.shape[0]
  L = solver_ref.chol_tile(d.qM.permute(1, 2, 0), m.nv)
  return d.replace(qLD=L.permute(2, 0, 1).contiguous())


def solve_m(m: types.Model, d: types.Data, x: torch.Tensor) -> torch.Tensor:
  """y with M y = x from the factor (``smooth.py:310``)."""
  y = solver_ref.chol_solve_tile(d.qLD.permute(1, 2, 0), x.T, m.nv)
  return y.T


def mul_m(m: types.Model, d: types.Data, x: torch.Tensor) -> torch.Tensor:
  """M x (``smooth.py:321``)."""
  return torch.einsum('wij,wj->wi', d.qM, x)
