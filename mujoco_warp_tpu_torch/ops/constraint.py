"""Constraint (EFC) rows of the general step in the static layout,
world-major.

Counterpart of ``mujoco_warp_tpu/ops/constraint.py``: ``_kbi`` (:32),
``_row_values`` (:66), ``_jac`` (:76), ``_cdof_dot_jac`` (:102),
``_jac_dot`` (:118), the row writer (:142-206), ``_equality_connect``
(:208), ``_equality_weld`` (:262), ``_equality_joint`` (:383),
``_equality_tendon`` (:423), ``_friction`` (:594, dof and tendon rows),
``_limit`` (:619, joint and tendon rows), ``_contact`` (:777, frictionless,
pyramidal and elliptic rows; under contact compaction each world's
slots take their bodies from its own ``contact.geom1/geom2``) and
``make_constraint`` (:919).  Every potential row exists every step;
inactive rows are zeroed.  Every batchable Model field (invweights,
friction losses, solver parameters, ranges, margins, eq_data, qpos0,
tendon_length0, impratio) is read per world (``types.world_field``).
The Jacobian is dense (W, nefc, nv).  The chain form of the contact
rows (``_contact_compact`` :703, for ``efc_compact`` models) and flex
rows are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import math, smooth
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, ix

_JT = types.JointType

MJ_MINVAL = 1e-15
MJ_MINIMP = 0.0001
MJ_MAXIMP = 0.9999


def _kbi(m: types.Model, solref, solimp, pos_imp):
  """Stiffness k, damping b and impedance imp per row; all arguments
  broadcast."""
  timeconst = solref[..., 0]
  dampratio = solref[..., 1]
  dmin = torch.clamp(solimp[..., 0], MJ_MINIMP, MJ_MAXIMP)
  dmax = torch.clamp(solimp[..., 1], MJ_MINIMP, MJ_MAXIMP)
  width = torch.clamp(solimp[..., 2], min=MJ_MINVAL)
  mid = torch.clamp(solimp[..., 3], MJ_MINIMP, MJ_MAXIMP)
  power = torch.clamp(solimp[..., 4], min=1.0)
  if not (m.opt.disableflags & types.DisableBit.REFSAFE):
    timeconst = torch.maximum(timeconst, 2.0 * m.opt.timestep)
  dmax_sq = dmax * dmax
  k = 1.0 / torch.clamp(dmax_sq * timeconst * timeconst * dampratio *
                        dampratio, min=MJ_MINVAL)
  b = 2.0 / torch.clamp(dmax * timeconst, min=MJ_MINVAL)
  k = torch.where(solref[..., 0] <= 0, -solref[..., 0] / dmax_sq, k)
  b = torch.where(solref[..., 1] <= 0, -solref[..., 1] / dmax, b)
  imp_x = torch.abs(pos_imp) / width
  imp_a = (1.0 / mid ** (power - 1.0)) * imp_x ** power
  imp_b = 1.0 - (1.0 / (1.0 - mid) ** (power - 1.0)) * (1.0 - imp_x) ** power
  imp = dmin + torch.where(imp_x < mid, imp_a, imp_b) * (dmax - dmin)
  imp = torch.minimum(torch.maximum(imp, dmin), dmax)
  imp = torch.where(imp_x > 1.0, dmax, imp)
  return k, b, imp


def _row_values(m, pos_aref, pos_imp, invweight, solref, solimp, margin,
                vel):
  """D, aref, pos of a batch of rows (reference ``_efc_row``)."""
  k, b, imp = _kbi(m, solref, solimp, pos_imp)
  D = 1.0 / torch.clamp(invweight * (1.0 - imp) / imp, min=MJ_MINVAL)
  aref = -k * imp * pos_aref - b * vel
  return D, aref, pos_aref + margin


def _jac(m: types.Model, d: types.Data, point, bodyid):
  """Point Jacobians: point (W, n, 3) on bodies ``bodyid``, static (n,)
  or a (W, n) tensor of each world's own (a compacted contact's) ->
  jacp, jacr each (W, n, nv, 3)."""
  dev = d.qpos.device
  if isinstance(bodyid, torch.Tensor):
    w = torch.arange(bodyid.shape[0], device=dev)[:, None]
    mask = fmask(m.tree.body_dof_mask, d.qpos)[bodyid]  # (W, n, nv)
    offset = point - d.subtree_com[w, ix(m.body_rootid, dev)[bodyid]]
  else:
    mask = fmask(m.tree.body_dof_mask[bodyid], d.qpos)  # (n, nv)
    offset = point - d.subtree_com[:, ix(m.body_rootid[bodyid], dev)]
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]  # (W, nv, 3)
  jacp = (lin[:, None] + math.cross(ang[:, None], offset[:, :, None, :])) * \
      mask[..., None]
  jacr = ang[:, None] * mask[..., None]
  return jacp, jacr


def _cdof_dot_jac(m: types.Model, d: types.Data):
  """cdof time-derivative for Jacobian-dot: cvel(body) x cdof on ball
  dofs and the rotational dofs of free joints."""
  quat_dof = np.zeros(m.nv, bool)
  for i in range(m.nv):
    j = int(m.dof_jntid[i])
    jt = int(m.jnt_type[j])
    if jt == _JT.BALL or (jt == _JT.FREE and i >= int(m.jnt_dofadr[j]) + 3):
      quat_dof[i] = True
  alt = math.motion_cross(d.cvel[:, ix(m.dof_bodyid, d.qpos.device)], d.cdof)
  return torch.where(bmask(quat_dof, alt.device)[:, None],
                     alt, d.cdof_dot)


def _jac_dot(m: types.Model, d: types.Data, point, bodyid, cdof_dot):
  """Time-derivative of the point Jacobians, each (W, n, nv, 3)."""
  dev = d.qpos.device
  mask = fmask(m.tree.body_dof_mask[bodyid], d.qpos)
  offset = point - d.subtree_com[:, ix(m.body_rootid[bodyid], dev)]
  cvel = d.cvel[:, ix(bodyid, dev)]  # (W, n, 6)
  pvel_lin = cvel[..., 3:] - math.cross(offset, cvel[..., :3])
  dd_ang, dd_lin = cdof_dot[..., :3], cdof_dot[..., 3:]
  corr1 = math.cross(dd_ang[:, None], offset[:, :, None, :])
  corr2 = math.cross(d.cdof[:, None, :, :3], pvel_lin[:, :, None, :])
  jacp_dot = (dd_lin[:, None] + corr1 + corr2) * mask[..., None]
  jacr_dot = dd_ang[:, None] * mask[..., None]
  return jacp_dot, jacr_dot


class _Rows:
  """Rows written into the static layout, inactive rows zeroed."""

  def __init__(self, m: types.Model, d: types.Data):
    W, dev, dt = d.qpos.shape[0], d.qpos.device, d.qpos.dtype
    z = lambda *s: torch.zeros((W,) + s, dtype=dt, device=dev)
    self.dev = dev
    self.J = z(m.nefc, m.nv)
    self.pos, self.margin, self.D = z(m.nefc), z(m.nefc), z(m.nefc)
    self.aref, self.frictionloss = z(m.nefc), z(m.nefc)
    self.active = torch.zeros((W, m.nefc), dtype=torch.bool, device=dev)

  def set(self, adr, J, pos, margin, D, aref, frictionloss, active):
    """adr: static rows (n,); J (W, n, nv); the others broadcast to
    (W, n)."""
    adr = ix(adr, self.dev)
    act = active.expand(self.pos.shape[0], len(adr))
    act_f = act.to(J.dtype)
    self.J[:, adr] = J * act_f[..., None]
    self.pos[:, adr] = pos * act_f
    self.margin[:, adr] = margin * act_f
    self.D[:, adr] = D * act_f
    self.aref[:, adr] = aref * act_f
    if frictionloss is not None:
      self.frictionloss[:, adr] = frictionloss * act_f
    self.active[:, adr] = act


def _eq_bodies(m, ids):
  """(is_site, body1, body2) of equalities ``ids``: a site-anchored
  one's bodies are its sites' (``constraint.py:217-223``)."""
  is_site = (m.eq_objtype[ids] == types.ObjType.SITE) & (m.nsite > 0)
  o1, o2 = m.eq_obj1id[ids], m.eq_obj2id[ids]
  if not np.any(is_site):
    return is_site, o1, o2
  sb = np.asarray(m.site_bodyid)
  s1, s2 = np.minimum(o1, m.nsite - 1), np.minimum(o2, m.nsite - 1)
  return is_site, np.where(is_site, sb[s1], o1), np.where(is_site, sb[s2], o2)


def _site_frames(m, d, ids, is_site):
  """(sel (n, 1) mask of the site-anchored equalities ``is_site``, site
  ids 1 and 2, and each side's site quaternion (W, n, 4), xquat of the
  site's body times site_quat)."""
  dev = d.qpos.device
  s1 = np.minimum(m.eq_obj1id[ids], m.nsite - 1)
  s2 = np.minimum(m.eq_obj2id[ids], m.nsite - 1)
  sb = np.asarray(m.site_bodyid)
  sq = lambda s: math.mul_quat(d.xquat[:, ix(sb[s], dev)],
                               _wf(m, 'site_quat', s, dev))
  return bmask(is_site[:, None], dev), s1, s2, sq(s1), sq(s2)


def _bmv(mat, vec):
  """(W, n, 3, 3) matrices times (1 or W, n, 3) vectors."""
  return torch.sum(mat * vec[..., None, :], dim=-1)


def _wf(m, name, idx, dev):
  """Model field ``name`` at element ids ``idx``, per world (1 or W,
  n, ...)."""
  return types.world_field(m, name)[:, ix(idx, dev)]


def _equality_connect(m, d, rows, cdof_dot):
  """Connect equality rows (``constraint.py:208``)."""
  ids = m.efc.connect_id
  if not len(ids):
    return
  dev = d.qpos.device
  data = _wf(m, 'eq_data', ids, dev)
  is_site, body1, body2 = _eq_bodies(m, ids)
  b1, b2 = ix(body1, dev), ix(body2, dev)
  pos1 = d.xpos[:, b1] + _bmv(d.xmat[:, b1], data[..., 0:3])
  pos2 = d.xpos[:, b2] + _bmv(d.xmat[:, b2], data[..., 3:6])
  if np.any(is_site):
    # a site-anchored connect joins the two sites (:227-230)
    sel, s1, s2, _, _ = _site_frames(m, d, ids, is_site)
    pos1 = torch.where(sel, d.site_xpos[:, ix(s1, dev)], pos1)
    pos2 = torch.where(sel, d.site_xpos[:, ix(s2, dev)], pos2)
  jacp1, _ = _jac(m, d, pos1, body1)
  jacp2, _ = _jac(m, d, pos2, body2)
  jd = jacp1 - jacp2  # (W, n, nv, 3)
  jacd1, _ = _jac_dot(m, d, pos1, body1, cdof_dot)
  jacd2, _ = _jac_dot(m, d, pos2, body2, cdof_dot)
  jdot = jacd1 - jacd2
  cpos = pos1 - pos2
  Jqvel = torch.einsum('wnvi,wv->wni', jd, d.qvel)
  Jdotv = torch.einsum('wnvi,wv->wni', jdot, d.qvel)
  pos_imp = math.norm(cpos)
  iw = types.world_field(m, 'body_invweight0')
  invweight = iw[:, b1, 0] + iw[:, b2, 0]
  ti = ix(ids, dev)
  D, aref, posv = _row_values(
      m, cpos, pos_imp[..., None], invweight[..., None],
      _wf(m, 'eq_solref', ids, dev)[:, :, None, :],
      _wf(m, 'eq_solimp', ids, dev)[:, :, None, :], 0.0, Jqvel)
  D = D.expand(cpos.shape)
  aref = aref - Jdotv
  W, n = cpos.shape[0], len(ids)
  active = d.eq_active[:, ti][..., None].expand(W, n, 3)
  adr = (m.efc.connect_adr[:, None] + np.arange(3)).reshape(-1)
  rows.set(adr, jd.transpose(2, 3).reshape(W, 3 * n, m.nv),
           posv.reshape(W, -1), torch.zeros_like(posv).reshape(W, -1),
           D.reshape(W, -1), aref.reshape(W, -1), None,
           active.reshape(W, -1))


def _equality_weld(m, d, rows, cdof_dot):
  """Weld equality rows with torquescale and relpose
  (``constraint.py:262``)."""
  ids = m.efc.weld_id
  if not len(ids):
    return
  dev = d.qpos.device
  ti = ix(ids, dev)
  data = _wf(m, 'eq_data', ids, dev)
  anchor1, anchor2 = data[..., 0:3], data[..., 3:6]
  relpose, torquescale = data[..., 6:10], data[..., 10]
  is_site, body1, body2 = _eq_bodies(m, ids)
  b1, b2 = ix(body1, dev), ix(body2, dev)
  # body1 carries anchor2 and body2 anchor1 (reference :1078-1079)
  pos1 = d.xpos[:, b1] + _bmv(d.xmat[:, b1], anchor2)
  pos2 = d.xpos[:, b2] + _bmv(d.xmat[:, b2], anchor1)
  quat = math.mul_quat(d.xquat[:, b1], relpose)
  quat1 = math.quat_inv(d.xquat[:, b2])
  qfull1 = d.xquat[:, b2]
  site = np.any(is_site)
  if site:
    # a site-anchored weld holds the two sites' frames together, without
    # eq_data's anchors and relative pose (:287-300)
    sel, s1, s2, sq1, sq2 = _site_frames(m, d, ids, is_site)
    pos1 = torch.where(sel, d.site_xpos[:, ix(s1, dev)], pos1)
    pos2 = torch.where(sel, d.site_xpos[:, ix(s2, dev)], pos2)
    quat = torch.where(sel, sq1, quat)
    quat1 = torch.where(sel, math.quat_inv(sq2), quat1)
    qfull1 = torch.where(sel, sq2, qfull1)

  jacp1, jacr1 = _jac(m, d, pos1, body1)
  jacp2, jacr2 = _jac(m, d, pos2, body2)
  jacdifp = jacp1 - jacp2  # (W, n, nv, 3)
  jacd1, jacrd1 = _jac_dot(m, d, pos1, body1, cdof_dot)
  jacd2, jacrd2 = _jac_dot(m, d, pos2, body2, cdof_dot)
  jacdifp_dot = jacd1 - jacd2
  jacdifr_dot = jacrd1 - jacrd2

  # rotational rows through the quaternion map (reference :1196-1198)
  jacdifr = (jacr1 - jacr2) * torquescale[..., None, None]
  jacdifrq = math.mul_quat(math.quat_mul_axis(quat1[:, :, None], jacdifr),
                           quat[:, :, None])
  jacdifr = 0.5 * jacdifrq[..., 1:4]

  cpos = pos1 - pos2
  crot = math.mul_quat(quat1, quat)[..., 1:4] * torquescale[..., None]
  mv = lambda J: torch.einsum('wnvi,wv->wni', J, d.qvel)
  Jqvelp, Jqvelr = mv(jacdifp), mv(jacdifr)
  Jdotv_p, Jdotv_r0 = mv(jacdifp_dot), mv(jacdifr_dot)

  # rotational Jdot v (reference :1088-1114, 1365-1379)
  omega1 = d.cvel[:, b1, :3]
  omega2 = d.cvel[:, b2, :3]
  z1 = torch.zeros_like(omega1[..., :1])
  domega_q = torch.cat([z1, omega1 - omega2], dim=-1)
  omega1_q = torch.cat([z1, omega1], dim=-1)
  omega2_q = torch.cat([z1, omega2], dim=-1)
  qdot0r = math.mul_quat(math.mul_quat(omega1_q, d.xquat[:, b1]) * 0.5,
                         relpose)
  if site:  # (:336)
    qdot0r = torch.where(sel, math.mul_quat(omega1_q, quat) * 0.5, qdot0r)
  qdot1 = math.mul_quat(omega2_q, qfull1) * 0.5
  negqdot1 = math.quat_inv(qdot1)
  negq1 = math.quat_inv(qfull1)
  djrdv_q = torch.cat([z1, Jdotv_r0], dim=-1)
  t1 = math.mul_quat(math.mul_quat(negqdot1, domega_q), quat)
  t2 = math.mul_quat(math.mul_quat(negq1, djrdv_q), quat)
  t3 = math.mul_quat(math.mul_quat(negq1, domega_q), qdot0r)
  Jdotv_r = (t1[..., 1:4] + t2[..., 1:4] + t3[..., 1:4]) * 0.5 * \
      torquescale[..., None]

  pos_imp = torch.sqrt(torch.sum(cpos * cpos, -1) + torch.sum(crot * crot, -1))
  iw = types.world_field(m, 'body_invweight0')
  iw_t = iw[:, b1, 0] + iw[:, b2, 0]
  iw_r = iw[:, b1, 1] + iw[:, b2, 1]
  solref = _wf(m, 'eq_solref', ids, dev)[:, :, None, :]
  solimp = _wf(m, 'eq_solimp', ids, dev)[:, :, None, :]
  Dp, arefp, posp = _row_values(m, cpos, pos_imp[..., None],
                                iw_t[..., None], solref, solimp, 0.0, Jqvelp)
  Dr, arefr, posr = _row_values(m, crot, pos_imp[..., None],
                                iw_r[..., None], solref, solimp, 0.0, Jqvelr)
  Dp, Dr = Dp.expand(cpos.shape), Dr.expand(crot.shape)
  arefp, arefr = arefp - Jdotv_p, arefr - Jdotv_r

  W, n = cpos.shape[0], len(ids)
  active = d.eq_active[:, ti][..., None].expand(W, n, 6)
  adr = (m.efc.weld_adr[:, None] + np.arange(6)).reshape(-1)
  J6 = torch.cat([jacdifp.transpose(2, 3), jacdifr.transpose(2, 3)], dim=2)
  rows.set(adr, J6.reshape(W, 6 * n, m.nv),
           torch.cat([posp, posr], -1).reshape(W, -1),
           torch.zeros((W, 6 * n), dtype=cpos.dtype, device=dev),
           torch.cat([Dp, Dr], -1).reshape(W, -1),
           torch.cat([arefp, arefr], -1).reshape(W, -1), None,
           active.reshape(W, -1))


def _equality_joint(m, d, rows):
  """Joint equality rows with the polynomial coupling
  (``constraint.py:383``)."""
  ids = m.efc.joint_id
  if not len(ids):
    return
  dev = d.qpos.device
  ti = ix(ids, dev)
  data = _wf(m, 'eq_data', ids, dev)
  j1, j2 = m.eq_obj1id[ids], m.eq_obj2id[ids]
  has2 = j2 > -1
  j2c = np.maximum(j2, 0)
  qadr1, dadr1 = ix(m.jnt_qposadr[j1], dev), m.jnt_dofadr[j1]
  qadr2, dadr2 = ix(m.jnt_qposadr[j2c], dev), m.jnt_dofadr[j2c]
  qpos0 = types.world_field(m, 'qpos0')
  dif = d.qpos[:, qadr2] - qpos0[:, qadr2]
  rhs = data[..., 0] + dif * (data[..., 1] + dif * (
      data[..., 2] + dif * (data[..., 3] + dif * data[..., 4])))
  deriv2 = data[..., 1] + dif * (2.0 * data[..., 2] + dif * (
      3.0 * data[..., 3] + dif * 4.0 * data[..., 4]))
  h2 = fmask(has2.astype(np.float32), d.qpos)
  has2_t = bmask(has2, dev)
  pos = d.qpos[:, qadr1] - qpos0[:, qadr1] - torch.where(has2_t, rhs,
                                                           data[..., 0])
  td1, td2 = ix(dadr1, dev), ix(dadr2, dev)
  Jqvel = d.qvel[:, td1] - d.qvel[:, td2] * deriv2 * h2
  iw = types.world_field(m, 'dof_invweight0')
  invweight = iw[:, td1] + iw[:, td2] * h2
  # J = e_dof1 + e_dof2 * (-deriv2 where there is a second joint), from
  # static one-hot rows (the same values as setting 1 and adding)
  e1 = fmask(np.eye(m.nv)[dadr1], d.qpos)
  e2 = fmask(np.eye(m.nv)[dadr2], d.qpos)
  J = e1 + e2 * torch.where(has2_t, -deriv2,
                            torch.zeros_like(deriv2))[..., None]
  D, aref, posv = _row_values(m, pos, pos, invweight,
                              _wf(m, 'eq_solref', ids, dev),
                              _wf(m, 'eq_solimp', ids, dev), 0.0, Jqvel)
  rows.set(m.efc.joint_adr, J, posv, torch.zeros_like(posv), D, aref, None,
           d.eq_active[:, ti])


def _equality_tendon(m, d, rows):
  """Tendon equality rows, the polynomial coupling of two tendons or one
  tendon held at its qpos0 length plus a constant
  (``constraint.py:423``)."""
  ids = m.efc.tendon_id
  if not len(ids):
    return
  dev = d.qpos.device
  ti = ix(ids, dev)
  data = _wf(m, 'eq_data', ids, dev)
  t1, t2 = m.eq_obj1id[ids], m.eq_obj2id[ids]
  has2 = t2 > -1
  i1, i2 = ix(t1, dev), ix(np.maximum(t2, 0), dev)
  length0 = types.world_field(m, 'tendon_length0')
  dif = d.ten_length[:, i2] - length0[:, i2]
  rhs = data[..., 0] + dif * (data[..., 1] + dif * (
      data[..., 2] + dif * (data[..., 3] + dif * data[..., 4])))
  deriv2 = data[..., 1] + dif * (2.0 * data[..., 2] + dif * (
      3.0 * data[..., 3] + dif * 4.0 * data[..., 4]))
  h2 = fmask(has2.astype(np.float32), d.qpos)
  pos = d.ten_length[:, i1] - length0[:, i1] - torch.where(
      bmask(has2, dev), rhs, data[..., 0])
  J = d.ten_J[:, i1] - (deriv2 * h2)[..., None] * d.ten_J[:, i2]
  Jqvel = torch.einsum('wnv,wv->wn', J, d.qvel)
  iw = types.world_field(m, 'tendon_invweight0')
  invweight = iw[:, i1] + iw[:, i2] * h2
  D, aref, posv = _row_values(m, pos, pos, invweight,
                              _wf(m, 'eq_solref', ids, dev),
                              _wf(m, 'eq_solimp', ids, dev), 0.0, Jqvel)
  rows.set(m.efc.tendon_adr, J, posv, torch.zeros_like(posv), D, aref, None,
           d.eq_active[:, ti])


def _friction(m, d, rows):
  """Dof and tendon friction-loss rows (``constraint.py:594``).  A
  tendon row's velocity is ten_J qvel of this step (``forward.mid`` sets
  ten_velocity before the rows; see there)."""
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  dofs = m.efc.fri_dof_id
  if len(dofs):
    n = len(dofs)
    td = ix(dofs, dev)
    J = fmask(np.eye(m.nv)[dofs], d.qpos)
    zero = torch.zeros((n,), dtype=dt, device=dev)
    D, aref, posv = _row_values(m, zero, zero,
                                _wf(m, 'dof_invweight0', dofs, dev),
                                _wf(m, 'dof_solref', dofs, dev),
                                _wf(m, 'dof_solimp', dofs, dev), 0.0,
                                d.qvel[:, td])
    rows.set(m.efc.fri_dof_adr, J.expand(W, n, m.nv), posv,
             torch.zeros_like(posv), D, aref,
             _wf(m, 'dof_frictionloss', dofs, dev),
             torch.ones((n,), dtype=torch.bool, device=dev))
  tens = m.efc.fri_ten_id
  if len(tens):
    n = len(tens)
    tt = ix(tens, dev)
    zero = torch.zeros((n,), dtype=dt, device=dev)
    D, aref, posv = _row_values(m, zero, zero,
                                _wf(m, 'tendon_invweight0', tens, dev),
                                _wf(m, 'tendon_solref_fri', tens, dev),
                                _wf(m, 'tendon_solimp_fri', tens, dev), 0.0,
                                d.ten_velocity[:, tt])
    rows.set(m.efc.fri_ten_adr, d.ten_J[:, tt], posv, torch.zeros_like(posv),
             D, aref, _wf(m, 'tendon_frictionloss', tens, dev),
             torch.ones((n,), dtype=torch.bool, device=dev))


def _limit_tendon(m, d, rows):
  """Tendon limit rows on the nearer side of each range
  (``constraint.py:665-681``)."""
  tids = m.efc.lim_ten_id
  if not len(tids):
    return
  dev = d.qpos.device
  tt = ix(tids, dev)
  margin = _wf(m, 'tendon_margin', tids, dev)
  trange = _wf(m, 'tendon_range', tids, dev)
  ln = d.ten_length[:, tt]
  dist_min = ln - trange[..., 0]
  dist_max = trange[..., 1] - ln
  pos = torch.minimum(dist_min, dist_max) - margin
  Jsign = torch.where(dist_min < dist_max, 1.0, -1.0).to(ln.dtype)
  J = Jsign[..., None] * d.ten_J[:, tt]
  Jqvel = torch.einsum('wnv,wv->wn', J, d.qvel)
  D, aref, posv = _row_values(m, pos, pos,
                              _wf(m, 'tendon_invweight0', tids, dev),
                              _wf(m, 'tendon_solref_lim', tids, dev),
                              _wf(m, 'tendon_solimp_lim', tids, dev), margin,
                              Jqvel)
  rows.set(m.efc.lim_ten_adr, J, posv, margin, D, aref, None, pos < 0)


def _limit(m, d, rows):
  """Joint limit rows, hinge/slide and ball (``constraint.py:619``), then
  the tendon limit rows."""
  _limit_tendon(m, d, rows)
  jids = m.efc.lim_jnt_id
  if not len(jids):
    return
  dev, dt = d.qpos.device, d.qpos.dtype
  W, n = d.qpos.shape[0], len(jids)
  tj = ix(jids, dev)
  jt = m.jnt_type[jids]
  qadr, dadr = m.jnt_qposadr[jids], m.jnt_dofadr[jids]
  margin = _wf(m, 'jnt_margin', jids, dev)
  jrange = _wf(m, 'jnt_range', jids, dev)
  qp = d.qpos[:, ix(qadr, dev)]
  dist_min = qp - jrange[..., 0]
  dist_max = jrange[..., 1] - qp
  pos_sh = torch.minimum(dist_min, dist_max) - margin
  Jsign = torch.where(dist_min < dist_max, 1.0, -1.0).to(dt)
  is_ball = jt == _JT.BALL
  qb = torch.stack([d.qpos[:, ix(np.minimum(qadr + i, m.nq - 1), dev)]
                    for i in range(4)], -1)
  aa = math.quat_to_vel(math.normalize_quat(qb))
  angle = math.norm(aa)
  axis = aa / torch.clamp(angle, min=1e-12)[..., None]
  pos_ball = torch.maximum(jrange[..., 0], jrange[..., 1]) - angle - margin
  ball_t = bmask(is_ball, dev)
  pos = torch.where(ball_t, pos_ball, pos_sh)
  active = pos < 0
  J = torch.zeros((W, n, m.nv), dtype=dt, device=dev)
  ar = ix(np.arange(n), dev)
  ball_mask = fmask(is_ball.astype(np.float32), d.qpos)
  J[:, ar, ix(dadr, dev)] = torch.where(ball_t, -axis[..., 0], Jsign)
  for i in (1, 2):
    col = ix(np.minimum(dadr + i, m.nv - 1), dev)
    J[:, ar, col] = J[:, ar, col] + (-axis[..., i] * ball_mask)
  Jqvel = torch.einsum('wnv,wv->wn', J, d.qvel)
  td = ix(dadr, dev)
  D, aref, posv = _row_values(m, pos, pos,
                              _wf(m, 'dof_invweight0', dadr, dev),
                              _wf(m, 'jnt_solref', jids, dev),
                              _wf(m, 'jnt_solimp', jids, dev), margin, Jqvel)
  rows.set(m.efc.lim_jnt_adr, J, posv, margin, D, aref, None, active)


def _contact(m, d, rows):
  """Contact rows over the contact slots (``constraint.py:777``), each
  slot's bodies from its world's ``contact.geom1/geom2``: the
  frame-projected Jacobian of the two bodies without the (k, nv, 3) point
  Jacobians; frictionless rows n, pyramidal rows n +- mu_i d_i (condim 3,
  4 and 6: 4, 6 and 10 rows), elliptic rows [n, t1, t2, r1, r2, r3][:dim]
  (:883-905)."""
  is_elliptic = m.opt.cone == types.ConeType.ELLIPTIC
  con, dev, dt = d.contact, d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  impratio_inv = 1.0 / torch.clamp(types.world_field(m, 'opt.impratio'),
                                   min=MJ_MINVAL)[:, None]  # (1 or W, 1)
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]  # (W, nv, 3)
  dims = np.asarray(m.con_dim)
  # each world's slots hold its own geom pairs (under compaction)
  cb1, cb2 = smooth.contact_bodies(m, d)
  wid = torch.arange(W, device=dev)[:, None]
  bdm = fmask(m.tree.body_dof_mask, d.qpos)
  roots = ix(m.body_rootid, dev)
  iw0 = types.world_field(m, 'body_invweight0')[..., 0].expand(
      W, m.nbody)
  for dim in np.unique(dims):
    dim = int(dim)
    idx = np.nonzero(dims == dim)[0]
    k, ti = len(idx), ix(idx, dev)
    body1, body2 = cb1[:, ti], cb2[:, ti]  # (W, k)
    pos, frame = con.pos[:, ti], con.frame[:, ti]  # (W, k, 3), (W, k, 3, 3)
    dist, margin = con.dist[:, ti], con.includemargin[:, ti]
    cpos = dist - margin
    active = dist < margin
    invweight = torch.gather(iw0, 1, body1) + torch.gather(iw0, 1, body2)
    Fl = torch.einsum('wkij,wvj->wkiv', frame, lin)
    Fa = torch.einsum('wkij,wvj->wkiv', frame, ang)

    def proj(body):
      mask = bdm[body][:, :, None, :]
      off = pos - d.subtree_com[wid, roots[body]]
      w = math.cross(off[:, :, None, :], frame)  # off x each frame row
      return ((Fl + torch.einsum('wkij,wvj->wkiv', w, ang)) * mask,
              Fa * mask)

    Jp1, Jr1 = proj(body1)
    Jp2, Jr2 = proj(body2)
    Jp, Jr = Jp2 - Jp1, Jr2 - Jr1  # (W, k, 3, nv): rows n, t1, t2
    friction = con.friction[:, ti]
    solref, solimp = con.solref[:, ti], con.solimp[:, ti]
    ref = solref[:, :, None, :]
    pos_aref = cpos[..., None].expand(W, k, 1)
    if dim == 1:
      nrow = 1
      Jrows = Jp[:, :, :1]
      iw = invweight[..., None]
    elif is_elliptic:
      nrow = dim
      parts = [Jp[:, :, 0], Jp[:, :, 1], Jp[:, :, 2], Jr[:, :, 0],
               Jr[:, :, 1], Jr[:, :, 2]]
      Jrows = torch.stack(parts[:dim], dim=2)  # (W, k, dim, nv)
      # friction-row invweights (reference :4268-4285)
      iw_f = invweight * impratio_inv
      iw_list = [invweight.expand(W, k), iw_f.expand(W, k)]
      for o in range(2, dim):
        fri0, frii = friction[:, :, 0], friction[:, :, o - 1]
        iw_list.append(iw_f * fri0 * fri0 /
                       torch.clamp(frii * frii, min=MJ_MINVAL))
      iw = torch.stack(iw_list, dim=-1)
      srf = con.solreffriction[:, ti]
      has_srf = (srf[..., 0:1] != 0) | (srf[..., 1:2] != 0)
      fref = torch.where(has_srf, srf, solref)
      ref = torch.cat([solref[:, :, None, :],
                       fref[:, :, None, :].expand(W, k, dim - 1, types.NREF)],
                      dim=2)
      pos_aref = torch.cat([cpos[..., None],
                            torch.zeros((W, k, dim - 1), dtype=dt,
                                        device=dev)], dim=-1)
    else:
      nrow = 2 * (dim - 1)
      dirs = [Jp[:, :, 1], Jp[:, :, 2], Jr[:, :, 0], Jr[:, :, 1],
              Jr[:, :, 2]]
      Jrows = torch.stack(
          [Jp[:, :, 0] + (1.0 - 2.0 * float(o & 1)) *
           friction[:, :, o // 2][..., None] * dirs[o // 2]
           for o in range(nrow)], dim=2)  # (W, k, nrow, nv)
      fri0 = friction[:, :, 0]
      iw = invweight + fri0 * fri0 * invweight
      iw = (iw * 2.0 * fri0 * fri0 * impratio_inv)[..., None]
    Jqvel = torch.einsum('wkrv,wv->wkr', Jrows, d.qvel)
    shape = (W, k, nrow)
    D, aref, posv = _row_values(
        m, pos_aref.expand(shape), cpos[..., None], iw, ref,
        solimp[:, :, None, :], margin[..., None], Jqvel)
    adr = (m.con_efc_address[idx][:, None] + np.arange(nrow)).reshape(-1)
    flat = lambda x: x.expand(shape).reshape(W, k * nrow)
    rows.set(adr, Jrows.reshape(W, k * nrow, m.nv), flat(posv),
             flat(margin[..., None]), flat(D), flat(aref), None,
             flat(active[..., None]))


def make_constraint(m: types.Model, d: types.Data) -> types.Data:
  """The EFC system of equality, friction-loss, limit and contact rows
  (``constraint.py:919``)."""
  rows = _Rows(m, d)
  dsbl = m.opt.disableflags
  if m.nefc and not (dsbl & types.DisableBit.CONSTRAINT):
    if len(m.efc.flex_id):
      raise NotImplementedError('flex rows are not ported yet')
    if m.neq and not (dsbl & types.DisableBit.EQUALITY):
      cdof_dot = _cdof_dot_jac(m, d)
      _equality_connect(m, d, rows, cdof_dot)
      _equality_weld(m, d, rows, cdof_dot)
      _equality_joint(m, d, rows)
      _equality_tendon(m, d, rows)
    if m.nf and not (dsbl & types.DisableBit.FRICTIONLOSS):
      _friction(m, d, rows)
    if m.nl and not (dsbl & types.DisableBit.LIMIT):
      _limit(m, d, rows)
    if m.ncon and not (dsbl & types.DisableBit.CONTACT):
      _contact(m, d, rows)
  return d.replace(efc_J=rows.J, efc_pos=rows.pos, efc_margin=rows.margin,
                   efc_D=rows.D, efc_aref=rows.aref,
                   efc_frictionloss=rows.frictionloss,
                   efc_active=rows.active)
