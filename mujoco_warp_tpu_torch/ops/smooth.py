"""Smooth dynamics stages of the general step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/smooth.py``: ``kinematics`` (:36,
site frames included), ``com_pos`` (:131), ``camlight`` (:189, all five
camera and light modes), ``rne_postconstraint`` (:406) with
``_contact_forces_local`` / ``_contact_forces`` (:466, :507),
``transmission`` (:857) and ``factor_m`` / ``solve_m`` / ``mul_m``
(:301-330).  The mass chain (crb,
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
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, ix

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
  site_xpos, site_xmat = d.site_xpos, d.site_xmat
  if m.nsite:
    sb = ix(m.site_bodyid, dev)
    site_xpos = xpos[:, sb] + math.rot_vec_quat(m.site_pos, xquat[:, sb])
    site_xmat = math.quat_to_mat(math.mul_quat(xquat[:, sb], m.site_quat))
  return d.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                   ximat=ximat, xanchor=xanchor, xaxis=xaxis,
                   geom_xpos=geom_xpos, geom_xmat=geom_xmat,
                   site_xpos=site_xpos, site_xmat=site_xmat)


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


def _camlight_frames(d, mode, bodyid, targetid, pos, rot, poscom0, pos0,
                     rot0, is_cam):
  """World frames of a camera (``rot`` a quaternion, ``rot0`` its mat0)
  or light (``rot`` its dir, ``rot0`` its dir0) batch in the five modes:
  0 fixed to the body, 1 track (world orientation, offset from the body),
  2 trackcom (offset from the subtree CoM), 3 targetbody and 4
  targetbodycom (aimed at a body or its subtree CoM)."""
  dev = d.qpos.device
  b = ix(bodyid, dev)
  xquat = d.xquat[:, b]
  xpos = d.xpos[:, b] + math.rot_vec_quat(pos, xquat)
  if is_cam:
    xrot = math.quat_to_mat(math.mul_quat(xquat, rot))
  else:
    xrot = math.rot_vec_quat(rot, xquat)
  track, trackcom = mode == 1, mode == 2
  if np.any(track | trackcom):
    tp = d.xpos[:, b] + pos0
    tc = d.subtree_com[:, b] + poscom0
    xpos = torch.where(bmask(track, dev)[:, None], tp,
                       torch.where(bmask(trackcom, dev)[:, None], tc, xpos))
    sel = bmask(track | trackcom, dev)
    xrot = torch.where(sel[:, None, None] if is_cam else sel[:, None], rot0,
                       xrot)
  target = (mode == 3) | (mode == 4)
  if np.any(target):
    tid = ix(np.maximum(targetid, 0), dev)
    tpos = torch.where(bmask(mode == 4, dev)[:, None], d.subtree_com[:, tid],
                       d.xpos[:, tid])
    sel = bmask(target, dev)
    if is_cam:  # -z toward the target, x level with the world's z
      z = xpos - tpos
      z = z / torch.clamp(math.norm(z, keepdim=True), min=1e-12)
      x = math.cross(fmask([0.0, 0.0, 1.0], z).expand(z.shape), z)
      xn = math.norm(x, keepdim=True)
      x = torch.where(xn > 1e-9, x / torch.clamp(xn, min=1e-12),
                      fmask([1.0, 0.0, 0.0], z).expand(z.shape))
      tmat = torch.stack([x, math.cross(z, x), z], dim=-1)
      xrot = torch.where(sel[:, None, None], tmat, xrot)
    else:
      dirv = tpos - xpos
      dirv = dirv / torch.clamp(math.norm(dirv, keepdim=True), min=1e-12)
      xrot = torch.where(sel[:, None], dirv, xrot)
  return xpos, xrot


def camlight(m: types.Model, d: types.Data) -> types.Data:
  """Camera and light frames (``smooth.py:189``)."""
  out = {}
  if m.ncam:
    out['cam_xpos'], out['cam_xmat'] = _camlight_frames(
        d, m.cam_mode, m.cam_bodyid, m.cam_targetbodyid, m.cam_pos,
        m.cam_quat, m.cam_poscom0, m.cam_pos0, m.cam_mat0, True)
  if m.nlight:
    out['light_xpos'], out['light_xdir'] = _camlight_frames(
        d, m.light_mode, m.light_bodyid, m.light_targetbodyid, m.light_pos,
        m.light_dir, m.light_poscom0, m.light_pos0, m.light_dir0, False)
  return d.replace(**out) if out else d


def _per_world(x, idx):
  """x (W, n, ...) gathered at per-world indices idx (W, k)."""
  w = torch.arange(x.shape[0], device=x.device)[:, None]
  return x[w, idx]


def contact_bodies(m: types.Model, d: types.Data):
  """The bodies of each contact slot's two geoms, (W, ncon) each: per
  world under compaction, the candidate table's otherwise."""
  gb = ix(m.geom_bodyid, d.qpos.device)
  con = d.contact
  return gb[con.geom1.long()], gb[con.geom2.long()]


def contact_forces_local(m: types.Model, d: types.Data) -> torch.Tensor:
  """Contact-frame wrenches [fn, ft1, ft2, tn, tt1, tt2] per slot, (W,
  ncon, 6) (``smooth.py:466``): from the efc_force rows at each slot's
  ``con_efc_address``; pyramidal forces summed into the normal and
  mu_i (f+ - f-) along each direction."""
  con, f = d.contact, d.efc_force
  W, dev = f.shape[0], f.device
  out = torch.zeros((W, m.ncon, 6), dtype=f.dtype, device=dev)
  is_elliptic = m.opt.cone == types.ConeType.ELLIPTIC
  dims = np.asarray(m.con_dim)
  for dim in np.unique(dims):
    dim = int(dim)
    idx = np.nonzero(dims == dim)[0]
    adr = m.con_efc_address[idx]
    nrow = 1 if dim == 1 else dim if is_elliptic else 2 * (dim - 1)
    rows = f[:, ix(adr[:, None] + np.arange(nrow), dev)]  # (W, k, nrow)
    ti = ix(idx, dev)
    if dim == 1 or is_elliptic:
      out[:, ti, :nrow] = rows
    else:
      fric = con.friction[:, ti]
      comps = [rows.sum(-1)] + [fric[..., i] * (rows[..., 2 * i] -
                                                rows[..., 2 * i + 1])
                                for i in range(dim - 1)]
      out[:, ti, :dim] = torch.stack(comps, -1)
  return out


def contact_forces(m: types.Model, d: types.Data) -> torch.Tensor:
  """World-frame contact wrenches (torque, force) at each contact point,
  (W, ncon, 6) (``smooth.py:507``)."""
  local = contact_forces_local(m, d)
  frame = d.contact.frame  # rows: normal, t1, t2
  f_w = torch.einsum('wnij,wni->wnj', frame, local[..., :3])
  t_w = torch.einsum('wnij,wni->wnj', frame, local[..., 3:])
  return torch.cat([t_w, f_w], -1)


def rne_postconstraint(m: types.Model, d: types.Data) -> types.Data:
  """cacc, cfrc_ext and cfrc_int after the solve (``smooth.py:406``):
  applied wrenches plus contact forces (as the JAX package, without the
  connect and weld reactions), the com-frame accelerations from qacc, and
  each subtree's net force, over the static tree masks."""
  dev, dt = d.qpos.device, d.qpos.dtype
  W, nb = d.qpos.shape[0], m.nbody
  root = ix(m.body_rootid, dev)
  force, torque = d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:]
  offset = d.xipos - d.subtree_com[:, root]
  cfrc_ext = torch.cat([torque + math.cross(offset, force), force], -1)
  if m.ncon and d.contact is not None and \
      not (m.opt.disableflags & types.DisableBit.CONTACT):
    con = d.contact
    forces = contact_forces(m, d)
    b1, b2 = contact_bodies(m, d)
    active = (con.dist < con.includemargin)[..., None]
    # the wrench acts on body2 (J = jac2 - jac1) and against body1, each
    # translated to its com-rooted frame
    for bodies, sign in ((b2, 1.0), (b1, -1.0)):
      off = con.pos - _per_world(d.subtree_com, root[bodies])
      ang = forces[..., :3] + math.cross(off, forces[..., 3:])
      w = sign * torch.where(active, torch.cat([ang, forces[..., 3:]], -1),
                             torch.zeros((), dtype=dt, device=dev))
      cfrc_ext = cfrc_ext + torch.zeros((W, nb, 6), dtype=dt,
                                        device=dev).scatter_add_(
          1, bodies[..., None].expand(W, m.ncon, 6), w)
  g = torch.zeros(6, dtype=dt, device=dev)
  if not (m.opt.disableflags & types.DisableBit.GRAVITY):
    g = torch.cat([g[:3], -m.opt.gravity.to(dt)])
  bd = fmask(m.tree.body_dof_mask, d.qpos)  # (nbody, nv)
  cacc = g + torch.einsum('bv,wvi->wbi', bd,
                          d.cdof_dot * d.qvel[..., None] +
                          d.cdof * d.qacc[..., None])
  cacc[:, 0] = 0.0
  iv = torch.einsum('wbij,wbj->wbi', d.cinert, d.cvel)
  ia = torch.einsum('wbij,wbj->wbi', d.cinert, cacc)
  cfrc_body = ia + math.motion_cross_force(d.cvel, iv)
  sub = fmask(m.tree.subtree_mask, d.qpos)
  cfrc_int = torch.einsum('sb,wbi->wsi', sub, cfrc_body - cfrc_ext)
  cfrc_int[:, 0] = 0.0
  return d.replace(cacc=cacc, cfrc_int=cfrc_int, cfrc_ext=cfrc_ext)


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
