"""Smooth dynamics stages of the general step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/smooth.py``: ``kinematics`` (:36,
site frames included), ``com_pos`` (:131), ``camlight`` (:189, all five
camera and light modes), ``rne_postconstraint`` (:406) with
``_contact_forces_local`` / ``_contact_forces`` (:466, :507), ``tendon``
(:760) with the wrap helpers ``_wrap_2d_circle`` (:529),
``_wrap_2d_inside`` (:603) and ``_wrap_geom`` (:688), ``transmission``
(:857: joint, tendon, site, slider-crank and body), ``tendon_armature`` (:1060), ``tendon_bias``
(:1099), ``factor_m`` / ``solve_m`` / ``mul_m`` (:301-330) and
``com_vel`` / ``rne`` (:360, :378).  The step's mass chain (crb, qM, its
factor, com_vel and RNE) runs as one kernel (``kernels/mass_chain.py``);
``com_vel`` and ``rne`` here are the differentiable torch forms that the
IMPLICIT integrator's velocity derivative takes (``ops/derivative.py``).
``factor_m`` and ``solve_m`` run the ``chol_batched`` and ``chol_solve``
kernels on CUDA tensors and their plain versions on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.kernels import TableCache
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.ops import math
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, ix

_JT = types.JointType


def kinematics(m: types.Model, d: types.Data) -> types.Data:
  """Forward kinematics, bodies level by level (``smooth.py:36``); qpos0
  and body_ipos per world where they are batched."""
  qpos = d.qpos
  W, dev, dt = qpos.shape[0], qpos.device, qpos.dtype
  nb = m.nbody
  qpos0 = types.world_field(m, 'qpos0')
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
          pos[:, s2] = pos[:, s2] + axis * (qpos[:, qa] -
                                            qpos0[:, qa])[..., None]
          xanchor[:, jj] = anchor
          xaxis[:, jj] = axis
        else:  # HINGE
          anchor = pos[:, s2] + math.rot_vec_quat(m.jnt_pos[jj], quat[:, s2])
          axis = math.rot_vec_quat(m.jnt_axis[jj], quat[:, s2])
          qa = ix(qadr, dev)
          qloc = math.axis_angle_to_quat(m.jnt_axis[jj],
                                         qpos[:, qa] - qpos0[:, qa])
          qnew = math.mul_quat(quat[:, s2], qloc)
          pos[:, s2] = anchor - math.rot_vec_quat(m.jnt_pos[jj], qnew)
          quat[:, s2] = qnew
          xanchor[:, jj] = anchor
          xaxis[:, jj] = axis
    xpos[:, tid] = pos
    xquat[:, tid] = math.normalize_quat(quat)

  xmat = math.quat_to_mat(xquat)
  xipos = xpos + math.rot_vec_quat(types.world_field(m, 'body_ipos'), xquat)
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
  """Subtree CoM, spatial inertia and dof axes (``smooth.py:131``); the
  masses, inertias and subtree masses per world where they are
  batched."""
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  mass = types.world_field(m, 'body_mass')  # (1 or W, nbody)
  wpos = mass[..., None] * d.xipos
  sub = fmask(m.tree.subtree_mask, d.qpos)
  subtree_com = (sub @ wpos) / torch.clamp(types.world_field(
      m, 'body_subtreemass'), min=1e-12)[..., None]
  root_com = subtree_com[:, ix(m.body_rootid, dev)]
  offset = d.xipos - root_com
  cinert = math.inert_matrix(types.world_field(m, 'body_inertia'), mass,
                             offset, d.ximat)

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
  g = torch.zeros((1, 1, 6), dtype=dt, device=dev)
  if not (m.opt.disableflags & types.DisableBit.GRAVITY):
    grav = types.world_field(m, 'opt.gravity').to(dt)[:, None]
    g = torch.cat([torch.zeros_like(grav), -grav], -1)  # (1 or W, 1, 6)
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


# ------------------------------------------------------------------ tendons


def _wrap_2d_circle(e0x, e0y, e1x, e1y, side, radius):
  """The 2D circle wrap of ``smooth.py:529`` (MuJoCo's ``wrap_circle``)
  on (W, n) components: the two end points, the side point (a pair of
  (W, n) components, or None) and the radius (n,).  Returns (wlen, pnt0,
  pnt1), the points as pairs of components, wlen -1 where the segment does
  not wrap."""
  dot2 = lambda ax, ay, bx, by: ax * bx + ay * by
  sqlen0, sqlen1 = dot2(e0x, e0y, e0x, e0y), dot2(e1x, e1y, e1x, e1y)
  sqrad = radius * radius
  no_wrap = (sqlen0 < sqrad) | (sqlen1 < sqrad) | (radius < 1e-15)
  dx, dy = e1x - e0x, e1y - e0y
  dd = dot2(dx, dy, dx, dy)
  no_wrap = no_wrap | (dd < 1e-15)
  a = torch.clamp(-dot2(dx, dy, e0x, e0y) / torch.clamp(dd, min=1e-15),
                  0.0, 1.0)
  tx, ty = a * dx + e0x, a * dy + e0y
  far = dot2(tx, ty, tx, ty) > sqrad
  if side is None:
    no_wrap = no_wrap | far
  else:
    no_wrap = no_wrap | (far & (dot2(side[0], side[1], tx, ty) >= 0.0))
  sqrt0 = torch.sqrt(torch.clamp(sqlen0 - sqrad, min=0.0))
  sqrt1 = torch.sqrt(torch.clamp(sqlen1 - sqrad, min=0.0))
  sl0 = torch.clamp(sqlen0, min=1e-15)
  sl1 = torch.clamp(sqlen1, min=1e-15)
  sol00 = ((e0x * sqrad + radius * e0y * sqrt0) / sl0,
           (e0y * sqrad - radius * e0x * sqrt0) / sl0)
  sol01 = ((e1x * sqrad - radius * e1y * sqrt1) / sl1,
           (e1y * sqrad + radius * e1x * sqrt1) / sl1)
  sol10 = ((e0x * sqrad - radius * e0y * sqrt0) / sl0,
           (e0y * sqrad + radius * e0x * sqrt0) / sl0)
  sol11 = ((e1x * sqrad + radius * e1y * sqrt1) / sl1,
           (e1y * sqrad - radius * e1x * sqrt1) / sl1)

  def seg_intersect(p1, p2, p3, p4):
    d1 = (p4[0] - p3[0]) * (p1[1] - p3[1]) - (p4[1] - p3[1]) * (p1[0] - p3[0])
    d2 = (p4[0] - p3[0]) * (p2[1] - p3[1]) - (p4[1] - p3[1]) * (p2[0] - p3[0])
    d3 = (p2[0] - p1[0]) * (p3[1] - p1[1]) - (p2[1] - p1[1]) * (p3[0] - p1[0])
    d4 = (p2[0] - p1[0]) * (p4[1] - p1[1]) - (p2[1] - p1[1]) * (p4[0] - p1[0])
    return (d1 * d2 < 0) & (d3 * d4 < 0)

  def unit(x, y):
    n = torch.clamp(torch.sqrt(x * x + y * y), min=1e-15)
    return x / n, y / n

  if side is None:
    t0 = (sol00[0] - sol01[0], sol00[1] - sol01[1])
    good0 = -dot2(*t0, *t0)
    t1 = (sol10[0] - sol11[0], sol10[1] - sol11[1])
    good1 = -dot2(*t1, *t1)
  else:
    good0 = dot2(*unit(sol00[0] + sol01[0], sol00[1] + sol01[1]), *side)
    good1 = dot2(*unit(sol10[0] + sol11[0], sol10[1] + sol11[1]), *side)
  end0, end1 = (e0x, e0y), (e1x, e1y)
  good0 = torch.where(seg_intersect(end0, sol00, end1, sol01), -1e4, good0)
  good1 = torch.where(seg_intersect(end0, sol10, end1, sol11), -1e4, good1)
  use0 = good0 > good1
  pnt0 = tuple(torch.where(use0, u, v) for u, v in zip(sol00, sol10))
  pnt1 = tuple(torch.where(use0, u, v) for u, v in zip(sol01, sol11))
  no_wrap = no_wrap | seg_intersect(end0, pnt0, end1, pnt1)
  # the arc's length (MuJoCo's ``length_circle``)
  p0n, p1n = unit(*pnt0), unit(*pnt1)
  angle = torch.arccos(torch.clamp(dot2(*p0n, *p1n), -1.0, 1.0))
  cross = pnt0[1] * pnt1[0] - pnt0[0] * pnt1[1]
  flip = torch.where(use0, cross < 0.0, cross > 0.0)
  angle = torch.where(flip, 2.0 * np.pi - angle, angle)
  return torch.where(no_wrap, -1.0, radius * angle), pnt0, pnt1


# the inside wrap's fixed Newton (``smooth.py:603``): iterations, start,
# tolerance
_INSIDE_ITER, _INSIDE_Z0, _INSIDE_TOL = 20, 1.0 - 1e-7, 1e-6


def _wrap_2d_inside(e0x, e0y, e1x, e1y, radius):
  """The 2D inside wrap of ``smooth.py:603`` (MuJoCo's ``wrap_inside``):
  the side point lies inside the circle, and the tendon touches it from
  within at one point, which solves asin(A z) + asin(B z) - 2 asin(z) + G
  = 0 by a masked Newton of ``_INSIDE_ITER`` steps.  Returns (wlen, pnt,
  pnt): wlen 0 where it wraps, -1 where it does not."""
  eps = 1e-15
  len0 = torch.sqrt(e0x * e0x + e0y * e0y)
  len1 = torch.sqrt(e1x * e1x + e1y * e1y)
  dx, dy = e1x - e0x, e1y - e0y
  dd = dx * dx + dy * dy
  no_wrap = ((len0 <= radius) | (len1 <= radius) | (radius < eps) |
             (len0 < eps) | (len1 < eps))
  a = -(dx * e0x + dy * e0y) / torch.clamp(dd, min=eps)
  tx, ty = e0x + a * dx, e0y + a * dy
  no_wrap = no_wrap | ((dd > eps) & (a > 0.0) & (a < 1.0) &
                       (torch.sqrt(tx * tx + ty * ty) <= radius))
  # the point where the iteration fails: the ends' mean on the circle
  px, py = 0.5 * (e0x + e1x), 0.5 * (e0y + e1y)
  pn = torch.clamp(torch.sqrt(px * px + py * py), min=eps)
  pdef = (px / pn * radius, py / pn * radius)
  A = radius / torch.clamp(len0, min=eps)
  B = radius / torch.clamp(len1, min=eps)
  cosG = (len0 * len0 + len1 * len1 - dd) / torch.clamp(2.0 * len0 * len1,
                                                        min=eps)
  no_wrap = no_wrap | (cosG < -1.0 + eps)
  use_default = cosG > 1.0 - eps
  G = torch.arccos(torch.clamp(cosG, -1.0, 1.0))
  asin = lambda x: torch.arcsin(torch.clamp(x, -1.0, 1.0))
  feval = lambda z: asin(A * z) + asin(B * z) - 2.0 * asin(z) + G
  z = torch.full_like(G, _INSIDE_Z0)
  f = feval(z)
  use_default = use_default | (f > 0.0)
  fail = torch.zeros_like(no_wrap)
  done = torch.zeros_like(no_wrap)
  root = lambda x: torch.clamp(torch.sqrt(torch.clamp(x, min=0.0)), min=eps)
  for _ in range(_INSIDE_ITER):
    sq_z = z * z
    df = (A / root(1.0 - sq_z * A * A) + B / root(1.0 - sq_z * B * B) -
          2.0 / root(1.0 - sq_z))
    bad = df > -eps
    z1 = z - f / torch.where(bad, -1.0, df)
    bad = bad | (z1 > z)
    conv = torch.abs(f) <= _INSIDE_TOL
    zn = torch.where(done | conv | bad, z, z1)
    fn = feval(zn)
    bad = bad | (fn > _INSIDE_TOL)
    fail = fail | (bad & ~done & ~conv)
    done = done | conv | bad
    z, f = zn, fn
  use_default = use_default | fail | (torch.abs(f) > _INSIDE_TOL)
  # rotate from end0 or end1 by the winding's sign
  cw = e0x * e1y - e0y * e1x > 0.0
  vx, vy = torch.where(cw, e0x, e1x), torch.where(cw, e0y, e1y)
  ang = asin(z) - asin(torch.where(cw, A, B) * z)
  vn = torch.clamp(torch.sqrt(vx * vx + vy * vy), min=eps)
  vx, vy = vx / vn, vy / vn
  pnt = (radius * (torch.cos(ang) * vx - torch.sin(ang) * vy),
         radius * (torch.sin(ang) * vx + torch.cos(ang) * vy))
  pnt = tuple(torch.where(use_default, u, v) for u, v in zip(pdef, pnt))
  return torch.where(no_wrap, -1.0, 0.0), pnt, pnt


def _wrap_geom(x0, x1, pos, mat, radius, is_sphere: bool, side,
               side_kind: str):
  """The 3D wrap of a segment around spheres or cylinders
  (``smooth.py:688``): x0, x1, pos (W, n, 3), mat (W, n, 3, 3), radius
  (n,), side (W, n, 3) or None.  ``side_kind`` (``_tendon_plan``): 'none',
  or where the sidesites lie: 'outside' or 'inside' the geom (each
  computes only its wrap), 'either' (both, chosen per world).  Returns
  (wlen (W, n), wpnt0, wpnt1 (W, n, 3)); wlen < 0 where the segment runs
  straight."""
  p0 = torch.einsum('wnji,wnj->wni', mat, x0 - pos)
  p1 = torch.einsum('wnji,wnj->wni', mat, x1 - pos)
  unit = lambda v: v / torch.clamp(math.norm(v, keepdim=True), min=1e-15)
  if is_sphere:
    axis0 = unit(p0)
    normal = math.cross(p0, p1)
    nrm = math.norm(normal, keepdim=True)
    # parallel ends: an axis orthogonal to axis0's largest component
    k = torch.argmax(torch.abs(axis0), dim=-1, keepdim=True)
    alt1 = torch.ones_like(axis0).scatter(-1, k, 0.0)
    altn = unit(math.cross(axis0, alt1))
    normal = torch.where(nrm < 1e-15, altn,
                         normal / torch.clamp(nrm, min=1e-15))
    axis1 = unit(math.cross(normal, axis0))
  else:
    axis0 = fmask([1.0, 0.0, 0.0], p0).expand(p0.shape)
    axis1 = fmask([0.0, 1.0, 0.0], p0).expand(p0.shape)
  dot = lambda a, b: torch.sum(a * b, -1)
  end = (dot(p0, axis0), dot(p0, axis1), dot(p1, axis0), dot(p1, axis1))
  if side_kind == 'none':
    wlen, pnt0, pnt1 = _wrap_2d_circle(*end, None, radius)
  elif side_kind == 'inside':  # the inside wrap (MuJoCo util_misc.py:421)
    wlen, pnt0, pnt1 = _wrap_2d_inside(*end, radius)
  else:
    sidep = torch.einsum('wnji,wnj->wni', mat, side - pos)
    sx, sy = dot(sidep, axis0), dot(sidep, axis1)
    sn = torch.clamp(torch.sqrt(sx * sx + sy * sy), min=1e-15)
    wlen, pnt0, pnt1 = _wrap_2d_circle(
        *end, (sx / sn * radius, sy / sn * radius), radius)
    if side_kind == 'either':
      inside = math.norm(sidep) < radius
      wlen_i, p0_i, p1_i = _wrap_2d_inside(*end, radius)
      wlen = torch.where(inside, wlen_i, wlen)
      pnt0 = tuple(torch.where(inside, u, v) for u, v in zip(p0_i, pnt0))
      pnt1 = tuple(torch.where(inside, u, v) for u, v in zip(p1_i, pnt1))
  res0 = axis0 * pnt0[0][..., None] + axis1 * pnt0[1][..., None]
  res1 = axis0 * pnt1[0][..., None] + axis1 * pnt1[1][..., None]
  if not is_sphere:
    L0 = torch.sqrt((p0[..., 0] - res0[..., 0]) ** 2 +
                    (p0[..., 1] - res0[..., 1]) ** 2)
    L1 = torch.sqrt((p1[..., 0] - res1[..., 0]) ** 2 +
                    (p1[..., 1] - res1[..., 1]) ** 2)
    denom = torch.clamp(L0 + wlen + L1, min=1e-15)
    z0 = p0[..., 2] + (p1[..., 2] - p0[..., 2]) * L0 / denom
    z1 = p0[..., 2] + (p1[..., 2] - p0[..., 2]) * (L0 + wlen) / denom
    res0 = torch.stack([res0[..., 0], res0[..., 1], z0], -1)
    res1 = torch.stack([res1[..., 0], res1[..., 1], z1], -1)
    height = torch.abs(z1 - z0)
    wlen = torch.where(wlen >= 0, torch.sqrt(torch.clamp(
        wlen * wlen + height * height, min=0.0)), wlen)
  wpnt0 = torch.einsum('wnij,wnj->wni', mat, res0) + pos
  wpnt1 = torch.einsum('wnij,wnj->wni', mat, res1) + pos
  return wlen, wpnt0, wpnt1


# a sidesite on its geom's body lies at a fixed distance from the geom's
# centre; nearer its surface than this share of the radius the side is
# decided per world
_SIDE_MARGIN = 1e-3


def _side_kind(m: types.Model, side: int, geom: int) -> str:
  """Where a wrap geom's sidesite lies: 'none', 'outside' or 'inside'
  where the site rides the geom's body (the distance is a constant of the
  model), else 'either'."""
  if side < 0:
    return 'none'
  if m.site_bodyid[side] != m.geom_bodyid[geom]:
    return 'either'
  r = float(types.host(m.geom_size)[geom, 0])
  dist = float(np.linalg.norm(types.host(m.site_pos)[side] -
                              types.host(m.geom_pos)[geom]))
  if abs(dist - r) <= _SIDE_MARGIN * r:
    return 'either'
  return 'inside' if dist < r else 'outside'


def _tendon_plan(m: types.Model, only=None) -> dict:
  """The tendons' static structure, walked once per model: the fixed
  tendons' length and Jacobian as constant (ntendon, nq) and (ntendon,
  nv) maps, and the spatial tendons' straight site-to-site segments and
  wrap geoms, each with its tendon and its branch's divisor (after a
  pulley); the wrap geoms in groups by kind (sphere?, ``_side_kind``).
  ``only``: the spatial tendons to walk (all by default).  A wrap geom
  takes the segment from the site before it to the site after it; the
  sites before that site keep their segments (MuJoCo's semantics; the
  JAX ``smooth.tendon`` drops them, see ``tendon``)."""
  WT = types.WrapType
  prm = types.host(m.wrap_prm)
  seg = {'a': [], 'b': [], 'ten': [], 'div': []}
  wraps = {}
  fixed_q = np.zeros((m.ntendon, m.nq))
  fixed_J = np.zeros((m.ntendon, m.nv))
  for t in range(m.ntendon):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    if np.all(m.wrap_type[adr:adr + num] == WT.JOINT):
      # ``smooth.py:774-781``: each joint's coef summed into the length,
      # set into the Jacobian
      for w in range(adr, adr + num):
        j = int(m.wrap_objid[w])
        fixed_q[t, m.jnt_qposadr[j]] += prm[w]
        fixed_J[t, m.jnt_dofadr[j]] = prm[w]
      continue
    if only is not None and t not in only:
      continue
    div, prev, i = 1.0, None, adr
    while i < adr + num:
      wt, oid = int(m.wrap_type[i]), int(m.wrap_objid[i])
      if wt == WT.SITE:
        if prev is not None:
          for k, v in zip(('a', 'b', 'ten', 'div'), (prev, oid, t, div)):
            seg[k].append(v)
        prev, i = oid, i + 1
      elif wt == WT.PULLEY:
        div, prev, i = float(prm[i]), None, i + 1
      elif wt in (WT.SPHERE, WT.CYLINDER):
        if prev is None:
          raise ValueError(f'tendon {t}: a wrap geom needs a site before it')
        nxt, side = int(m.wrap_objid[i + 1]), int(prm[i])
        key = (wt == WT.SPHERE, _side_kind(m, side, oid))
        g = wraps.setdefault(key, {'s0': [], 's1': [], 'geom': [],
                                   'side': [], 'ten': [], 'div': []})
        for k, v in zip(g, (prev, nxt, oid, side, t, div)):
          g[k].append(v)
        prev, i = nxt, i + 2
      else:
        raise NotImplementedError(f'tendon {t}: wrap type {wt}')
  ar = lambda k, v: np.asarray(v, np.float64 if k == 'div' else np.int64)
  return {'fixed_q': fixed_q, 'fixed_J': fixed_J,
          'seg': {k: ar(k, v) for k, v in seg.items()},
          'wraps': {key: {k: ar(k, v) for k, v in g.items()}
                    for key, g in sorted(wraps.items())}}


_PLANS = TableCache(lambda m, dev: _tendon_plan(m))
# the spatial tendons with armature, whose J-dot ``tendon_bias`` takes
_BIAS_PLANS = TableCache(lambda m, dev: _tendon_plan(m, set(
    np.nonzero(types.host(m.tendon_armature) > 0)[0].tolist())))


def _seg_jac(m: types.Model, d: types.Data, pa, ba, pb, bb, dirn):
  """(W, n, nv): (jacp(pb) - jacp(pa)) dirn for n segments between
  world points pa, pb (W, n, 3) on the static bodies ba, bb (n,), with
  the jacp of ``smooth.py:749`` ``_point_jacp``: (lin + ang x (p -
  subtree_com[root])) masked to the dofs moving the body."""
  dev = d.qpos.device
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]  # (W, nv, 3)

  def proj(p, b):
    off = p - d.subtree_com[:, ix(m.body_rootid[b], dev)]
    mask = fmask(m.tree.body_dof_mask[b], d.qpos)  # (n, nv)
    return (torch.einsum('wvk,wnk->wnv', lin, dirn) +
            torch.einsum('wvk,wnk->wnv', ang, math.cross(off, dirn))) * mask
  return proj(pb, bb) - proj(pa, ba)


def _segments(m, d, pa, ba, pb, bb):
  """Length (W, n) and J row (W, n, nv) of straight segments."""
  s = pb - pa
  ln = math.norm(s)
  dirn = s / torch.clamp(ln, min=1e-15)[..., None]
  return ln, _seg_jac(m, d, pa, ba, pb, bb, dirn)


def _wrapped(m: types.Model, d: types.Data, g: dict, key):
  """One group of wrap geoms (``_tendon_plan``'s key: sphere?, side
  kind): (wlen (W, n), the lengths (W, n) and J rows (W, n, nv) of their
  paths, each over its branch's divisor)."""
  dev = d.qpos.device
  s0, s1, geom = g['s0'], g['s1'], g['geom']
  x0, x1 = d.site_xpos[:, ix(s0, dev)], d.site_xpos[:, ix(s1, dev)]
  b0, b1, gb = m.site_bodyid[s0], m.site_bodyid[s1], m.geom_bodyid[geom]
  gi = ix(geom, dev)
  side = d.site_xpos[:, ix(np.maximum(g['side'], 0), dev)]
  wlen, w0, w1 = _wrap_geom(x0, x1, d.geom_xpos[:, gi], d.geom_xmat[:, gi],
                            m.geom_size[gi, 0], key[0], side, key[1])
  wrapped = wlen >= 0
  l_a, J_a = _segments(m, d, x0, b0, w0, gb)
  l_b, J_b = _segments(m, d, w1, gb, x1, b1)
  l_s, J_s = _segments(m, d, x0, b0, x1, b1)
  div = fmask(g['div'], d.qpos)
  length = torch.where(wrapped, (l_a + torch.clamp(wlen, min=0.0) + l_b) / div,
                       l_s / div)
  J = torch.where(wrapped[..., None], (J_a + J_b) / div[:, None],
                  J_s / div[:, None])
  return wlen, length, J


def tendon_wraps(m: types.Model, d: types.Data) -> dict:
  """Does each wrap geom's segment wrap (wlen >= 0)?  A (W, n) bool
  tensor per group of wrap geoms, keyed (sphere?, side kind) as in
  ``_tendon_plan``; for diagnostics and tests."""
  plan = _PLANS.get(m, d.qpos.device)
  return {key: _wrapped(m, d, g, key)[0] >= 0
          for key, g in plan['wraps'].items()}


def _spatial(m: types.Model, d: types.Data, plan: dict):
  """The spatial tendons' lengths (W, ntendon) and J (W, ntendon, nv) of
  ``plan``: each segment and wrap summed into its tendon's row (zero
  rows for the others)."""
  dev = d.qpos.device
  W = d.qpos.shape[0]
  length = torch.zeros((W, m.ntendon), dtype=d.qpos.dtype, device=dev)
  J = torch.zeros((W, m.ntendon, m.nv), dtype=d.qpos.dtype, device=dev)
  seg = plan['seg']
  if len(seg['ten']):
    a, b = seg['a'], seg['b']
    ln, Js = _segments(m, d, d.site_xpos[:, ix(a, dev)], m.site_bodyid[a],
                       d.site_xpos[:, ix(b, dev)], m.site_bodyid[b])
    div = fmask(seg['div'], d.qpos)
    length = length.index_add(1, ix(seg['ten'], dev), ln / div)
    J = J.index_add(1, ix(seg['ten'], dev), Js / div[:, None])
  for key, g in plan['wraps'].items():
    _, ln, Js = _wrapped(m, d, g, key)
    length = length.index_add(1, ix(g['ten'], dev), ln)
    J = J.index_add(1, ix(g['ten'], dev), Js)
  return length, J


def tendon(m: types.Model, d: types.Data) -> types.Data:
  """Tendon lengths and Jacobians, (W, ntendon) and (W, ntendon, nv)
  (``smooth.py:760``).  Fixed tendons are one product with the model's
  constant maps; spatial tendons sum their straight segments and their
  sphere and cylinder wraps (with or without a sidesite, inside it too),
  each group batched over worlds and segments, each branch over its
  pulley's divisor.  One departure from the JAX function, which holds
  MuJoCo's semantics: where a wrap geom follows two or more sites, the
  JAX function drops the segments before the last of them (its chain is
  reset without a flush); here they count, as in MuJoCo C."""
  if not m.ntendon:
    return d
  plan = _PLANS.get(m, d.qpos.device)
  length, J = _spatial(m, d, plan)
  length = length + d.qpos @ fmask(plan['fixed_q'], d.qpos).T
  J = J + fmask(plan['fixed_J'], d.qpos)
  return d.replace(ten_length=length, ten_J=J)


def _has_tendon_armature(m: types.Model) -> bool:
  return bool(m.ntendon) and bool(np.any(types.host(m.tendon_armature) > 0))


def tendon_armature(m: types.Model, d: types.Data) -> types.Data:
  """qM += ten_J^T diag(armature) ten_J (``smooth.py:1060``)."""
  if not _has_tendon_armature(m):
    return d
  A = m.tendon_armature[:, None] * d.ten_J
  return d.replace(qM=d.qM + torch.einsum('wtv,wtu->wvu', d.ten_J, A))


def _ten_J_dot(m: types.Model, d: types.Data, plan: dict) -> torch.Tensor:
  """d(ten_J)/dt (W, ntendon, nv) of the site-to-site segments of
  ``plan``, analytic per segment (MuJoCo's ``_tendon_dot``): with u the
  segment's direction, L its length and dJ = jacp(b) - jacp(a),
  (dJ-dot^T u + dJ^T (I - u u^T) dJ qvel / L) over its divisor; the
  point Jacobians' derivatives from cvel and cdof_dot (``constraint``
  ``_jac_dot``, as the connect rows take them)."""
  from mujoco_warp_tpu_torch.ops import constraint
  dev = d.qpos.device
  seg = plan['seg']
  a, b = seg['a'], seg['b']
  ba, bb = m.site_bodyid[a], m.site_bodyid[b]
  pa, pb = d.site_xpos[:, ix(a, dev)], d.site_xpos[:, ix(b, dev)]
  cdof_dot = constraint._cdof_dot_jac(m, d)
  dJ = constraint._jac(m, d, pb, bb)[0] - constraint._jac(m, d, pa, ba)[0]
  dJd = (constraint._jac_dot(m, d, pb, bb, cdof_dot)[0] -
         constraint._jac_dot(m, d, pa, ba, cdof_dot)[0])  # (W, n, nv, 3)
  s = pb - pa
  L = torch.clamp(math.norm(s), min=1e-15)[..., None]
  u = s / L
  vrel = torch.einsum('wnvk,wv->wnk', dJ, d.qvel)
  udot = (vrel - u * torch.sum(u * vrel, -1, keepdim=True)) / L
  Jdot = (torch.einsum('wnvk,wnk->wnv', dJd, u) +
          torch.einsum('wnvk,wnk->wnv', dJ, udot)) / \
      fmask(seg['div'], d.qpos)[:, None]
  out = torch.zeros((d.qpos.shape[0], m.ntendon, m.nv), dtype=d.qpos.dtype,
                    device=dev)
  return out.index_add(1, ix(seg['ten'], dev), Jdot)


def tendon_bias(m: types.Model, d: types.Data) -> types.Data:
  """qfrc_bias += ten_J^T (armature (d(ten_J)/dt qvel))
  (``smooth.py:1099``), after the mass chain (it reads cvel and
  cdof_dot).  d(ten_J)/dt is analytic per segment (``_ten_J_dot``) for
  the spatial tendons with armature only: a fixed tendon's J is constant,
  and MuJoCo allows no armature on a tendon that wraps a geom.  The JAX
  package takes it by ``jax.jvp`` of kinematics -> com_pos -> tendon; the
  two agree to float32 rounding (tests/test_torch_tendon_mix.py and
  ``test_torch_tendon_step.py``); a forward-mode jvp here took ~300 ms
  of host time per step at 8192 worlds of tendon_mix beside an H100
  80GB HBM3 (PERF.md).  (The JAX jvp runs
  through every tendon and multiplies the others' J-dot by their zero
  armature; where a wrap's branch not taken has a non-finite tangent,
  that gives NaN, see ROADMAP queue 3.)"""
  if not _has_tendon_armature(m):
    return d
  plan = _BIAS_PLANS.get(m, d.qpos.device)
  if not len(plan['seg']['ten']):
    return d  # fixed tendons only: J-dot is 0
  coef = m.tendon_armature * torch.einsum(
      'wtv,wv->wt', _ten_J_dot(m, d, plan), d.qvel)
  return d.replace(qfrc_bias=d.qfrc_bias + torch.einsum(
      'wtv,wt->wv', d.ten_J, coef))


def transmission(m: types.Model, d: types.Data) -> types.Data:
  """Actuator lengths and moment arms (``smooth.py:857``): joint (every
  joint type), tendon (its length and J times gear[0], :920-922), site
  with and without a reference site (:923-943), slider-crank (:944-967)
  and body, which is adhesion (:968); gear per world where it is
  batched."""
  if not m.nu:
    return d
  trn = m.actuator_trntype
  TT = types.TrnType
  is_ten = trn == TT.TENDON
  is_jnt = trn == TT.JOINT
  if not np.all(is_jnt | is_ten | (trn == TT.SITE) |
                (trn == TT.SLIDERCRANK) | (trn == TT.BODY)):
    raise NotImplementedError('the joint-in-parent transmission is not '
                              'ported')
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  tid = m.actuator_trnid[:, 0]
  jt = m.jnt_type[np.where(is_jnt, tid, 0)]
  gear = types.world_field(m, 'actuator_gear')  # (1 or W, nu, 6)
  if np.all(is_jnt) and np.all((jt == _JT.SLIDE) | (jt == _JT.HINGE)):
    qadr, dadr = m.jnt_qposadr[tid], m.jnt_dofadr[tid]
    gear0 = gear[..., 0]
    length = d.qpos[:, ix(qadr, dev)] * gear0
    moment = torch.zeros((W, m.nu, m.nv), dtype=dt, device=dev)
    moment[:, ix(np.arange(m.nu), dev), ix(dadr, dev)] = gear0
    return d.replace(actuator_length=length, actuator_moment=moment)
  length = torch.zeros((W, m.nu), dtype=dt, device=dev)
  moment = torch.zeros((W, m.nu, m.nv), dtype=dt, device=dev)
  if np.any(is_ten):
    u = np.nonzero(is_ten)[0]
    ui, ti = ix(u, dev), ix(tid[u], dev)
    g0 = gear[:, ui, 0]
    length[:, ui] = d.ten_length[:, ti] * g0
    moment[:, ui] = d.ten_J[:, ti] * g0[..., None]
  for u in np.nonzero(is_jnt)[0]:
    j = int(tid[u])
    g = gear[:, u]
    qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if jt[u] in (_JT.SLIDE, _JT.HINGE):
      length[:, u] = d.qpos[:, qadr] * g[:, 0]
      moment[:, u, dadr] = g[:, 0]
    elif jt[u] == _JT.BALL:
      q = math.normalize_quat(d.qpos[:, qadr:qadr + 4])
      axis_angle = math.quat_sub(q, fmask([1.0, 0.0, 0.0, 0.0], q))
      length[:, u] = torch.sum(axis_angle * g[:, :3], dim=-1)
      moment[:, u, dadr:dadr + 3] = g[:, :3]
    else:  # FREE
      moment[:, u, dadr:dadr + 3] = g[:, :3]
      moment[:, u, dadr + 3:dadr + 6] = g[:, 3:]
  for u in np.nonzero(trn == TT.SITE)[0]:
    length[:, u], moment[:, u] = _site_transmission(m, d, int(u), gear[:, u])
  for u in np.nonzero(trn == TT.SLIDERCRANK)[0]:
    length[:, u], moment[:, u] = _slidercrank(m, d, int(u), gear[:, u])
  for u in np.nonzero(trn == TT.BODY)[0]:
    moment[:, u] = _adhesion_moment(m, d, int(tid[u]))
  return d.replace(actuator_length=length, actuator_moment=moment)


def _site_transmission(m: types.Model, d: types.Data, u: int, g):
  """(length, moment) of a site actuator (``smooth.py:923-943``): without
  a reference site, length 0 and the moment of the wrench gear[:3],
  gear[3:] in the site's frame; with one, length the distance between
  the sites times gear[0] and the moment along their direction."""
  from mujoco_warp_tpu_torch.ops import support
  sid, refid = int(m.actuator_trnid[u, 0]), int(m.actuator_trnid[u, 1])
  jacp, jacr = support.jac(m, d, d.site_xpos[:, sid], int(m.site_bodyid[sid]))
  if refid == -1:
    frame = d.site_xmat[:, sid]
    wrench_p = torch.einsum('wij,wj->wi', frame, g[:, :3].expand(
        frame.shape[0], 3))
    wrench_r = torch.einsum('wij,wj->wi', frame, g[:, 3:].expand(
        frame.shape[0], 3))
    mom = torch.einsum('wiv,wi->wv', jacp, wrench_p) + torch.einsum(
        'wiv,wi->wv', jacr, wrench_r)
    return torch.zeros_like(mom[:, 0]), mom
  jacp2, _ = support.jac(m, d, d.site_xpos[:, refid],
                         int(m.site_bodyid[refid]))
  vec = d.site_xpos[:, sid] - d.site_xpos[:, refid]
  dist = math.safe_norm(vec)
  dirn = vec / torch.clamp(dist, min=1e-12)[:, None]
  mom = torch.einsum('wiv,wi->wv', jacp - jacp2, dirn) * g[:, :1]
  return dist * g[:, 0], mom


def _slidercrank(m: types.Model, d: types.Data, u: int, g):
  """(length, moment) of a slider-crank (``smooth.py:944-967``): the crank
  site trnid[0] driven by a rod of cranklength from the slider site
  trnid[1], along the slider's z axis."""
  from mujoco_warp_tpu_torch.ops import support
  cid, sid = int(m.actuator_trnid[u, 0]), int(m.actuator_trnid[u, 1])
  rod = types.world_field(m, 'actuator_cranklength')[:, u]
  axis = d.site_xmat[:, sid, :, 2]
  vec = d.site_xpos[:, cid] - d.site_xpos[:, sid]
  av = math.dot(vec, axis)
  det = av * av + rod * rod - math.dot(vec, vec)
  ok = det > 0.0
  sdet = torch.sqrt(torch.clamp(det, min=1e-12))
  length = torch.where(ok, av - sdet, av)
  # the chain rule: dL/dvec and dL/daxis
  scale = (1.0 - av / sdet)[:, None]
  okc = ok[:, None]
  dldv = torch.where(okc, axis * scale + vec / sdet[:, None], axis)
  dlda = torch.where(okc, vec * scale, vec)
  jacp_c, _ = support.jac(m, d, d.site_xpos[:, cid], int(m.site_bodyid[cid]))
  jacp_s, jacr_s = support.jac(m, d, d.site_xpos[:, sid],
                               int(m.site_bodyid[sid]))
  # each dof's jacr x axis, (W, nv, 3)
  jac_a = math.cross(jacr_s.transpose(1, 2), axis[:, None, :])
  mom = torch.einsum('wiv,wi->wv', jacp_c - jacp_s, dldv) + torch.einsum(
      'wvi,wi->wv', jac_a, dlda)
  return length * g[:, 0], mom * g[:, :1]


def _adhesion_moment(m: types.Model, d: types.Data, body: int):
  """The moment of an adhesion actuator on ``body`` (``smooth.py:968``):
  minus the mean, over the contacts that touch the body within their
  margin, of each contact's normal Jacobian: its normal row's J (the
  mean of its pyramid's facet rows) where the contact is active, the
  normal's Jacobian difference of the two bodies at the contact point
  where it is in the margin's gap.  Geom ids are read per world, as
  compaction leaves them; zero without contacts."""
  from mujoco_warp_tpu_torch.ops import constraint
  W, dev, dt = d.qpos.shape[0], d.qpos.device, d.qpos.dtype
  con = d.contact
  if not m.ncon or con is None or d.efc_J is None:
    return torch.zeros((W, m.nv), dtype=dt, device=dev)
  gb = ix(m.geom_bodyid, dev)
  b1, b2 = gb[con.geom1.long()], gb[con.geom2.long()]  # (W, ncon)
  touches = (b1 == body) | (b2 == body)
  cand = con.cand.long()
  cm = types.world_field(m, 'cand_margin').expand(W, -1)
  marg = torch.where(cand >= 0, torch.gather(cm, 1, torch.clamp(cand, min=0)),
                     torch.zeros((), dtype=dt, device=dev))
  found = touches & (con.dist < marg)
  active = touches & (con.dist < con.includemargin)
  nfound = found.sum(1).to(dt)
  jn = torch.zeros((W, m.ncon, m.nv), dtype=dt, device=dev)
  dims = np.asarray(m.con_dim)
  for dim in np.unique(dims):
    idx = np.nonzero(dims == dim)[0]
    adr = np.asarray(m.con_efc_address)[idx]
    if dim == 1 or m.opt.cone == types.ConeType.ELLIPTIC:
      jn[:, ix(idx, dev)] = d.efc_J[:, ix(adr, dev)]
    else:
      npyr = int(dim) - 1
      rows = d.efc_J[:, ix(adr[:, None] + np.arange(2 * npyr), dev)]
      jn[:, ix(idx, dev)] = torch.sum(rows, dim=2) * (0.5 / npyr)
  # the normal's Jacobian difference at the contact point, bodies per
  # world
  jacp = lambda b: constraint._jac(m, d, con.pos, b)[0]  # (W, ncon, nv, 3)
  jgap = torch.einsum('wki,wkvi->wkv', con.frame[:, :, 0], jacp(b2) -
                      jacp(b1))
  wsum = torch.where(active[..., None], jn, torch.where(
      found[..., None], jgap, torch.zeros((), dtype=dt, device=dev)))
  mom = wsum.sum(1)
  return torch.where(nfound[:, None] > 0,
                     -mom / torch.clamp(nfound, min=1.0)[:, None],
                     torch.zeros((), dtype=dt, device=dev))


def factor_m(m: types.Model, d: types.Data) -> types.Data:
  """Cholesky factor of qM (``smooth.py:301``) by the ``chol_batched``
  kernel, world-major."""
  return d.replace(qLD=klinalg.chol_batched(m, d.qM.contiguous()))


def solve_m(m: types.Model, d: types.Data, x: torch.Tensor) -> torch.Tensor:
  """y with M y = x from the factor qLD (``smooth.py:310``) by the
  ``chol_solve`` kernel."""
  return klinalg.chol_solve_batched(m, d.qLD, x)


def mul_m(m: types.Model, d: types.Data, x: torch.Tensor) -> torch.Tensor:
  """M x (``smooth.py:321``)."""
  return torch.einsum('wij,wj->wi', d.qM, x)


def com_vel(m: types.Model, d: types.Data) -> types.Data:
  """Body velocities and cdof time-derivatives (``smooth.py:360``): cvel
  of a body sums cdof qvel over its dofs and its ancestors'; cdof_dot of
  a dof is the velocity before it (``cdofdot_mask``) crossed with it."""
  cdof_qvel = d.cdof * d.qvel[..., None]  # (W, nv, 6)
  bd = fmask(m.tree.body_dof_mask, d.cdof)  # (nbody, nv)
  cvel = torch.einsum('bv,wvk->wbk', bd, cdof_qvel)
  cm = fmask(m.tree.cdofdot_mask, d.cdof)  # (nv, nv)
  before = torch.einsum('iv,wvk->wik', cm, cdof_qvel)
  return d.replace(cvel=cvel, cdof_dot=math.motion_cross(before, d.cdof))


def rne(m: types.Model, d: types.Data) -> types.Data:
  """The bias force by recursive Newton-Euler as masked sums
  (``smooth.py:378``): cacc = -gravity + the cdof_dot qvel of the body's
  dofs and its ancestors', cfrc = cinert cacc + cvel x* (cinert cvel),
  qfrc_bias = cdof . the cfrc summed over the dof's subtree."""
  bd = fmask(m.tree.body_dof_mask, d.cdof)
  g = types.world_field(m, 'opt.gravity').to(d.cdof.dtype)[:, None]
  if m.opt.disableflags & types.DisableBit.GRAVITY:
    g = torch.zeros_like(g)
  cacc = torch.cat([torch.zeros_like(g), -g], -1) + torch.einsum(
      'bv,wvk->wbk', bd, d.cdof_dot * d.qvel[..., None])
  # the world body's cacc is 0
  not_world = np.ones((m.nbody, 1), np.float32)
  not_world[0] = 0.0
  cacc = cacc * fmask(not_world, d.cdof)
  iv = torch.einsum('wbij,wbj->wbi', d.cinert, d.cvel)
  ia = torch.einsum('wbij,wbj->wbi', d.cinert, cacc)
  cfrc = ia + math.motion_cross_force(d.cvel, iv)
  ds = fmask(m.tree.dof_subtree_mask, d.cdof)  # (nv, nbody)
  fsum = torch.einsum('vb,wbk->wvk', ds, cfrc)
  return d.replace(qfrc_bias=torch.sum(fsum * d.cdof, dim=-1))
