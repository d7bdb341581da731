"""Passive forces of the general step, world-major: joint and tendon
springs, dof and tendon dampers, gravity compensation and fluid forces.

Counterpart of ``mujoco_warp_tpu/ops/passive.py`` ``passive`` (:269) with
``_spring`` (:21), the tendon terms (:286-304), the damping term, and the
two fluid models: the inertia box of every body (``_fluid`` :185) and the
ellipsoid model of the bodies whose geoms set ``fluidshape="ellipsoid"``
(``_fluid_ellipsoid`` :68, ``_ellipsoid_bodies`` :57), which skip the
box.  Each body's wrench about its root's CoM reaches the dofs through
``tree.dof_subtree_mask``, as do the gravity-compensation forces
(``gravcomp`` :254, kept out of ``qfrc_passive`` on the dofs whose joint
takes them through its actuators, :324-333).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.kernels import TableCache
from mujoco_warp_tpu_torch.ops import math
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, ix

_JT = types.JointType


def _spring(m: types.Model, d: types.Data) -> torch.Tensor:
  """Joint spring torques -k (qpos - qpos_spring), per joint type; the
  stiffness and the spring's rest pose per world where they are
  batched."""
  dev = d.qpos.device
  qfrc = torch.zeros_like(d.qvel)
  spring = types.world_field(m, 'qpos_spring')  # (1 or W, nq)
  stiffness = types.world_field(m, 'jnt_stiffness')  # (1 or W, njnt)
  for jt in np.unique(m.jnt_type):
    jids = np.nonzero(m.jnt_type == jt)[0]
    k = stiffness[:, ix(jids, dev)]
    qadr, dadr = m.jnt_qposadr[jids], m.jnt_dofadr[jids]
    span = lambda adr, a, b: ix(adr[:, None] + np.arange(a, b), dev)
    if jt == _JT.FREE:
      q3 = span(qadr, 0, 3)
      d3 = span(dadr, 0, 3)
      qfrc[:, d3] = qfrc[:, d3] + (-k[..., None] * (d.qpos[:, q3] -
                                                    spring[:, q3]))
      q4 = span(qadr, 3, 7)
      rotdif = math.quat_sub(math.normalize_quat(d.qpos[:, q4]),
                             math.normalize_quat(spring[:, q4]))
      d3r = span(dadr, 3, 6)
      qfrc[:, d3r] = qfrc[:, d3r] + (-k[..., None] * rotdif)
    elif jt == _JT.BALL:
      q4 = span(qadr, 0, 4)
      rotdif = math.quat_sub(math.normalize_quat(d.qpos[:, q4]),
                             math.normalize_quat(spring[:, q4]))
      d3 = span(dadr, 0, 3)
      qfrc[:, d3] = qfrc[:, d3] + (-k[..., None] * rotdif)
    else:  # SLIDE / HINGE
      qa, da = ix(qadr, dev), ix(dadr, dev)
      qfrc[:, da] = qfrc[:, da] + (-k * (d.qpos[:, qa] - spring[:, qa]))
  return qfrc


def tendon_stretch(m: types.Model, d: types.Data) -> torch.Tensor:
  """(W, ntendon): each tendon's length past its spring's deadband
  [lengthspring lo, hi], 0 inside it (``passive.py:290-293``)."""
  spring = types.world_field(m, 'tendon_lengthspring')
  lo, hi = spring[..., 0], spring[..., 1]
  L = d.ten_length
  return torch.where(L > hi, L - hi, torch.where(L < lo, L - lo, 0.0))


def _to_dofs(m: types.Model, d: types.Data, cfrc) -> torch.Tensor:
  """(W, nv) generalized forces of per-body wrenches (W, nbody, 6)
  [torque about the root's CoM, force]: each dof takes the wrenches of
  its subtree's bodies along its cdof."""
  ds = fmask(m.tree.dof_subtree_mask, cfrc)
  return torch.sum(torch.einsum('vb,wbk->wvk', ds, cfrc) * d.cdof, -1)


def ellipsoid_bodies(m: types.Model) -> np.ndarray:
  """(nbody,) bool: the bodies on the ellipsoid fluid model, those with
  a geom whose ``geom_fluid[0]`` is set (``passive.py:57``)."""
  out = np.zeros(m.nbody, bool)
  gf = np.asarray(m.geom_fluid).reshape(m.ngeom, -1)
  if gf.size:
    out[np.asarray(m.geom_bodyid)[gf[:, 0] > 0]] = True
  return out


def _fluid(m: types.Model, d: types.Data) -> torch.Tensor:
  """The inertia-box model (``passive.py:185``): each body's equivalent
  box from its mass and principal inertia, its velocity at its CoM
  relative to the wind in its inertial frame, viscous drag and torque
  (opt.viscosity) and quadratic drag and torque (opt.density); bodies on
  the ellipsoid model take none."""
  dev, dt = d.qpos.device, d.qpos.dtype
  rho, beta, wind = _fluid_options(m, dt)  # (1 or W, 1, ...)
  mass = types.world_field(m, 'body_mass')  # (1 or W, nbody)
  inert = types.world_field(m, 'body_inertia')  # (1 or W, nbody, 3)
  s = torch.clamp(mass, min=1e-12)
  box = torch.sqrt(torch.clamp(torch.stack([
      inert[..., 1] + inert[..., 2] - inert[..., 0],
      inert[..., 0] + inert[..., 2] - inert[..., 1],
      inert[..., 0] + inert[..., 1] - inert[..., 2]], -1) / s[..., None] *
      6.0, min=1e-12))
  offset = d.xipos - d.subtree_com[:, ix(m.body_rootid, dev)]
  ang_w = d.cvel[..., :3]
  lin_w = d.cvel[..., 3:] - math.cross(offset, ang_w) - wind
  ang = torch.einsum('wbji,wbj->wbi', d.ximat, ang_w)
  lin = torch.einsum('wbji,wbj->wbi', d.ximat, lin_w)
  bx, by, bz = box[..., 0], box[..., 1], box[..., 2]
  diam = (bx + by + bz) / 3.0
  frc_v = -3.0 * np.pi * beta[..., None] * diam[..., None] * lin
  trq_v = -np.pi * beta[..., None] * (diam ** 3)[..., None] * ang
  area = torch.stack([by * bz, bx * bz, bx * by], -1)
  frc_d = -0.5 * rho[..., None] * area * torch.abs(lin) * lin
  mom = torch.stack([bx * (by ** 4 + bz ** 4), by * (bx ** 4 + bz ** 4),
                     bz * (bx ** 4 + by ** 4)], -1)
  trq_d = -rho[..., None] * mom / 64.0 * torch.abs(ang) * ang
  keep = fluid_geoms(m, dev)['box'].to(dt)[:, None]
  frc = (frc_v + frc_d) * keep
  trq = (trq_v + trq_d) * keep
  frc_w = torch.einsum('wbij,wbj->wbi', d.ximat, frc)
  trq_w = torch.einsum('wbij,wbj->wbi', d.ximat, trq)
  return _to_dofs(m, d, torch.cat([trq_w + math.cross(offset, frc_w),
                                   frc_w], -1))


def _fluid_tables(m: types.Model, dev) -> dict:
  """The geoms on the ellipsoid model as device tensors, built once per
  Model (``fluid_geoms``): their ids 'geom', bodies 'body' and bodies'
  roots 'root', (n,); their 12 coefficients 'coef', (n, 12), and
  semiaxes by geom type 'semi', (n, 3): a sphere's radius thrice, a
  capsule's (r, r, half + r), a cylinder's (r, r, half), any other
  type's size (``passive.py:82-95``); and 'box', (nbody,), 1 on the
  bodies that take the inertia box."""
  gf = np.asarray(m.geom_fluid, np.float64).reshape(m.ngeom, -1)
  sel = np.nonzero(gf[:, 0] > 0)[0] if gf.size else np.zeros(0, np.int64)
  size = types.host(m.geom_size).astype(np.float64)[sel]
  semi = size.copy()
  for i, t in enumerate(np.asarray(m.geom_type)[sel]):
    r, half = size[i, 0], size[i, 1]
    if t == types.GeomType.SPHERE:
      semi[i] = (r, r, r)
    elif t == types.GeomType.CAPSULE:
      semi[i] = (r, r, half + r)
    elif t == types.GeomType.CYLINDER:
      semi[i] = (r, r, half)
  body = np.asarray(m.geom_bodyid)[sel]
  f = lambda x: torch.as_tensor(x, device=dev).to(m.geom_size.dtype)
  i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
  return {'geom': i(sel), 'body': i(body),
          'root': i(np.asarray(m.body_rootid)[body]), 'coef': f(gf[sel]),
          'semi': f(semi), 'box': f(~ellipsoid_bodies(m))}


_FLUID = TableCache(_fluid_tables)


def fluid_geoms(m: types.Model, device) -> dict:
  """``_fluid_tables`` of the Model on ``device``."""
  return _FLUID.get(m, device)


def _fluid_ellipsoid(m: types.Model, d: types.Data) -> torch.Tensor:
  """The ellipsoid model (``passive.py:68``, MuJoCo's
  mj_ellipsoidFluidModel) on each geom of ``fluid_geoms``: added mass,
  Magnus and Kutta lift, and blunt, slender and angular drag in the
  geom's frame, relative to the wind, scaled by the geom's coefficient
  [0], each geom's wrench on its body."""
  dev, dt = d.qpos.device, d.qpos.dtype
  t = fluid_geoms(m, dev)
  rho, beta, wind = _fluid_options(m, dt)  # (1 or W, 1, ...)
  gf, semi = t['coef'].to(dt), t['semi'].to(dt)
  bi, gi = t['body'], t['geom']
  root_com = d.subtree_com[:, t['root']]
  ang = d.cvel[:, bi, :3]
  lin_com = d.cvel[:, bi, 3:] - math.cross(d.xipos[:, bi] - root_com, ang)
  gpos = d.geom_xpos[:, gi]
  lin_point = lin_com + math.cross(ang, gpos - d.xipos[:, bi])
  R = d.geom_xmat[:, gi]
  l_ang = torch.einsum('wnji,wnj->wni', R, ang)
  l_lin = torch.einsum('wnji,wnj->wni', R, lin_point - wind)
  # added mass
  vlm = rho[..., None] * gf[:, 6:9] * l_lin
  vam = rho[..., None] * gf[:, 9:12] * l_ang
  frc = math.cross(vlm, l_ang)
  trq = math.cross(vlm, l_lin) + math.cross(vam, l_ang)
  magnus, kutta = gf[:, 5], gf[:, 4]
  blunt, slender, ang_drag = gf[:, 1], gf[:, 2], gf[:, 3]
  s0, s1, s2 = semi[:, 0], semi[:, 1], semi[:, 2]
  volume = (4.0 / 3.0 * np.pi) * s0 * s1 * s2
  d_max = torch.amax(semi, -1)
  d_min = torch.amin(semi, -1)
  d_mid = s0 + s1 + s2 - d_max - d_min
  A_max = np.pi * d_max * d_mid
  lin_speed = math.norm(l_lin)
  frc = frc + math.cross(l_ang, l_lin) * (magnus * rho * volume)[..., None]
  s12, s20, s01 = s1 * s2, s2 * s0, s0 * s1
  p2 = lambda x: x * x
  p4 = lambda x: p2(p2(x))
  lx, ly, lz = l_lin[..., 0], l_lin[..., 1], l_lin[..., 2]
  proj_den = p4(s12) * p2(lx) + p4(s20) * p2(ly) + p4(s01) * p2(lz)
  proj_num = p2(s12 * lx) + p2(s20 * ly) + p2(s01 * lz)
  A_proj = np.pi * torch.sqrt(proj_den / torch.clamp(proj_num, min=1e-15))
  cos_a = proj_num / torch.clamp(lin_speed * proj_den, min=1e-15)
  nrm = torch.stack([p2(s12) * lx, p2(s20) * ly, p2(s01) * lz], -1)
  kutta_circ = math.cross(nrm, l_lin) * (kutta * rho * cos_a *
                                         A_proj)[..., None]
  kutta_force = math.cross(kutta_circ, l_lin)
  frc = frc + torch.where((lin_speed > 1e-15)[..., None], kutta_force,
                          torch.zeros_like(kutta_force))
  eq_D = (2.0 / 3.0) * (s0 + s1 + s2)
  lin_visc_f = 3.0 * np.pi * eq_D
  lin_visc_t = np.pi * eq_D ** 3
  mom_c = (8.0 / 15.0) * np.pi
  I_max = mom_c * d_mid * p4(d_max)
  II = torch.stack([mom_c * s0 * p4(torch.maximum(s1, s2)),
                    mom_c * s1 * p4(torch.maximum(s2, s0)),
                    mom_c * s2 * p4(torch.maximum(s0, s1))], -1)
  mom_visc = l_ang * (ang_drag[:, None] * II +
                      slender[:, None] * (I_max[:, None] - II))
  drag_lin = beta * lin_visc_f + rho * lin_speed * (
      A_proj * blunt + slender * (A_max - A_proj))
  drag_ang = beta * lin_visc_t + rho * math.norm(mom_visc)
  trq = trq - drag_ang[..., None] * l_ang
  frc = frc - drag_lin[..., None] * l_lin
  coef = gf[:, 0, None]
  frc_w = torch.einsum('wnij,wnj->wni', R, frc * coef)
  trq_w = torch.einsum('wnij,wnj->wni', R, trq * coef)
  trq_root = trq_w + math.cross(gpos - root_com, frc_w)
  W = d.qpos.shape[0]
  cfrc = torch.zeros((W, m.nbody, 6), dtype=dt, device=dev)
  cfrc = cfrc.index_add(1, bi, torch.cat([trq_root, frc_w], -1))
  return _to_dofs(m, d, cfrc)


def _fluid_options(m: types.Model, dt):
  """The density and viscosity (1 or W, 1) and the wind (1 or W, 1, 3)
  of each world."""
  f = lambda name: types.world_field(m, name).to(dt)
  return (f('opt.density')[:, None], f('opt.viscosity')[:, None],
          f('opt.wind')[:, None])


def fluid(m: types.Model, d: types.Data) -> torch.Tensor:
  """qfrc_fluid (W, nv) where opt.density or opt.viscosity is set in any
  world (``passive.py:314-320``; the JAX gate's ``concrete_or`` takes a
  batched value as set, which gives the same forces): the inertia-box
  model, plus the ellipsoid model where a body takes it; None
  otherwise."""
  if not (np.any(types.host(m.opt.density)) or
          np.any(types.host(m.opt.viscosity))):
    return None
  q = _fluid(m, d)
  if np.any(ellipsoid_bodies(m)):
    q = q + _fluid_ellipsoid(m, d)
  return q


def passive(m: types.Model, d: types.Data) -> types.Data:
  """Spring, damper, gravity-compensation and fluid forces
  (``passive.py:269``), the tendons' springs with their deadband and
  their dampers among them (:286-304); the stiffnesses, dampings,
  spring rest poses and deadbands, gravcomp and fluid options per world
  where they are batched."""
  dsbl = m.opt.disableflags
  zero = torch.zeros_like(d.qvel)
  qfrc_spring = zero if dsbl & types.DisableBit.SPRING else _spring(m, d)
  qfrc_damper = zero if dsbl & types.DisableBit.DAMPER else \
      -types.world_field(m, 'dof_damping') * d.qvel
  if m.ntendon:
    wf = lambda name: types.world_field(m, name)  # (1 or W, ntendon)
    if not dsbl & types.DisableBit.SPRING:
      qfrc_spring = qfrc_spring + torch.einsum(
          'wtv,wt->wv', d.ten_J,
          -wf('tendon_stiffness') * tendon_stretch(m, d))
    if not dsbl & types.DisableBit.DAMPER:
      qfrc_damper = qfrc_damper + torch.einsum(
          'wtv,wt->wv', d.ten_J, -wf('tendon_damping') * d.ten_velocity)
  qfrc_fluid = fluid(m, d)
  if qfrc_fluid is None:
    qfrc_fluid = zero
  has_gravcomp = bool(np.any(types.host(m.body_gravcomp) > 0))
  qfrc_gravcomp = gravcomp(m, d) if has_gravcomp and not (
      dsbl & types.DisableBit.GRAVITY) else zero
  keep = qfrc_gravcomp
  if has_gravcomp and np.any(m.jnt_actgravcomp):
    # the dofs of joints with actuatorgravcomp take theirs through the
    # actuators (``fwd_actuation``), not here (:324-333)
    keep = torch.where(bmask(actgravcomp_dofs(m), d.qvel.device), 0.0,
                       qfrc_gravcomp)
  qfrc_passive = qfrc_spring + qfrc_damper + qfrc_fluid + keep
  return d.replace(qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
                   qfrc_gravcomp=qfrc_gravcomp, qfrc_fluid=qfrc_fluid,
                   qfrc_passive=qfrc_passive)


def actgravcomp_dofs(m: types.Model) -> np.ndarray:
  """(nv,) bool: the dofs of joints with actuatorgravcomp."""
  return np.asarray(m.jnt_actgravcomp, bool)[np.asarray(m.dof_jntid)]


def gravcomp(m: types.Model, d: types.Data) -> torch.Tensor:
  """Gravity compensation (W, nv) (``passive.py:254``): on each body the
  force -gravcomp mass gravity at its CoM, to the dofs through
  ``_to_dofs``; masses and gravity per world where they are batched."""
  gc = types.world_field(m, 'body_gravcomp') * types.world_field(
      m, 'body_mass')  # (1 or W, nb)
  grav = types.world_field(m, 'opt.gravity')[:, None]  # (1 or W, 1, 3)
  frc = -gc[..., None] * grav
  frc = frc.expand(d.xipos.shape)
  offset = d.xipos - d.subtree_com[:, ix(m.body_rootid, d.qpos.device)]
  return _to_dofs(m, d, torch.cat([math.cross(offset, frc), frc], -1))
