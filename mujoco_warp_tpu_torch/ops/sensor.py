"""Sensors of the general step, world-major: the position, velocity and
acceleration stages, their cutoffs, and the energies.

Counterpart of ``mujoco_warp_tpu/ops/sensor.py``: ``sensor_pos`` (:155)
and its helpers (:31-152), ``sensor_vel`` (:394) with ``_subtree_vel``
(:477), ``sensor_acc`` (:708), ``_apply_cutoff`` (:802) and
``energy_pos`` / ``energy_vel`` (:822-880).  Sensors are grouped by type
from the static tables; each group is computed for every world at once
and written into ``sensordata`` at its static addresses with one indexed
store.  TOUCH follows the JAX package: the normal forces of the live
contacts whose either body is the site's body (:771-787).

The six TENDON* types read the tendon stages (:176, :192, :419, :427,
:734, :742).  ``DEFERRED`` names the types that wait for their subsystems
(rays, geom distances, the contact sensor, tactile meshes);
``ops/forward.unsupported`` refuses a model that has one.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import math, passive, smooth
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, ix

_ST = types.SensorType
_OT = types.ObjType

# sensor type -> the subsystem it waits for
DEFERRED = {
    int(_ST.RANGEFINDER): 'rays', int(_ST.GEOMDIST): 'geom distance',
    int(_ST.GEOMNORMAL): 'geom distance',
    int(_ST.GEOMFROMTO): 'geom distance',
    int(_ST.CONTACT): 'the contact sensor', int(_ST.TACTILE): 'meshes',
}

POS_TYPES = (
    _ST.MAGNETOMETER, _ST.JOINTPOS, _ST.TENDONPOS, _ST.ACTUATORPOS,
    _ST.BALLQUAT, _ST.JOINTLIMITPOS, _ST.TENDONLIMITPOS, _ST.FRAMEPOS, _ST.FRAMEQUAT, _ST.FRAMEXAXIS,
    _ST.FRAMEYAXIS, _ST.FRAMEZAXIS, _ST.SUBTREECOM, _ST.CLOCK,
    _ST.E_POTENTIAL, _ST.E_KINETIC, _ST.CAMPROJECTION, _ST.INSIDESITE)
VEL_TYPES = (
    _ST.VELOCIMETER, _ST.GYRO, _ST.JOINTVEL, _ST.TENDONVEL, _ST.ACTUATORVEL,
    _ST.BALLANGVEL, _ST.JOINTLIMITVEL, _ST.TENDONLIMITVEL, _ST.FRAMELINVEL,
    _ST.FRAMEANGVEL, _ST.SUBTREELINVEL, _ST.SUBTREEANGMOM)
ACC_TYPES = (
    _ST.TOUCH, _ST.ACCELEROMETER, _ST.FORCE, _ST.TORQUE, _ST.ACTUATORFRC,
    _ST.JOINTACTFRC, _ST.TENDONACTFRC, _ST.JOINTLIMITFRC,
    _ST.TENDONLIMITFRC, _ST.FRAMELINACC, _ST.FRAMEANGACC)


def deferred(m: types.Model):
  """The model's sensor types that are not ported, with their subsystem:
  a list of (type name, subsystem)."""
  if not m.nsensor:
    return []
  return [(_ST(t).name, DEFERRED[t]) for t in
          sorted(set(int(x) for x in m.sensor_type)) if t in DEFERRED]


def _groups(m: types.Model, stage_types) -> dict:
  """type -> the sensor ids of that type, for the types of one stage."""
  out = {}
  for t in stage_types:
    ids = np.nonzero(m.sensor_type == t)[0]
    if len(ids):
      out[int(t)] = ids
  return out


def _sensordata(m: types.Model, d: types.Data) -> torch.Tensor:
  if d.sensordata is not None:
    return d.sensordata.clone()
  return torch.zeros((d.qpos.shape[0], m.nsensordata), dtype=d.qpos.dtype,
                     device=d.qpos.device)


def _write(sd, m, ids, values):
  """values (W, n, dim) or (W, n) into the sensors ``ids`` (n of one
  dim), one indexed store."""
  dim = int(m.sensor_dim[ids[0]])
  idx = (m.sensor_adr[ids][:, None] + np.arange(dim)).reshape(-1)
  sd[:, ix(idx, sd.device)] = values.reshape(sd.shape[0], -1).to(sd.dtype)


def _rot_t(mat, v):
  """mat^T v for (W, n, 3, 3) matrices and (W, n, 3) vectors."""
  return torch.einsum('wnji,wnj->wni', mat, v)


def _obj_pos(m, d, objtype, objid):
  """World positions (W, n, 3) of a body (CoM), xbody, geom or site
  batch."""
  dev = d.qpos.device
  pos = torch.zeros((d.qpos.shape[0], len(objid), 3), dtype=d.qpos.dtype,
                    device=dev)
  for ot, arr in ((_OT.BODY, d.xipos), (_OT.XBODY, d.xpos),
                  (_OT.GEOM, d.geom_xpos), (_OT.SITE, d.site_xpos)):
    sel = objtype == ot
    if np.any(sel):
      pos[:, ix(np.nonzero(sel)[0], dev)] = arr[:, ix(objid[sel], dev)]
  return pos


def _obj_mat(m, d, objtype, objid):
  """World orientations (W, n, 3, 3) of an object batch (identity for
  other object types)."""
  dev = d.qpos.device
  mat = torch.eye(3, dtype=d.qpos.dtype, device=dev).repeat(
      d.qpos.shape[0], len(objid), 1, 1)
  for ot, arr in ((_OT.BODY, d.ximat), (_OT.XBODY, d.xmat),
                  (_OT.GEOM, d.geom_xmat), (_OT.SITE, d.site_xmat)):
    sel = objtype == ot
    if np.any(sel):
      mat[:, ix(np.nonzero(sel)[0], dev)] = arr[:, ix(objid[sel], dev)]
  return mat


def _obj_quat(m, d, objtype, objid):
  """World quaternions (W, n, 4) of an object batch: the body's inertial
  or its own frame, a geom's or a site's static offset on its body."""
  dev = d.qpos.device
  q = torch.zeros((d.qpos.shape[0], len(objid), 4), dtype=d.qpos.dtype,
                  device=dev)
  q[..., 0] = 1.0
  for ot in np.unique(objtype):
    sel = np.nonzero(objtype == ot)[0]
    oid = objid[sel]
    if ot == _OT.BODY:
      qo = math.mul_quat(d.xquat[:, ix(oid, dev)], m.body_iquat[ix(oid, dev)])
    elif ot == _OT.XBODY:
      qo = d.xquat[:, ix(oid, dev)]
    elif ot == _OT.GEOM:
      qo = math.mul_quat(d.xquat[:, ix(m.geom_bodyid[oid], dev)],
                         m.geom_quat[ix(oid, dev)])
    elif ot == _OT.SITE:
      qo = math.mul_quat(d.xquat[:, ix(m.site_bodyid[oid], dev)],
                         m.site_quat[ix(oid, dev)])
    else:
      continue
    q[:, ix(sel, dev)] = qo
  return q


def _obj_body(m, objtype, objid) -> np.ndarray:
  """The body carrying each object (static)."""
  body = np.zeros(len(objid), np.int64)
  for ot in (_OT.BODY, _OT.XBODY):
    body[objtype == ot] = objid[objtype == ot]
  sel = objtype == _OT.GEOM
  body[sel] = m.geom_bodyid[objid[sel]]
  sel = objtype == _OT.SITE
  body[sel] = m.site_bodyid[objid[sel]]
  return body


def _has_ref(m, ids):
  refid = m.sensor_refid[ids]
  return np.any(refid >= 0), refid >= 0, m.sensor_reftype[ids], \
      np.maximum(refid, 0)


def _point_vel(m, d, point, body, mat=None):
  """(ang, lin) velocity (W, n, 3) each of body-fixed world points on
  static bodies; rotated into ``mat``'s frame when given
  (mj_objectVelocity)."""
  dev = d.qpos.device
  off = point - d.subtree_com[:, ix(m.body_rootid[body], dev)]
  cv = d.cvel[:, ix(body, dev)]
  ang = cv[..., :3]
  lin = cv[..., 3:] - math.cross(off, ang)
  if mat is not None:
    ang, lin = _rot_t(mat, ang), _rot_t(mat, lin)
  return ang, lin


def _point_acc(m, d, point, body):
  """(ang, lin) acceleration (W, n, 3) each of body-fixed world points,
  with the centripetal term (mj_objectAcceleration, world frame)."""
  dev = d.qpos.device
  off = point - d.subtree_com[:, ix(m.body_rootid[body], dev)]
  ca = d.cacc[:, ix(body, dev)]
  cv = d.cvel[:, ix(body, dev)]
  ang_v = cv[..., :3]
  lin_v = cv[..., 3:] - math.cross(off, ang_v)
  ang = ca[..., :3]
  lin = ca[..., 3:] - math.cross(off, ang) + math.cross(ang_v, lin_v)
  return ang, lin


def _limit_rows(m, objid, tendon: bool = False) -> np.ndarray:
  """The limit row of each joint (or tendon), -1 where it has none."""
  lay = m.efc
  ids, adr = (lay.lim_ten_id, lay.lim_ten_adr) if tendon else \
      (lay.lim_jnt_id, lay.lim_jnt_adr)
  rows = np.full(len(objid), -1, np.int64)
  for i, o in enumerate(objid):
    hit = np.nonzero(ids == o)[0]
    if len(hit):
      rows[i] = adr[hit[0]]
  return rows


def _limit_value(d, rows, value):
  """``value`` (W, n) where the joint's limit row is active, else 0."""
  dev = d.qpos.device
  rr = ix(np.maximum(rows, 0), dev)
  live = bmask(rows >= 0, dev) & d.efc_active[:, rr]
  return torch.where(live, value, torch.zeros((), dtype=value.dtype,
                                              device=dev))


def _inside_site(m, d, siteid: int, points):
  """(W,) bool: points (W, 3) inside the site's primitive volume."""
  pl = torch.einsum('wi,wij->wj', points - d.site_xpos[:, siteid],
                    d.site_xmat[:, siteid])
  s = m.site_size[siteid]
  st = int(m.site_type[siteid])
  GT = types.GeomType
  if st == GT.SPHERE:
    return torch.sum(pl * pl, -1) < s[0] * s[0]
  if st == GT.CAPSULE:
    zd = pl[:, 2] - torch.clamp(pl[:, 2], -s[1], s[1])
    return pl[:, 0] ** 2 + pl[:, 1] ** 2 + zd * zd < s[0] * s[0]
  if st == GT.ELLIPSOID:
    ps = pl / s
    return torch.sum(ps * ps, -1) < 1.0
  if st == GT.CYLINDER:
    return (torch.abs(pl[:, 2]) < s[1]) & (
        pl[:, 0] ** 2 + pl[:, 1] ** 2 < s[0] * s[0])
  if st == GT.BOX:
    return torch.all(torch.abs(pl) < s, -1)
  if st == GT.PLANE:
    return pl[:, 2] < 0.0
  return torch.zeros(points.shape[:-1], dtype=torch.bool, device=pl.device)


def _cam_projection(m, d, ids):
  """Pixel coordinates (W, n, 2) of each sensor's site in its camera's
  image (``sensor.py:347``)."""
  dev, dt = d.qpos.device, d.qpos.dtype
  objid, refid = m.sensor_objid[ids], m.sensor_refid[ids]
  ci = ix(refid, dev)
  v = torch.einsum('wnij,wni->wnj', d.cam_xmat[:, ci],
                   d.site_xpos[:, ix(objid, dev)] - d.cam_xpos[:, ci])
  res = fmask(m.cam_resolution[refid].astype(np.float32), d.qpos)
  ss, intr = m.cam_sensorsize[ci], m.cam_intrinsic[ci]
  f_fovy = 0.5 / torch.tan(m.cam_fovy[ci] * np.pi / 360.0) * res[:, 1]
  use_intr = (ss[:, 0] != 0.0) & (ss[:, 1] != 0.0)
  fx = torch.where(use_intr, intr[:, 0] / (ss[:, 0] + 1e-15) * res[:, 0],
                   f_fovy)
  fy = torch.where(use_intr, intr[:, 1] / (ss[:, 1] + 1e-15) * res[:, 1],
                   f_fovy)
  den = v[..., 2]
  den = torch.where(torch.abs(den) < 1e-15, torch.clamp(den, -1e-15, 1e-15),
                    den)
  px = -fx * v[..., 0] / den + 0.5 * res[:, 0]
  py = fy * v[..., 1] / den + 0.5 * res[:, 1]
  return torch.stack([px, py], -1).to(dt)


def _cutoff_tables(m: types.Model):
  """Per element of sensordata: the cutoff and whether the sensor's data
  is positive-only (mjDATATYPE_POSITIVE), or None without cutoffs."""
  cut_s = types.host(m.sensor_cutoff)
  if not np.any(cut_s > 0):
    return None
  cut = np.zeros(m.nsensordata)
  positive = np.zeros(m.nsensordata, bool)
  for s in range(m.nsensor):
    a, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
    cut[a:a + dim] = cut_s[s]
    positive[a:a + dim] = m.sensor_datatype[s] == 1
  return cut, positive


def _apply_cutoff(m: types.Model, sd):
  """sensordata clamped to each sensor's cutoff (``sensor.py:802``)."""
  tables = _cutoff_tables(m)
  if tables is None:
    return sd
  cut = fmask(tables[0], sd)
  lo = torch.where(bmask(tables[1], sd.device), torch.zeros_like(cut), -cut)
  return torch.where(cut > 0, torch.minimum(torch.maximum(sd, lo), cut), sd)


def _enabled(m: types.Model) -> bool:
  return bool(m.nsensor) and not (m.opt.disableflags &
                                  types.DisableBit.SENSOR)


def sensor_pos(m: types.Model, d: types.Data) -> types.Data:
  """Position-stage sensors (``sensor.py:155``)."""
  if not _enabled(m):
    return d
  dev = d.qpos.device
  sd = _sensordata(m, d)
  W = sd.shape[0]
  for t, ids in _groups(m, POS_TYPES).items():
    objid = m.sensor_objid[ids]
    objtype = m.sensor_objtype[ids]
    if t == _ST.JOINTPOS:
      val = d.qpos[:, ix(m.jnt_qposadr[objid], dev)]
    elif t == _ST.ACTUATORPOS:
      val = d.actuator_length[:, ix(objid, dev)]
    elif t == _ST.BALLQUAT:
      val = math.normalize_quat(d.qpos[:, ix(
          m.jnt_qposadr[objid][:, None] + np.arange(4), dev)])
    elif t == _ST.TENDONPOS:
      val = d.ten_length[:, ix(objid, dev)]
    elif t in (_ST.JOINTLIMITPOS, _ST.TENDONLIMITPOS):
      rows = _limit_rows(m, objid, t == _ST.TENDONLIMITPOS)
      rr = ix(np.maximum(rows, 0), dev)
      val = _limit_value(d, rows, d.efc_pos[:, rr] - d.efc_margin[:, rr])
    elif t == _ST.FRAMEPOS:
      val = _obj_pos(m, d, objtype, objid)
      any_ref, has, reftype, rid = _has_ref(m, ids)
      if any_ref:
        rel = torch.einsum('wnij,wni->wnj', _obj_mat(m, d, reftype, rid),
                           val - _obj_pos(m, d, reftype, rid))
        val = torch.where(bmask(has, dev)[:, None], rel, val)
    elif t in (_ST.FRAMEXAXIS, _ST.FRAMEYAXIS, _ST.FRAMEZAXIS):
      col = t - int(_ST.FRAMEXAXIS)
      val = _obj_mat(m, d, objtype, objid)[..., col]
      any_ref, has, reftype, rid = _has_ref(m, ids)
      if any_ref:
        rel = torch.einsum('wnij,wni->wnj', _obj_mat(m, d, reftype, rid),
                           val)
        val = torch.where(bmask(has, dev)[:, None], rel, val)
    elif t == _ST.FRAMEQUAT:
      val = _obj_quat(m, d, objtype, objid)
      any_ref, has, reftype, rid = _has_ref(m, ids)
      if any_ref:
        rel = math.mul_quat(math.quat_inv(_obj_quat(m, d, reftype, rid)),
                            val)
        val = torch.where(bmask(has, dev)[:, None], rel, val)
    elif t == _ST.SUBTREECOM:
      val = d.subtree_com[:, ix(objid, dev)]
    elif t == _ST.MAGNETOMETER:
      val = torch.einsum('wnji,j->wni', d.site_xmat[:, ix(objid, dev)],
                         m.opt.magnetic.to(sd.dtype))
    elif t == _ST.CAMPROJECTION:
      val = _cam_projection(m, d, ids)
    elif t == _ST.INSIDESITE:
      pos = _obj_pos(m, d, objtype, objid)
      # a massless body with a massive subtree reads its subtree's CoM
      body = np.where(objtype == _OT.BODY, objid, 0)
      mass = types.host(m.body_mass)[body]
      smass = types.host(m.body_subtreemass)[body]
      use_com = (body > 0) & (mass < 1e-15) & (smass >= 1e-15)
      if np.any(use_com):
        pos = torch.where(bmask(use_com, dev)[:, None],
                          d.subtree_com[:, ix(body, dev)], pos)
      refid = m.sensor_refid[ids]
      val = torch.stack([_inside_site(m, d, int(refid[k]), pos[:, k])
                         for k in range(len(ids))], -1)
    elif t == _ST.CLOCK:
      val = d.time[:, None].expand(W, len(ids))
    elif t == _ST.E_POTENTIAL:
      val = energy_pos_value(m, d)[:, None].expand(W, len(ids))
    elif t == _ST.E_KINETIC:
      val = energy_vel_value(m, d)[:, None].expand(W, len(ids))
    else:
      raise NotImplementedError(f'sensor type {_ST(t).name}')
    _write(sd, m, ids, val)
  return d.replace(sensordata=_apply_cutoff(m, sd))


def _subtree_vel(m: types.Model, d: types.Data):
  """Subtree linear velocity and angular momentum about the subtree CoM,
  (W, nbody, 3) each (mj_subtreeVel, ``sensor.py:477``)."""
  dev = d.qpos.device
  mass = m.body_mass
  off = d.xipos - d.subtree_com[:, ix(m.body_rootid, dev)]
  ang = d.cvel[..., :3]
  lin = d.cvel[..., 3:] - math.cross(off, ang)
  sub = fmask(m.tree.subtree_mask, d.qpos)
  subtree_mass = torch.clamp(sub @ mass, min=1e-12)
  linvel = torch.einsum('sb,wbi->wsi', sub, mass[:, None] * lin) / \
      subtree_mass[:, None]
  I3 = d.ximat @ (m.body_inertia[..., None] * d.ximat.transpose(-1, -2))
  spin = torch.einsum('wbij,wbj->wbi', I3, ang)
  rel_p = d.xipos[:, None] - d.subtree_com[:, :, None]  # (W, s, b, 3)
  rel_v = lin[:, None] - linvel[:, :, None]
  orb = math.cross(rel_p, rel_v) * mass[:, None]
  angmom = torch.einsum('sb,wsbi->wsi', sub, orb + spin[:, None])
  return linvel, angmom


def sensor_vel(m: types.Model, d: types.Data) -> types.Data:
  """Velocity-stage sensors (``sensor.py:394``)."""
  if not _enabled(m):
    return d
  g = _groups(m, VEL_TYPES)
  if not g:
    return d
  dev = d.qpos.device
  sd = _sensordata(m, d)
  if _ST.SUBTREELINVEL in g or _ST.SUBTREEANGMOM in g:
    linvel, angmom = _subtree_vel(m, d)
    d = d.replace(subtree_linvel=linvel, subtree_angmom=angmom)
  for t, ids in g.items():
    objid = m.sensor_objid[ids]
    objtype = m.sensor_objtype[ids]
    if t == _ST.JOINTVEL:
      val = d.qvel[:, ix(m.jnt_dofadr[objid], dev)]
    elif t == _ST.ACTUATORVEL:
      val = d.actuator_velocity[:, ix(objid, dev)]
    elif t == _ST.BALLANGVEL:
      val = d.qvel[:, ix(m.jnt_dofadr[objid][:, None] + np.arange(3), dev)]
    elif t == _ST.TENDONVEL:
      val = d.ten_velocity[:, ix(objid, dev)]
    elif t in (_ST.JOINTLIMITVEL, _ST.TENDONLIMITVEL):
      rows = _limit_rows(m, objid, t == _ST.TENDONLIMITVEL)
      rr = ix(np.maximum(rows, 0), dev)
      val = _limit_value(d, rows, torch.einsum('wrv,wv->wr', d.efc_J[:, rr],
                                               d.qvel))
    elif t in (_ST.VELOCIMETER, _ST.GYRO):
      si = ix(objid, dev)
      ang, lin = _point_vel(m, d, d.site_xpos[:, si], m.site_bodyid[objid],
                            d.site_xmat[:, si])
      val = lin if t == _ST.VELOCIMETER else ang
    elif t in (_ST.FRAMELINVEL, _ST.FRAMEANGVEL):
      pos = _obj_pos(m, d, objtype, objid)
      ang, lin = _point_vel(m, d, pos, _obj_body(m, objtype, objid))
      val = lin if t == _ST.FRAMELINVEL else ang
      any_ref, has, reftype, rid = _has_ref(m, ids)
      if any_ref:
        refpos = _obj_pos(m, d, reftype, rid)
        refmat = _obj_mat(m, d, reftype, rid)
        rang, rlin = _point_vel(m, d, refpos, _obj_body(m, reftype, rid))
        if t == _ST.FRAMELINVEL:
          rel = lin - rlin - math.cross(rang, pos - refpos)
        else:
          rel = ang - rang
        rel = torch.einsum('wnij,wni->wnj', refmat, rel)
        val = torch.where(bmask(has, dev)[:, None], rel, val)
    elif t == _ST.SUBTREELINVEL:
      val = d.subtree_linvel[:, ix(objid, dev)]
    elif t == _ST.SUBTREEANGMOM:
      val = d.subtree_angmom[:, ix(objid, dev)]
    _write(sd, m, ids, val)
  return d.replace(sensordata=_apply_cutoff(m, sd))


def _touch(m, d, ids):
  """TOUCH (W, n): the normal force of every live contact either of
  whose bodies is the site's body."""
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  if not m.ncon or d.contact is None:
    return torch.zeros((W, len(ids)), dtype=dt, device=dev)
  con = d.contact
  fn = math.norm(smooth.contact_forces(m, d)[..., 3:])
  fn = fn * (con.dist < con.includemargin).to(dt)
  body = ix(m.site_bodyid[m.sensor_objid[ids]], dev)[None, :, None]
  b1, b2 = smooth.contact_bodies(m, d)
  match = (b1[:, None, :] == body) | (b2[:, None, :] == body)
  return torch.sum(torch.where(match, fn[:, None, :],
                               torch.zeros((), dtype=dt, device=dev)), -1)


def sensor_acc(m: types.Model, d: types.Data) -> types.Data:
  """Acceleration-stage sensors (``sensor.py:708``), after
  ``rne_postconstraint`` when the model has any."""
  if not _enabled(m):
    return d
  g = _groups(m, ACC_TYPES)
  if not g:
    return d
  d = smooth.rne_postconstraint(m, d)
  dev = d.qpos.device
  sd = _sensordata(m, d)
  for t, ids in g.items():
    objid = m.sensor_objid[ids]
    objtype = m.sensor_objtype[ids]
    if t == _ST.ACTUATORFRC:
      val = d.actuator_force[:, ix(objid, dev)]
    elif t == _ST.JOINTACTFRC:
      val = d.qfrc_actuator[:, ix(m.jnt_dofadr[objid], dev)]
    elif t == _ST.TENDONACTFRC:
      # the forces of the tendon actuators on each sensor's tendon
      is_ten = m.actuator_trntype == types.TrnType.TENDON
      match = is_ten[None, :] & (m.actuator_trnid[None, :, 0] ==
                                 objid[:, None])
      val = d.actuator_force @ fmask(match.T.astype(np.float32), sd)
    elif t in (_ST.JOINTLIMITFRC, _ST.TENDONLIMITFRC):
      rows = _limit_rows(m, objid, t == _ST.TENDONLIMITFRC)
      val = _limit_value(d, rows, d.efc_force[:, ix(np.maximum(rows, 0),
                                                    dev)])
    elif t == _ST.ACCELEROMETER:
      si = ix(objid, dev)
      _, lin = _point_acc(m, d, d.site_xpos[:, si], m.site_bodyid[objid])
      val = _rot_t(d.site_xmat[:, si], lin)
    elif t in (_ST.FRAMELINACC, _ST.FRAMEANGACC):
      ang, lin = _point_acc(m, d, _obj_pos(m, d, objtype, objid),
                            _obj_body(m, objtype, objid))
      val = lin if t == _ST.FRAMELINACC else ang
    elif t in (_ST.FORCE, _ST.TORQUE):
      # cfrc_int of the site's body, at the site, in the site's frame
      body = m.site_bodyid[objid]
      si = ix(objid, dev)
      off = d.site_xpos[:, si] - d.subtree_com[:, ix(m.body_rootid[body],
                                                     dev)]
      cf = d.cfrc_int[:, ix(body, dev)]
      val = cf[..., 3:] if t == _ST.FORCE else \
          cf[..., :3] - math.cross(off, cf[..., 3:])
      val = _rot_t(d.site_xmat[:, si], val)
    elif t == _ST.TOUCH:
      val = _touch(m, d, ids)
    _write(sd, m, ids, val)
  return d.replace(sensordata=_apply_cutoff(m, sd))


def energy_pos_value(m: types.Model, d: types.Data) -> torch.Tensor:
  """Potential energy (W,): gravity, joint springs and tendon springs
  past their deadband (``sensor.py:822``)."""
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  e = torch.zeros(W, dtype=dt, device=dev)
  if not (m.opt.disableflags & types.DisableBit.GRAVITY):
    e = e - torch.sum(m.body_mass[:, None] * d.xipos * m.opt.gravity,
                      dim=(1, 2))
  if m.opt.disableflags & types.DisableBit.SPRING:
    return e
  JT = types.JointType
  for jt in np.unique(m.jnt_type):
    jids = np.nonzero(m.jnt_type == jt)[0]
    k = m.jnt_stiffness[ix(jids, dev)]
    qadr = m.jnt_qposadr[jids]
    span = lambda a, b: ix(qadr[:, None] + np.arange(a, b), dev)
    q = lambda a, b: math.normalize_quat(d.qpos[:, span(a, b)])
    qs = lambda a, b: math.normalize_quat(m.qpos_spring[span(a, b)])
    if jt in (JT.SLIDE, JT.HINGE):
      qa = ix(qadr, dev)
      dif = d.qpos[:, qa] - m.qpos_spring[qa]
      e = e + 0.5 * torch.sum(k * dif * dif, -1)
    elif jt == JT.BALL:
      dif = math.quat_sub(q(0, 4), qs(0, 4))
      e = e + 0.5 * torch.sum(k * torch.sum(dif * dif, -1), -1)
    else:  # FREE
      dp = d.qpos[:, span(0, 3)] - m.qpos_spring[span(0, 3)]
      e = e + 0.5 * torch.sum(k * torch.sum(dp * dp, -1), -1)
      dif = math.quat_sub(q(3, 7), qs(3, 7))
      e = e + 0.5 * torch.sum(k * torch.sum(dif * dif, -1), -1)
  if m.ntendon:
    dif = passive.tendon_stretch(m, d)
    e = e + 0.5 * torch.sum(m.tendon_stiffness * dif * dif, -1)
  return e


def energy_vel_value(m: types.Model, d: types.Data) -> torch.Tensor:
  """Kinetic energy 0.5 qvel^T M qvel (W,) (``sensor.py:860``)."""
  return 0.5 * torch.sum(d.qvel * smooth.mul_m(m, d, d.qvel), -1)


def _energy(m, d):
  if d.energy is not None:
    return d.energy.clone()
  return torch.zeros((d.qpos.shape[0], 2), dtype=d.qpos.dtype,
                     device=d.qpos.device)


def energy_pos(m: types.Model, d: types.Data) -> types.Data:
  """energy[:, 0] under ``EnableBit.ENERGY`` (``sensor.py:870``)."""
  if not (m.opt.enableflags & types.EnableBit.ENERGY):
    return d
  e = _energy(m, d)
  e[:, 0] = energy_pos_value(m, d)
  return d.replace(energy=e)


def energy_vel(m: types.Model, d: types.Data) -> types.Data:
  """energy[:, 1] under ``EnableBit.ENERGY`` (``sensor.py:876``)."""
  if not (m.opt.enableflags & types.EnableBit.ENERGY):
    return d
  e = _energy(m, d)
  e[:, 1] = energy_vel_value(m, d)
  return d.replace(energy=e)
