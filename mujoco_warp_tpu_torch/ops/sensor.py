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
:734, :742).  RANGEFINDER casts one ``ops/ray.rays`` per body of its
sites along each site's z axis, the site's body excluded (:326-337);
GEOMDIST, GEOMNORMAL and GEOMFROMTO take the nearest point pair of the
general step's colliders over the geoms of their operands, held to the
sensor's cutoff (:271-324); the structured contact sensor
(``_contact_sensor`` :505) matches each world's contact slots to its
operands per world.  A sensor with a history reads back its delayed
value (``ops/history.apply_sensor_delay``, after the acceleration
stage).  ``DEFERRED`` names the types that wait for their
subsystems (tactile meshes); ``ops/forward.unsupported`` refuses a model
that has one.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import collision_driver, history, math, \
    passive, ray, smooth
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, ix


def _wf(m, name, idx, dev):
  """Model field ``name`` at element ids ``idx``, per world (1 or W,
  n, ...)."""
  return types.world_field(m, name)[:, ix(idx, dev)]


_ST = types.SensorType
_OT = types.ObjType

# sensor type -> the subsystem it waits for
DEFERRED = {int(_ST.TACTILE): 'meshes'}

POS_TYPES = (
    _ST.MAGNETOMETER, _ST.JOINTPOS, _ST.TENDONPOS, _ST.ACTUATORPOS,
    _ST.BALLQUAT, _ST.JOINTLIMITPOS, _ST.TENDONLIMITPOS, _ST.FRAMEPOS, _ST.FRAMEQUAT, _ST.FRAMEXAXIS,
    _ST.FRAMEYAXIS, _ST.FRAMEZAXIS, _ST.SUBTREECOM, _ST.CLOCK,
    _ST.E_POTENTIAL, _ST.E_KINETIC, _ST.RANGEFINDER, _ST.GEOMDIST,
    _ST.GEOMNORMAL, _ST.GEOMFROMTO, _ST.CAMPROJECTION, _ST.INSIDESITE)
VEL_TYPES = (
    _ST.VELOCIMETER, _ST.GYRO, _ST.JOINTVEL, _ST.TENDONVEL, _ST.ACTUATORVEL,
    _ST.BALLANGVEL, _ST.JOINTLIMITVEL, _ST.TENDONLIMITVEL, _ST.FRAMELINVEL,
    _ST.FRAMEANGVEL, _ST.SUBTREELINVEL, _ST.SUBTREEANGMOM)
ACC_TYPES = (
    _ST.TOUCH, _ST.ACCELEROMETER, _ST.FORCE, _ST.TORQUE, _ST.ACTUATORFRC,
    _ST.JOINTACTFRC, _ST.TENDONACTFRC, _ST.JOINTLIMITFRC,
    _ST.TENDONLIMITFRC, _ST.FRAMELINACC, _ST.FRAMEANGACC, _ST.CONTACT)


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
      qo = math.mul_quat(d.xquat[:, ix(oid, dev)],
                         _wf(m, 'body_iquat', oid, dev))
    elif ot == _OT.XBODY:
      qo = d.xquat[:, ix(oid, dev)]
    elif ot == _OT.GEOM:
      qo = math.mul_quat(d.xquat[:, ix(m.geom_bodyid[oid], dev)],
                         _wf(m, 'geom_quat', oid, dev))
    elif ot == _OT.SITE:
      qo = math.mul_quat(d.xquat[:, ix(m.site_bodyid[oid], dev)],
                         _wf(m, 'site_quat', oid, dev))
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
  """(W, ...) bool: points (W, ..., 3) inside the site's primitive
  volume."""
  W = points.shape[0]
  lead = (W,) + (1,) * (points.dim() - 2)
  pl = torch.einsum('wni,wij->wnj', (points - d.site_xpos[:, siteid].reshape(
      lead + (3,))).reshape(W, -1, 3), d.site_xmat[:, siteid]).reshape(
          points.shape)
  # the site's size per world where it is batched
  s = types.world_field(m, 'site_size')[:, siteid].reshape(
      (-1,) + lead[1:] + (3,))
  s0, s1 = s[..., 0], s[..., 1]
  st = int(m.site_type[siteid])
  GT = types.GeomType
  if st == GT.SPHERE:
    return torch.sum(pl * pl, -1) < s0 * s0
  if st == GT.CAPSULE:
    zd = pl[..., 2] - torch.minimum(torch.maximum(pl[..., 2], -s1), s1)
    return pl[..., 0] ** 2 + pl[..., 1] ** 2 + zd * zd < s0 * s0
  if st == GT.ELLIPSOID:
    ps = pl / s
    return torch.sum(ps * ps, -1) < 1.0
  if st == GT.CYLINDER:
    return (torch.abs(pl[..., 2]) < s1) & (
        pl[..., 0] ** 2 + pl[..., 1] ** 2 < s0 * s0)
  if st == GT.BOX:
    return torch.all(torch.abs(pl) < s, -1)
  if st == GT.PLANE:
    return pl[..., 2] < 0.0
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
  ss, intr = _wf(m, 'cam_sensorsize', refid, dev), _wf(m, 'cam_intrinsic',
                                                       refid, dev)
  f_fovy = 0.5 / torch.tan(_wf(m, 'cam_fovy', refid, dev) * np.pi /
                           360.0) * res[:, 1]
  use_intr = (ss[..., 0] != 0.0) & (ss[..., 1] != 0.0)
  fx = torch.where(use_intr, intr[..., 0] / (ss[..., 0] + 1e-15) *
                   res[:, 0], f_fovy)
  fy = torch.where(use_intr, intr[..., 1] / (ss[..., 1] + 1e-15) *
                   res[:, 1], f_fovy)
  den = v[..., 2]
  den = torch.where(torch.abs(den) < 1e-15, torch.clamp(den, -1e-15, 1e-15),
                    den)
  px = -fx * v[..., 0] / den + 0.5 * res[:, 0]
  py = fy * v[..., 1] / den + 0.5 * res[:, 1]
  return torch.stack([px, py], -1).to(dt)


def _rangefinder(m, d, objid):
  """RANGEFINDER (W, n): the distance along each site's z axis to the
  nearest geom, -1 where none is hit, one ``ray.rays`` per body of the
  sites with that body excluded (``sensor.py:326-337``)."""
  dev = d.qpos.device
  si = ix(objid, dev)
  pnt, vec = d.site_xpos[:, si], d.site_xmat[:, si][..., 2]
  body = np.asarray(m.site_bodyid)[objid]
  val = torch.empty(pnt.shape[:2], dtype=pnt.dtype, device=dev)
  with torch.profiler.record_function('stage:rays'):
    for b in np.unique(body):
      sel = ix(np.nonzero(body == b)[0], dev)
      val[:, sel] = ray.rays(m, d, pnt[:, sel], vec[:, sel],
                             bodyexclude=int(b))[0]
  return val


def _operand_geoms(m, ot: int, oi: int) -> list:
  """The geoms of a geom-distance operand: the geom, or a body's."""
  if ot == _OT.GEOM:
    return [oi]
  if ot in (_OT.BODY, _OT.XBODY):
    return [int(g) for g in np.nonzero(np.asarray(m.geom_bodyid) == oi)[0]]
  raise NotImplementedError(f'geom distance operand of object type {ot}')


def _pair_distance(m, d, g1: int, g2: int):
  """The deepest contact point of the general step's collider of two
  geoms, per world: dist (W,), pos (W, 3) and the normal from g1 to g2
  (W, 3) (``sensor.py:283-296``)."""
  t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
  swap = t1 > t2
  if swap:
    g1, g2, t1, t2 = g2, g1, t2, t1
  out = collision_driver.collider(t1, t2)(m, d, np.asarray([g1]),
                                          np.asarray([g2]))
  dist, pos, nrm = out[0][..., 0], out[1][..., 0, :], out[2][..., 0, :]
  best = torch.argmin(dist, 1)
  w = torch.arange(dist.shape[0], device=dist.device)
  return dist[w, best], pos[w, best], nrm[w, best] * (-1.0 if swap else 1.0)


def _geom_distance(m, d, s: int, t: int):
  """GEOMDIST (W, 1), GEOMNORMAL (W, 3) or GEOMFROMTO (W, 6) of sensor
  ``s`` (``sensor.py:271-324``): the nearest of its operands' geom pairs,
  the distance held to the cutoff, the normal and the segment between
  the surface points only where it is below the cutoff (zeros
  otherwise)."""
  gs1 = _operand_geoms(m, int(m.sensor_objtype[s]), int(m.sensor_objid[s]))
  gs2 = _operand_geoms(m, int(m.sensor_reftype[s]), int(m.sensor_refid[s]))
  cands = [_pair_distance(m, d, a, b) for a in gs1 for b in gs2]
  dists = torch.stack([c[0] for c in cands], 1)
  best = torch.argmin(dists, 1)
  w = torch.arange(dists.shape[0], device=dists.device)
  raw = dists[w, best]
  pos = torch.stack([c[1] for c in cands], 1)[w, best]
  normal = torch.stack([c[2] for c in cands], 1)[w, best]
  cutoff = m.sensor_cutoff[s].to(raw.dtype)
  dist = torch.minimum(raw, cutoff)
  if t == _ST.GEOMDIST:
    return dist[:, None]
  hit = (raw < cutoff)[:, None]
  if t == _ST.GEOMNORMAL:
    return torch.where(hit, normal, torch.zeros_like(normal))
  half = (0.5 * dist)[:, None] * normal
  seg = torch.cat([pos - half, pos + half], -1)
  return torch.where(hit, seg, torch.zeros_like(seg))


# the contact sensor's data fields, in dataspec bit order, and their dims
_CONTACT_DIMS = (1, 3, 3, 1, 3, 3, 3)


def _contact_match(m, b, g, ot: int, oi: int):
  """(W, ncon) bool: does a slot's operand (body b, geom g) match the
  sensor's operand (``sensor.py:532-543``)?  An unknown or site operand
  matches every slot (the site's volume is tested on the point)."""
  if ot == 0 or ot == _OT.SITE:
    return torch.ones_like(b, dtype=torch.bool)
  if ot == _OT.GEOM:
    return g == oi
  if ot == _OT.BODY:
    return b == oi
  if ot == _OT.XBODY:
    return bmask(m.tree.subtree_mask[oi], b.device)[b]
  return torch.zeros_like(b, dtype=torch.bool)


def _contact_sensor(m, d, sd, s: int):
  """The structured contact sensor ``s`` into sd (``sensor.py:505``):
  the live slots (dist below the candidate's full margin) whose operands
  match, per world, since a compacted slot holds a different contact in
  each world; the found count, force, torque, dist, pos, normal and
  tangent of its dataspec bits, for up to ``num`` matches ordered by the
  reduction (none: slot order, mindist, maxforce), or netforce's
  force-weighted centroid wrench."""
  dev, dt = d.qpos.device, d.qpos.dtype
  adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
  sd[:, adr:adr + dim] = 0.0
  if m.ncon == 0 or d.contact is None:
    return
  con = d.contact
  W = sd.shape[0]
  cand = con.cand.long()
  margin = types.world_field(m, 'cand_margin').expand(W, -1)
  marg = torch.where(cand >= 0, torch.gather(margin, 1, cand.clamp(min=0)),
                     torch.zeros((), dtype=dt, device=dev))
  wrench = smooth.contact_forces_local(m, d)  # (W, ncon, 6)
  b1, b2 = smooth.contact_bodies(m, d)
  g1, g2 = con.geom1.long(), con.geom2.long()
  ot1, oi1 = int(m.sensor_objtype[s]), int(m.sensor_objid[s])
  ot2, oi2 = int(m.sensor_reftype[s]), int(m.sensor_refid[s])
  dataspec, reduce = int(m.sensor_intprm[s, 0]), int(m.sensor_intprm[s, 1])
  flags = [bool(dataspec & (1 << i)) for i in range(7)]
  size = sum(k for f, k in zip(flags, _CONTACT_DIMS) if f)
  num = dim // size
  m11 = _contact_match(m, b1, g1, ot1, oi1)
  m12 = _contact_match(m, b2, g2, ot1, oi1)
  m21 = _contact_match(m, b1, g1, ot2, oi2)
  m22 = _contact_match(m, b2, g2, ot2, oi2)
  matched = (m11 | m12) & (m21 | m22)
  one = torch.ones((), dtype=dt, device=dev)
  dir_f = torch.ones((W, m.ncon), dtype=dt, device=dev)
  if ot1 != 0 and ot2 != 0:
    regular, reverse = m11 & m22, m12 & m21
    matched = matched & (regular | reverse)
    dir_f = torch.where(reverse & ~regular, -one, one)
  elif ot1 != 0:
    dir_f = torch.where(m11, one, -one)
  elif ot2 != 0:
    dir_f = torch.where(m22, one, -one)
  found = matched & (con.dist < marg)
  if ot1 == _OT.SITE:
    found = found & _inside_site(m, d, oi1, con.pos)
  nmatch = found.to(dt).sum(1)  # (W,)
  dirv = dir_f[..., None]
  w = wrench * dirv
  frame = con.frame
  if reduce == 3:  # netforce: the force-weighted centroid's wrench
    fm = found.to(dt)[..., None]
    weight = math.norm(wrench[..., :3], keepdim=True) * fm
    f_g = torch.einsum('wnij,wni->wnj', frame, w[..., :3]) * fm
    t_g = torch.einsum('wnij,wni->wnj', frame, w[..., 3:]) * fm
    net_pos = torch.sum(weight * con.pos, 1) / torch.clamp(
        torch.sum(weight, 1), min=1e-15)
    net_f = torch.sum(f_g, 1)
    net_t = torch.sum(t_g + math.cross(con.pos, f_g), 1) - \
        math.cross(net_pos, net_f)
    e = lambda *v: fmask(np.asarray(v, np.float64), sd).expand(W, len(v))
    vals = [nmatch[:, None], net_f, net_t, e(0.0), net_pos,
            e(1.0, 0.0, 0.0), e(0.0, 1.0, 0.0)]
    sd[:, adr:adr + size] = torch.cat(
        [v for f, v in zip(flags, vals) if f], -1).to(sd.dtype)
    return
  cols = []
  if flags[0]:
    cols.append(nmatch[:, None, None].expand(W, m.ncon, 1))
  if flags[1]:
    cols.append(torch.stack([wrench[..., 0], wrench[..., 1], w[..., 2]], -1))
  if flags[2]:
    cols.append(torch.stack([wrench[..., 3], wrench[..., 4], w[..., 5]], -1))
  if flags[3]:
    cols.append(con.dist[..., None])
  if flags[4]:
    cols.append(con.pos)
  if flags[5]:
    cols.append(frame[..., 0, :] * dirv)
  if flags[6]:
    cols.append(frame[..., 1, :] * dirv)
  V = torch.cat(cols, -1)  # (W, ncon, size)
  if reduce == 1:  # mindist
    crit = con.dist
  elif reduce == 2:  # maxforce
    crit = -torch.sum(wrench[..., :3] ** 2, -1)
  else:
    crit = torch.arange(m.ncon, dtype=dt, device=dev).expand(W, m.ncon)
  crit = torch.where(found, crit, torch.full_like(crit, float('inf')))
  order = torch.argsort(crit, dim=1, stable=True)
  take = min(num, m.ncon)
  rows = torch.gather(V, 1, order[:, :take, None].expand(W, take, size))
  valid = torch.arange(take, device=dev)[None] < nmatch[:, None]
  rows = rows * valid[..., None].to(dt)
  sd[:, adr:adr + take * size] = rows.reshape(W, -1).to(sd.dtype)


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
      val = torch.einsum('wnji,wj->wni', d.site_xmat[:, ix(objid, dev)],
                         types.world_field(m, 'opt.magnetic').to(
                             sd.dtype).expand(d.qpos.shape[0], 3))
    elif t == _ST.RANGEFINDER:
      val = _rangefinder(m, d, objid)
    elif t in (_ST.GEOMDIST, _ST.GEOMNORMAL, _ST.GEOMFROMTO):
      val = torch.stack([_geom_distance(m, d, int(s), t) for s in ids], 1)
    elif t == _ST.CAMPROJECTION:
      val = _cam_projection(m, d, ids)
    elif t == _ST.INSIDESITE:
      pos = _obj_pos(m, d, objtype, objid)
      # a massless body with a massive subtree reads its subtree's CoM
      # (each world's masses: no host read)
      body = np.where(objtype == _OT.BODY, objid, 0)
      mass = types.world_field(m, 'body_mass')[:, ix(body, dev)]
      smass = types.world_field(m, 'body_subtreemass')[:, ix(body, dev)]
      use_com = bmask(body > 0, dev) & (mass < 1e-15) & (smass >= 1e-15)
      pos = torch.where(use_com[..., None],
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
  mass = types.world_field(m, 'body_mass')  # (1 or W, nbody)
  off = d.xipos - d.subtree_com[:, ix(m.body_rootid, dev)]
  ang = d.cvel[..., :3]
  lin = d.cvel[..., 3:] - math.cross(off, ang)
  sub = fmask(m.tree.subtree_mask, d.qpos)
  subtree_mass = torch.clamp(torch.sum(sub * mass[:, None, :], dim=-1),
                             min=1e-12)
  linvel = torch.einsum('sb,wbi->wsi', sub, mass[..., None] * lin) / \
      subtree_mass[..., None]
  inertia = types.world_field(m, 'body_inertia')
  I3 = d.ximat @ (inertia[..., None] * d.ximat.transpose(-1, -2))
  spin = torch.einsum('wbij,wbj->wbi', I3, ang)
  rel_p = d.xipos[:, None] - d.subtree_com[:, :, None]  # (W, s, b, 3)
  rel_v = lin[:, None] - linvel[:, :, None]
  orb = math.cross(rel_p, rel_v) * mass[:, None, :, None]
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
  ``rne_postconstraint`` when the model has any; then every sensor's
  delay (``_finish_acc`` :792, in a model without acceleration sensors
  too)."""
  if not _enabled(m):
    return d
  g = _groups(m, ACC_TYPES)
  if not g:
    return history.apply_sensor_delay(m, d)
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
    elif t == _ST.CONTACT:
      for s in ids:
        _contact_sensor(m, d, sd, int(s))
      continue
    _write(sd, m, ids, val)
  return history.apply_sensor_delay(
      m, d.replace(sensordata=_apply_cutoff(m, sd)))


def energy_pos_value(m: types.Model, d: types.Data) -> torch.Tensor:
  """Potential energy (W,): gravity, joint springs and tendon springs
  past their deadband (``sensor.py:822``)."""
  dev, dt = d.qpos.device, d.qpos.dtype
  W = d.qpos.shape[0]
  e = torch.zeros(W, dtype=dt, device=dev)
  if not (m.opt.disableflags & types.DisableBit.GRAVITY):
    grav = types.world_field(m, 'opt.gravity')[:, None]  # (1 or W, 1, 3)
    e = e - torch.sum(types.world_field(m, 'body_mass')[..., None] *
                      d.xipos * grav, dim=(1, 2))
  if m.opt.disableflags & types.DisableBit.SPRING:
    return e
  JT = types.JointType
  spring = types.world_field(m, 'qpos_spring')  # (1 or W, nq)
  for jt in np.unique(m.jnt_type):
    jids = np.nonzero(m.jnt_type == jt)[0]
    k = _wf(m, 'jnt_stiffness', jids, dev)
    qadr = m.jnt_qposadr[jids]
    span = lambda a, b: ix(qadr[:, None] + np.arange(a, b), dev)
    q = lambda a, b: math.normalize_quat(d.qpos[:, span(a, b)])
    qs = lambda a, b: math.normalize_quat(spring[:, span(a, b)])
    if jt in (JT.SLIDE, JT.HINGE):
      qa = ix(qadr, dev)
      dif = d.qpos[:, qa] - spring[:, qa]
      e = e + 0.5 * torch.sum(k * dif * dif, -1)
    elif jt == JT.BALL:
      dif = math.quat_sub(q(0, 4), qs(0, 4))
      e = e + 0.5 * torch.sum(k * torch.sum(dif * dif, -1), -1)
    else:  # FREE
      dp = d.qpos[:, span(0, 3)] - spring[:, span(0, 3)]
      e = e + 0.5 * torch.sum(k * torch.sum(dp * dp, -1), -1)
      dif = math.quat_sub(q(3, 7), qs(3, 7))
      e = e + 0.5 * torch.sum(k * torch.sum(dif * dif, -1), -1)
  if m.ntendon:
    dif = passive.tendon_stretch(m, d)
    e = e + 0.5 * torch.sum(types.world_field(m, 'tendon_stiffness') *
                            dif * dif, -1)
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
