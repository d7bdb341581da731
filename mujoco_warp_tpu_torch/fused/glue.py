"""Torch glue between K1 and K4: contact compaction and smooth forces.

Counterpart of the XLA glue in ``mujoco_warp_tpu/pallas/fused.py``:
``_param_classes`` (:790), ``_compact_xla`` (:815), ``_identity_con_xla``
(:948) and ``_middle`` (:1096).  Compaction is a prefix sum plus a
scatter; it keeps the slot order, the ``valid`` mask, the ``dist + 1e10``
fill of empty slots and the CONTACT overflow bit of the one-hot
contraction it replaces, and it fills empty slots with the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.kernels import TableCache

host = types.host


def param_classes(m: types.Model):
  """Per-candidate contact params deduplicated into a class table.

  Returns (class id per candidate (ncand,) int32, table (nclass, 14)
  float32 with columns [includemargin, invweight, friction 5, solref 2,
  solimp 5])."""
  cp = m.con_pair
  iw0 = host(m.body_invweight0, np.float32)
  b1 = m.geom_bodyid[m.pair_geom1[cp]]
  b2 = m.geom_bodyid[m.pair_geom2[cp]]
  rows = np.concatenate([
      host(m.cand_includemargin, np.float32)[:, None],
      (iw0[b1, 0] + iw0[b2, 0])[:, None],
      host(m.cand_friction, np.float32)[:, :5],
      host(m.cand_solref, np.float32),
      host(m.cand_solimp, np.float32)], axis=1)
  uniq, pc = np.unique(rows, axis=0, return_inverse=True)
  return pc.reshape(-1).astype(np.int32), uniq.astype(np.float32)


def _cand_bodies(m: types.Model):
  cp = m.con_pair
  return (m.geom_bodyid[m.pair_geom1[cp]], m.geom_bodyid[m.pair_geom2[cp]])


def _compact_plan(m: types.Model, device) -> list:
  """Per condim class, the device constants compaction reads: candidate
  rows, margins, ids, and the param, dof-mask and root tables.  An id the
  class never holds reads zeros, as the one-hot selection does for the
  id 0 that empty slots carry."""
  pc_np, pc_tab = param_classes(m)
  b1_np, b2_np = _cand_bodies(m)
  im_np = host(m.cand_includemargin, np.float32)
  body_dof = m.tree.body_dof_mask.astype(np.float32)  # (nbody, nv)
  t = lambda x, dt=None: torch.as_tensor(np.asarray(x, dt), device=device)
  plan = []
  for _, cap, ci, _ in m.con_classes:
    present_pc = np.zeros(len(pc_tab), np.float32)
    present_pc[np.unique(pc_np[ci])] = 1.0
    present_b = np.zeros(m.nbody, np.float32)
    present_b[np.unique(np.concatenate([b1_np[ci], b2_np[ci]]))] = 1.0
    plan.append(dict(
        cap=cap, ci=t(ci, np.int64), im=t(im_np[ci])[:, None],
        ids=t(np.stack([pc_np[ci], b1_np[ci], b2_np[ci]]), np.int64),
        ptab=t(pc_tab * present_pc[:, None]),
        dmask=t(body_dof * present_b[:, None]), pres=t(present_b),
        roots=t(m.body_rootid, np.int64)))
  return plan


_PLANS = TableCache(_compact_plan)


def compact(m: types.Model, dist, cpos, cframe, stcom):
  """Per-condim-class actives-first compaction (``_compact_xla``).

  dist (ncand, W), cpos (3 ncand, W), cframe (9 ncand, W), stcom
  (3 nbody, W).  Returns (con dict of (rows, W) tensors in K4's slot
  layout, overflow (1, W) int32)."""
  nv, W = m.nv, dist.shape[-1]
  dev, dt = dist.device, dist.dtype
  pos3 = cpos.reshape(-1, 3, W)
  fr9 = cframe.reshape(-1, 9, W)
  stcom3 = stcom.reshape(-1, 3, W)
  outs = {k: [] for k in ('dist', 'pos', 'frame', 'im', 'friction',
                          'solref', 'solimp', 'invweight', 'mask1', 'mask2',
                          'com1', 'com2')}
  overflow = torch.zeros((1, W), dtype=torch.int32, device=dev)
  for c in _PLANS.get(m, dev):
    cap, ci = c['cap'], c['ci']
    ncc = len(ci)
    distc = dist[ci]
    act = distc < c['im']
    pref = torch.cumsum(act.to(torch.int32), dim=0)
    rank = pref - act.to(torch.int32)  # exclusive prefix = compact slot
    slot = torch.where(act & (rank < cap), rank, cap).to(torch.int64)

    def scatter(vals):  # (ncc, k, W) -> (cap, k, W), empty slots 0
      k = vals.shape[1]
      out = torch.zeros((cap + 1, k, W), dtype=vals.dtype, device=dev)
      out.scatter_(0, slot[:, None, :].expand(ncc, k, W), vals)
      return out[:cap]

    valid = scatter(torch.ones((ncc, 1, W), dtype=dt, device=dev))[:, 0]
    outs['dist'].append(scatter(distc[:, None])[:, 0] + (1.0 - valid) * 1e10)
    outs['pos'].append(scatter(pos3[ci]).reshape(cap * 3, W))
    outs['frame'].append(scatter(fr9[ci]).reshape(cap * 9, W))
    pcs, b1s, b2s = scatter(c['ids'].T[:, :, None].expand(ncc, 3, W)) \
        .unbind(1)
    ptab = c['ptab'][pcs]  # (cap, W, 14)
    outs['im'].append(ptab[..., 0] * valid)
    outs['invweight'].append(ptab[..., 1])
    outs['friction'].append(ptab[..., 2:7].permute(0, 2, 1).reshape(cap * 5, W))
    outs['solref'].append(ptab[..., 7:9].permute(0, 2, 1).reshape(cap * 2, W))
    outs['solimp'].append(ptab[..., 9:14].permute(0, 2, 1).reshape(cap * 5, W))
    for mk, ck, bs in (('mask1', 'com1', b1s), ('mask2', 'com2', b2s)):
      outs[mk].append(c['dmask'][bs].permute(0, 2, 1).reshape(cap * nv, W))
      com = torch.gather(stcom3, 0,
                         c['roots'][bs][:, None, :].expand(cap, 3, W))
      outs[ck].append((com * c['pres'][bs][:, None, :]).reshape(cap * 3, W))
    nact = pref[ncc - 1:ncc]
    overflow = overflow | torch.where(
        nact > cap, int(types.OverflowType.CONTACT), 0).to(torch.int32)
  return {k: torch.cat(v) for k, v in outs.items()}, overflow


def identity_con(m: types.Model, dist, cpos, cframe, stcom):
  """No compaction: candidate order is slot order (``_identity_con_xla``)."""
  W = dist.shape[-1]
  dev, dt = dist.device, dist.dtype
  b1, b2 = _cand_bodies(m)
  pc_np, pc_tab = param_classes(m)
  bd = m.tree.body_dof_mask

  def const(x):
    x = torch.tensor(np.asarray(x, np.float32).reshape(-1), dtype=dt,
                     device=dev)
    return x[:, None].expand(len(x), W).contiguous()

  com = lambda bs: torch.cat([stcom[3 * int(r):3 * int(r) + 3]
                              for r in m.body_rootid[bs]])
  con = {
      'dist': dist, 'pos': cpos, 'frame': cframe,
      'im': const(host(m.cand_includemargin, np.float32)),
      'friction': const(pc_tab[pc_np, 2:7]),
      'solref': const(pc_tab[pc_np, 7:9]),
      'solimp': const(pc_tab[pc_np, 9:14]),
      'invweight': const(pc_tab[pc_np, 1]),
      'mask1': const(bd[b1]), 'mask2': const(bd[b2]),
      'com1': com(b1), 'com2': com(b2),
  }
  return con, torch.zeros((1, W), dtype=torch.int32, device=dev)


def _middle_plan(m: types.Model, device) -> dict:
  """Device constants of the smooth forces.  They are uploaded once per
  model: a copy from pageable host memory waits for the stream, so an
  upload every step would hold the host until K4 finished."""
  t = lambda x, dt=np.float32: torch.as_tensor(np.asarray(x, dt),
                                               device=device)
  col = lambda x: t(host(x, np.float32))[:, None]
  plan = dict(damping=col(m.dof_damping), force_lim=None, spring_q=None)
  if m.nu:
    rng = host(m.actuator_ctrlrange, np.float32)
    plan.update(
        ctrl_lim=t(m.actuator_ctrllimited, bool)[:, None],
        ctrl_lo=col(rng[:, 0]), ctrl_hi=col(rng[:, 1]),
        gain=col(host(m.actuator_gainprm, np.float32)[:, 0]),
        act_dof=t(m.jnt_dofadr[m.actuator_trnid[:, 0]], np.int64),
        gear=col(host(m.actuator_gear, np.float32)[:, 0]))
    frclim = m.actuator_forcelimited.astype(bool)
    if frclim.any():
      frng = host(m.actuator_forcerange, np.float32)
      plan.update(force_lim=t(frclim, bool)[:, None],
                  force_lo=col(frng[:, 0]), force_hi=col(frng[:, 1]))
  stiff = host(m.jnt_stiffness, np.float32)
  sj = np.nonzero(stiff > 0)[0]
  if len(sj):
    plan.update(
        spring_q=t(m.jnt_qposadr[sj], np.int64),
        spring_d=t(m.jnt_dofadr[sj], np.int64), stiff=col(stiff[sj]),
        qpos_spring=col(host(m.qpos_spring, np.float32)[m.jnt_qposadr[sj]]))
  return plan


_MIDDLE = TableCache(_middle_plan)


def middle(m: types.Model, bias, qpos, qvel, ctrl):
  """qfrc_smooth = passive - bias + actuation, lanes-last (``_middle``)."""
  nv, W = m.nv, qpos.shape[-1]
  dev, dt = qpos.device, qpos.dtype
  c = _MIDDLE.get(m, dev)
  qfrc_act = torch.zeros((nv, W), dtype=dt, device=dev)
  if m.nu:
    ctrl_c = torch.where(c['ctrl_lim'], torch.minimum(
        torch.maximum(ctrl, c['ctrl_lo']), c['ctrl_hi']), ctrl)
    force = c['gain'] * ctrl_c
    if c['force_lim'] is not None:
      force = torch.where(c['force_lim'], torch.minimum(
          torch.maximum(force, c['force_lo']), c['force_hi']), force)
    qfrc_act.index_add_(0, c['act_dof'], c['gear'] * force)
  qfrc_passive = -c['damping'] * qvel
  if c['spring_q'] is not None:
    contrib = -c['stiff'] * (qpos[c['spring_q']] - c['qpos_spring'])
    qfrc_passive.index_add_(0, c['spring_d'], contrib)
  return qfrc_passive - bias + qfrc_act
