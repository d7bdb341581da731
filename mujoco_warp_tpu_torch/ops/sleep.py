"""Tree sleeping: quiescent kinematic trees stop simulating.

Counterpart of ``mujoco_warp_tpu/ops/sleep.py`` for batched Data:
``enabled`` (:31), ``_tree_masks`` (:35), ``_cannot_sleep`` (:49),
``sleep`` (:66), ``_wake_groups`` (:106), ``sleep_candidate`` (:116),
``wake`` (:135), ``wake_collision`` (:143), ``wake_equality`` (:181),
``mask_sleeping`` (:218) and ``dof_awake_mask`` (:239).  ``tree_asleep``
keeps the JAX encoding (``types.Data``): a sleeping tree holds its
group's smallest tree id, so waking a group is a label compare; an awake
tree holds a counter from ``K_AWAKE`` up to -1 (ready to sleep).  Every
function works on all worlds at once, (W, ntree) per tree and (W, nv) per
dof; a tree-to-tree relation is a (W, ntree, ntree) compare.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, ix

K_AWAKE = types.K_AWAKE
_NEVER = 1  # mjtSleepPolicy.mjSLEEP_AUTO_NEVER


def enabled(m: types.Model) -> bool:
  return bool(m.opt.enableflags & types.EnableBit.SLEEP) and m.ntree > 0


def _tree_masks(m: types.Model):
  """Static (ntree, nv) and (ntree, nbody) membership masks."""
  tdof, tbody = np.asarray(m.dof_treeid), np.asarray(m.body_treeid)
  dof_mask = np.zeros((m.ntree, m.nv), bool)
  ok = tdof >= 0
  dof_mask[tdof[ok], np.arange(m.nv)[ok]] = True
  body_mask = np.zeros((m.ntree, m.nbody), bool)
  okb = tbody >= 0
  body_mask[tbody[okb], np.arange(m.nbody)[okb]] = True
  return dof_mask, body_mask


def _any_per_tree(viol, mask, like):
  """(W, n) bool -> (W, ntree): some member of the tree (by the static
  (ntree, n) ``mask``) is set; a count through a matmul, exact in
  float32."""
  return torch.matmul(viol.to(like.dtype), fmask(mask.T, like)) > 0.0


def _cannot_sleep(m: types.Model, d: types.Data, tol: float):
  """(W, ntree) bool: the tree fails the quiescence test.  ``tol`` > 0
  compares |dof_length qvel| with it in the Model's dtype; 0 asks for
  qvel == 0."""
  dof_mask, body_mask = _tree_masks(m)
  qvel = d.qvel
  if tol > 0.0:
    viol_v = torch.abs(m.dof_length * qvel) >= tol
  else:
    viol_v = qvel != 0.0
  viol = viol_v | (d.qfrc_applied != 0.0)
  viol_x = torch.any(d.xfrc_applied != 0.0, dim=-1)
  bad = _any_per_tree(viol, dof_mask, qvel) | \
      _any_per_tree(viol_x, body_mask, qvel)
  never = bmask(np.asarray(m.tree_sleep_policy) == _NEVER, qvel.device)
  return bad | never


def _tolerance(m: types.Model) -> float:
  return float(types.host(m.opt.sleep_tolerance,
                          types.np_float(types.dtype_of(m))))


def _tree_of_dof(m: types.Model, asleep):
  """(W, nv): each dof's tree's tree_asleep (a world dof reads tree 0's;
  callers mask it with ``dof_treeid >= 0``)."""
  return asleep[:, ix(np.maximum(np.asarray(m.dof_treeid), 0),
                      asleep.device)]


def dof_awake_mask(m: types.Model, d: types.Data):
  """(W, nv) bool: the dof belongs to an awake tree (world dofs: awake)."""
  world = bmask(np.asarray(m.dof_treeid) < 0, d.tree_asleep.device)
  return world | (_tree_of_dof(m, d.tree_asleep) < 0)


def sleep(m: types.Model, d: types.Data) -> types.Data:
  """End-of-step sleep pass: quiescent awake trees count up toward -1; an
  island sleeps only when every member tree is ready or asleep; a
  sleeping tree takes its group's label and its dofs' qvel and qacc are
  zeroed."""
  ntree = m.ntree
  asleep = d.tree_asleep
  cannot = _cannot_sleep(m, d, _tolerance(m))
  awake = asleep < 0
  counted = torch.where(cannot, K_AWAKE, torch.clamp(asleep + 1, max=-1))
  a1 = torch.where(awake, counted, asleep)

  ti = d.tree_island
  ids = torch.arange(ntree, dtype=torch.int32, device=asleep.device)
  constrained = ti >= 0
  same = (ti[:, :, None] == ti[:, None, :]) & constrained[:, :, None] & \
      constrained[:, None, :]
  ready = a1 >= -1
  island_ok = ~torch.any(same & ~ready[:, None, :], dim=2)
  min_id = torch.where(same, ids, ntree).amin(dim=2)
  goes = torch.where(constrained, island_ok & ready, ready)
  label = torch.where(constrained, min_id, ids)
  new_asleep = torch.where(goes, label, a1).to(torch.int32)

  dof_sleeping = ~dof_awake_mask(m, d.replace(tree_asleep=new_asleep))
  zero = torch.zeros_like(d.qvel)
  return d.replace(tree_asleep=new_asleep,
                   qvel=torch.where(dof_sleeping, zero, d.qvel),
                   qacc=torch.where(dof_sleeping, zero, d.qacc))


def _wake_groups(asleep, hit):
  """Wake every tree that shares a sleep label with a hit tree."""
  sleeping = asleep >= 0
  hit = hit & sleeping
  same = (asleep[:, :, None] == asleep[:, None, :]) & \
      sleeping[:, :, None] & sleeping[:, None, :]
  wake_mask = torch.any(same & hit[:, None, :], dim=2)
  return torch.where(wake_mask, K_AWAKE, asleep).to(torch.int32)


def sleep_candidate(m: types.Model, d: types.Data):
  """(W,) bool: some awake tree of the world could pass ``sleep``'s ready
  test this step (its counter at -2 or -1 and quiescent now).  As in the
  JAX package the quiescence test reads the state before integration."""
  cannot = _cannot_sleep(m, d, _tolerance(m))
  a = d.tree_asleep
  return torch.any((a < 0) & (a >= -2) & ~cannot, dim=1)


def wake(m: types.Model, d: types.Data) -> types.Data:
  """Start-of-step wake pass: a sleeping tree with an applied force or a
  velocity wakes with its group."""
  cannot = _cannot_sleep(m, d, 0.0)
  return d.replace(tree_asleep=_wake_groups(d.tree_asleep, cannot))


def _side_hits(m, asleep, ta, tb, sel, world_awake: bool):
  """(W, ntree): trees tb that sleep, touched by an awake tree ta through
  a selected contact or equality (``sel`` (W, k)); ``ta``/``tb`` (W, k)
  tree ids, -1 for the world, which counts as awake when
  ``world_awake``."""
  W = asleep.shape[0]
  at = lambda t: torch.gather(asleep, 1, t.clamp(min=0).expand(W, -1))
  a_awake = torch.where(ta >= 0, at(ta) < 0, world_awake)
  b_sleep = (tb >= 0) & (at(tb) >= 0)
  sel = sel & a_awake & b_sleep
  slot = torch.where(sel, tb.clamp(min=0).expand(W, -1), m.ntree).long()
  hits = torch.zeros((W, m.ntree + 1), dtype=torch.int32,
                     device=asleep.device)
  hits.scatter_add_(1, slot, torch.ones_like(slot, dtype=torch.int32))
  return hits[:, :m.ntree] > 0


def wake_collision(m: types.Model, d: types.Data) -> types.Data:
  """A live contact between an awake and a sleeping tree wakes the
  sleeping group; contacts with static geoms wake nothing.  Compacted
  slots read each slot's candidate (``contact.cand``, -1 empty)."""
  con = d.contact
  if con is None or m.ncon == 0:
    return d
  asleep = d.tree_asleep
  dev = asleep.device
  tree_of_geom = np.asarray(m.body_treeid)[np.asarray(m.geom_bodyid)]
  cp = np.asarray(m.con_pair)
  t1_tab = tree_of_geom[np.asarray(m.pair_geom1)[cp]]
  t2_tab = tree_of_geom[np.asarray(m.pair_geom2)[cp]]
  if m.con_compact:
    cand = con.cand
    valid = cand >= 0
    ci = cand.clamp(min=0).long()
    t1 = torch.where(valid, ix(t1_tab, dev)[ci], -1)
    t2 = torch.where(valid, ix(t2_tab, dev)[ci], -1)
  else:
    t1, t2 = ix(t1_tab, dev)[None], ix(t2_tab, dev)[None]
  active = con.dist < con.includemargin
  hit = _side_hits(m, asleep, t1, t2, active, False) | \
      _side_hits(m, asleep, t2, t1, active, False)
  return d.replace(tree_asleep=_wake_groups(asleep, hit))


def _equality_trees(m: types.Model):
  """Each equality's two trees (-1: the world, or a tendon equality,
  which wakes nothing here)."""
  tbody = np.asarray(m.body_treeid)
  t1s, t2s = [], []
  for e in range(m.neq):
    et = int(m.eq_type[e])
    o1, o2 = int(m.eq_obj1id[e]), int(m.eq_obj2id[e])
    if et in (int(types.EqType.CONNECT), int(types.EqType.WELD)):
      t1s.append(int(tbody[o1]))
      t2s.append(int(tbody[o2]))
    elif et == int(types.EqType.JOINT):
      t1s.append(int(tbody[m.jnt_bodyid[o1]]))
      t2s.append(int(tbody[m.jnt_bodyid[o2]]) if o2 >= 0 else -1)
    else:
      t1s.append(-1)
      t2s.append(-1)
  return np.asarray(t1s, np.int64), np.asarray(t2s, np.int64)


def wake_equality(m: types.Model, d: types.Data) -> types.Data:
  """An active equality between an awake tree (or the world) and a
  sleeping tree wakes the sleeping group."""
  if m.neq == 0:
    return d
  asleep = d.tree_asleep
  t1, t2 = (ix(t, asleep.device)[None] for t in _equality_trees(m))
  active = d.eq_active
  hit = _side_hits(m, asleep, t1, t2, active, True) | \
      _side_hits(m, asleep, t2, t1, active, True)
  return d.replace(tree_asleep=_wake_groups(asleep, hit))


def mask_sleeping(m: types.Model, d: types.Data) -> types.Data:
  """Rows whose Jacobian touches only sleeping dofs get D = 0 (the solve
  gives them zero force) and leave ``efc_active``."""
  J = d.efc_J
  awake = dof_awake_mask(m, d).to(J.dtype)
  row_alive = torch.matmul((J != 0.0).to(J.dtype), awake[..., None])[
      ..., 0] > 0.0
  return d.replace(efc_D=torch.where(row_alive, d.efc_D, 0.0),
                   efc_active=d.efc_active & row_alive)
