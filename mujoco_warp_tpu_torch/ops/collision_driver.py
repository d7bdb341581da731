"""Collision of the general step over the static candidate table,
world-major.

Counterpart of ``mujoco_warp_tpu/ops/collision_driver.py``:
``group_ncon`` (:317), ``_pack_nearest`` (:417),
``_narrowphase_candidates`` (:516) and ``collision`` (:545), without and
with contact compaction (:559-640); height-field pairs take
``ops/collision_hfield.py`` (:169-180, :333-336, :486-489).  Every
candidate pair runs its collider every step; a candidate is live iff its dist is below the pair's
includemargin.  Under compaction each condim class keeps its ``cap``
deepest live candidates in its slots.  The broadphase-pruned branch
(``_collision_pruned`` :650, ``bp_groups``) belongs to a later slice; the
port's models have no pruned group.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import collision_convex, collision_hfield, \
    collision_primitive, math
from mujoco_warp_tpu_torch.ops.util import ix

# the dist of an empty compacted slot (collision_driver.py _BIG)
BIG = 1e10


def group_ncon(t1, t2) -> int:
  """Contact points per pair of a (t1, t2) collider group."""
  key = (int(t1), int(t2))
  if key[0] == types.GeomType.HFIELD:
    return collision_hfield.HFIELD_NCON[key[1]]
  if key in collision_primitive.PAIR_NCON:
    return collision_primitive.PAIR_NCON[key]
  return collision_convex.convex_ncon(*key)


def collider(t1, t2):
  """The collider function of a (t1, t2) group, or NotImplementedError."""
  fn = collision_primitive.COLLIDERS.get((int(t1), int(t2)))
  if fn is not None:
    return fn
  if int(t1) == types.GeomType.HFIELD:
    return collision_hfield.make_hfield_collider(int(t2))
  if int(t1) in collision_convex.CONVEX_TYPES and \
      int(t2) in collision_convex.CONVEX_TYPES:
    return collision_convex.make_convex_collider(int(t1), int(t2))
  raise NotImplementedError(
      f'collision pair {(types.GeomType(int(t1)).name, types.GeomType(int(t2)).name)}'
      ' has no collider in the general step')


def _narrowphase_candidates(m: types.Model, d: types.Data):
  """dist (W, ncon), pos (W, ncon, 3) and frame (W, ncon, 3, 3) over every
  candidate slot, group by group in slot order (each group's slots are
  contact-point-major, (k, npair))."""
  dists, poss, frames = [], [], []
  W = d.geom_xpos.shape[0]
  for (t1, t2, idx, _) in m.pair_groups:
    fn = collider(t1, t2)
    if t1 == types.GeomType.HFIELD:
      # its own span (``devprofile``), inside 'collision'
      with torch.profiler.record_function('stage:hfield'):
        out = fn(m, d, m.pair_geom1[idx], m.pair_geom2[idx])
    else:
      out = fn(m, d, m.pair_geom1[idx], m.pair_geom2[idx])
    dist, pos, normal = out[:3]
    frame = out[3] if len(out) == 4 else math.make_frame(normal)
    dists.append(dist.reshape(W, -1))
    poss.append(pos.reshape(W, -1, 3))
    frames.append(frame.reshape(W, -1, 3, 3))
  return torch.cat(dists, 1), torch.cat(poss, 1), torch.cat(frames, 1)


def cand_tables(m: types.Model, W: int) -> dict:
  """The candidate tables (``io.CAND_FIELDS``) as (W, ncand, ...) views:
  each world's own where ``io.batch_model`` batched them, else one table
  for every world."""
  out = {}
  for name in ('cand_includemargin', 'cand_friction', 'cand_solref',
               'cand_solimp'):
    x = types.world_field(m, name)
    out[name] = x.expand((W,) + tuple(x.shape[1:]))
  return out


def collision(m: types.Model, d: types.Data) -> types.Data:
  """Narrowphase over all candidate pairs into the contact slots, and the
  count of live slots per world (``collision_driver.py:545``)."""
  if m.ncon == 0 or (m.opt.disableflags & types.DisableBit.CONTACT):
    return d
  dist, pos, frame = _narrowphase_candidates(m, d)
  if m.con_compact:
    return _compact(m, d, dist, pos, frame)
  W, dev = dist.shape[0], dist.device
  per_world = lambda x: x[None].expand((W,) + tuple(x.shape))
  ct = cand_tables(m, W)
  im = ct['cand_includemargin']
  cp = m.con_pair
  contact = types.Contact(
      dist=dist, pos=pos, frame=frame, includemargin=im,
      friction=ct['cand_friction'], solref=ct['cand_solref'],
      solreffriction=torch.zeros_like(ct['cand_solref']),
      solimp=ct['cand_solimp'],
      geom1=per_world(ix(m.pair_geom1[cp], dev).int()),
      geom2=per_world(ix(m.pair_geom2[cp], dev).int()),
      cand=per_world(ix(np.arange(m.ncon), dev).int()))
  ncon_active = torch.sum((dist < im).int(), dim=1, dtype=torch.int32)
  return d.replace(contact=contact, ncon_active=ncon_active)


def _compact(m: types.Model, d: types.Data, dist, pos, frame):
  """Per condim class, the ``cap`` live candidates of smallest dist in
  the class's slots, deepest first (``collision_driver.py:601-640``,
  ``torch.topk`` for ``lax.top_k``).  An empty slot has dist 1e10,
  includemargin 0 and cand -1; geom1/geom2 and the mixed parameters follow
  the selected candidate.  The CONTACT overflow bit marks a world where
  a class had more live candidates than slots."""
  W, dev = dist.shape[0], dist.device
  ct = cand_tables(m, W)
  im = ct['cand_includemargin']
  sels, valids = [], []
  ncon_active = torch.zeros(W, dtype=torch.int32, device=dev)
  over = torch.zeros(W, dtype=torch.bool, device=dev)
  for _, cap, ci, _ in m.con_classes:
    ci_t = ix(ci, dev)
    dc = dist[:, ci_t]
    act = dc < im[:, ci_t]
    key = torch.where(act, dc, torch.full((), BIG, dtype=dc.dtype,
                                           device=dev))
    order = torch.topk(-key, cap, dim=1, sorted=True).indices
    sels.append(ci_t[order])
    valids.append(torch.gather(act, 1, order))
    nact = act.sum(1, dtype=torch.int32)
    ncon_active = ncon_active + torch.clamp(nact, max=cap)
    over = over | (nact > cap)
  sel = torch.cat(sels, 1)  # (W, ncon) candidate ids
  valid = torch.cat(valids, 1)
  w = torch.arange(W, device=dev)[:, None]
  cp = ix(m.con_pair, dev)[sel]
  solref = ct['cand_solref'][w, sel]
  contact = types.Contact(
      dist=torch.where(valid, dist[w, sel],
                       torch.full((), BIG, dtype=dist.dtype, device=dev)),
      pos=pos[w, sel], frame=frame[w, sel],
      includemargin=im[w, sel] * valid.to(dist.dtype),
      friction=ct['cand_friction'][w, sel], solref=solref,
      solreffriction=torch.zeros_like(solref),
      solimp=ct['cand_solimp'][w, sel],
      geom1=ix(m.pair_geom1, dev)[cp].int(),
      geom2=ix(m.pair_geom2, dev)[cp].int(),
      cand=torch.where(valid, sel, -1).int())
  overflow = d.overflow | torch.where(
      over, int(types.OverflowType.CONTACT), 0).to(torch.int32)
  return d.replace(contact=contact, ncon_active=ncon_active,
                   overflow=overflow)
