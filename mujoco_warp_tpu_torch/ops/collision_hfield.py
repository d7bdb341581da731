"""Height-field narrowphase of the general step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/collision_hfield.py``: the surface
is evaluated exactly per triangle (``_surface`` :37), each grid cell split
along its (c+1, r)-(c, r+1) diagonal as the collision prisms are, at a
fixed set of sample points of the other geom (a sphere's or an
ellipsoid's center, three points on a capsule's or a cylinder's axis, a
box's eight corners), each against the plane of the triangle below it
with the geom's support radius along that plane's normal
(``_point_contacts`` :81); a box keeps its four deepest corners
(``make_hfield_collider`` :95).  Where the JAX collider loops over the
pairs of a group in Python, the port takes every pair of the group that
shares one height-field geom at once, (W, k, npair), as the other
colliders do.  Height field against a mesh waits for the mesh slice:
``HFIELD_NCON`` has no MESH entry, so ``io.put_model`` refuses that pair.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import math
from mujoco_warp_tpu_torch.ops.util import fmask, ix

_GT = types.GeomType
_BIG = 1e10

# contact points per (HFIELD, other) pair (``collision_hfield.py:25-32``)
HFIELD_NCON = {
    int(_GT.SPHERE): 1,
    int(_GT.ELLIPSOID): 1,
    int(_GT.CAPSULE): 3,
    int(_GT.CYLINDER): 3,
    int(_GT.BOX): 4,
}

_CORNERS = np.asarray([[i, j, k] for i in (-1, 1) for j in (-1, 1)
                       for k in (-1, 1)], np.float32)


def heights(m: types.Model, dataid: int) -> torch.Tensor:
  """The height field's surface heights (1 or W, nrow * ncol), row-major,
  each world's where its data or size is batched: its data times its
  size's z (``collision_hfield.py:48``)."""
  nrow, ncol = int(m.hfield_nrow[dataid]), int(m.hfield_ncol[dataid])
  adr = int(m.hfield_adr[dataid])
  return types.world_field(m, 'hfield_data')[:, adr:adr + nrow * ncol] * \
      types.world_field(m, 'hfield_size')[:, dataid, 2:3]


def take(table, idx):
  """``table`` (1 or W, n) at the indices ``idx`` (W, ...): one row for
  every world, or each world's own row."""
  return torch.gather(table.expand(idx.shape[0], -1), 1,
                      idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def surface(m: types.Model, dataid: int, xy: torch.Tensor):
  """Height, unit outward normal and the inside mask at points ``xy``
  (..., 2) of the height field's frame (``collision_hfield.py:37``).

  A point's cell is (r, c) with c = floor of its grid x, held to [0, ncol
  - 2] (the JAX package clips the grid coordinate below ncol - 1; the
  port holds the cell index instead, so that no gather leaves the data
  and an edge point reads its own cell); the lower triangle (u + v <= 1)
  holds z00, z01 and z10, the upper z11, z10 and z01."""
  nrow, ncol = int(m.hfield_nrow[dataid]), int(m.hfield_ncol[dataid])
  # (1 or W, 1, ..., 4): each world's size where it is batched
  size = types.world_field(m, 'hfield_size')[:, dataid].to(
      xy.dtype).reshape((-1,) + (1,) * (xy.dim() - 2) + (4,))
  size = [size[..., i] for i in range(4)]
  data = heights(m, dataid).to(xy.dtype)
  gx = torch.clamp((xy[..., 0] / size[0] + 1.0) * 0.5 * (ncol - 1), 0.0,
                   ncol - 1 - 1e-6)
  gy = torch.clamp((xy[..., 1] / size[1] + 1.0) * 0.5 * (nrow - 1), 0.0,
                   nrow - 1 - 1e-6)
  c = torch.clamp(torch.floor(gx), max=ncol - 2)
  r = torch.clamp(torch.floor(gy), max=nrow - 2)
  u, v = gx - c, gy - r
  base = r.long() * ncol + c.long()
  z00, z01 = take(data, base), take(data, base + 1)
  z10, z11 = take(data, base + ncol), take(data, base + ncol + 1)
  dx = 2.0 * size[0] / (ncol - 1)
  dy = 2.0 * size[1] / (nrow - 1)
  lower = (u + v) <= 1.0
  h_lo = z00 + u * (z01 - z00) + v * (z10 - z00)
  h_hi = z11 + (1.0 - u) * (z10 - z11) + (1.0 - v) * (z01 - z11)
  h = torch.where(lower, h_lo, h_hi)
  sx = torch.where(lower, z01 - z00, z11 - z10) / dx
  sy = torch.where(lower, z10 - z00, z11 - z01) / dy
  nrm = torch.stack([-sx, -sy, torch.ones_like(sx)], -1)
  nrm = nrm / math.norm(nrm, keepdim=True)
  inside = (torch.abs(xy[..., 0]) <= size[0]) & \
      (torch.abs(xy[..., 1]) <= size[1])
  return h, nrm, inside


def point_contacts(m: types.Model, dataid: int, pts, r_eff):
  """Contacts of sample points ``pts`` (..., 3) of the height field's
  frame with support radii ``r_eff`` (...) against its surface
  (``collision_hfield.py:81``): dist along the triangle's normal less the
  radius (1e10 outside the field), the midpoint and the normal, in the
  field's frame."""
  h, nrm, inside = surface(m, dataid, pts[..., :2])
  dist = nrm[..., 2] * (pts[..., 2] - h) - r_eff
  dist = torch.where(inside, dist, torch.full_like(dist, _BIG))
  pos = pts - nrm * (r_eff + 0.5 * dist)[..., None]
  return dist, pos, nrm


def _pair_points(m: types.Model, dataid: int, t2: int, p, R, s):
  """Sample points (W, n, k, 3) and support radii (W, n, k) of the
  geoms of type ``t2`` at p (W, n, 3), R (W, n, 3, 3) and sizes s (n, 3),
  in the height field's frame (``collision_hfield.py:117-154``)."""
  if t2 == _GT.SPHERE:
    return p[:, :, None], s[:, 0].expand(p.shape[:2])[..., None]
  if t2 == _GT.ELLIPSOID:
    _, nrm0, _ = surface(m, dataid, p[..., :2])
    ng = torch.einsum('wnji,wnj->wni', R, nrm0)
    return p[:, :, None], torch.sqrt(torch.sum((s * ng) ** 2, -1))[..., None]
  if t2 in (_GT.CAPSULE, _GT.CYLINDER):
    az = R[..., 2] * s[:, 1, None]
    pts = torch.stack([p - az, p, p + az], 2)
    if t2 == _GT.CAPSULE:
      return pts, s[:, 0, None].expand(pts.shape[:3])
    _, nrm0, _ = surface(m, dataid, pts[..., :2])
    ng = torch.einsum('wnji,wnkj->wnki', R, nrm0)
    radial = s[:, 0, None] * math.norm(ng[..., :2])
    # the middle point also takes the half length along the axis; the
    # ends do not
    mid = radial[..., 1] + s[:, 1] * torch.abs(ng[..., 1, 2])
    return pts, torch.stack([radial[..., 0], mid, radial[..., 2]], -1)
  if t2 == _GT.BOX:
    corners = fmask(_CORNERS, p)[None, None] * s[None, :, None]
    pts = p[:, :, None] + torch.einsum('wnij,wnkj->wnki', R, corners)
    return pts, torch.zeros(pts.shape[:3], dtype=p.dtype, device=p.device)
  raise NotImplementedError(f'height field against {_GT(t2).name}')


def make_hfield_collider(t2: int):
  """The collider of the (HFIELD, t2) group, with the (m, d, g1, g2)
  signature of ``collision_driver``'s colliders, g1 the height-field
  geoms: dist (W, k, n), pos (W, k, n, 3) and normal (W, k, n, 3) in the
  world frame, k = HFIELD_NCON[t2], the normal pointing out of the field
  into the geom."""
  t2 = int(t2)
  if t2 not in HFIELD_NCON:
    raise NotImplementedError(
        f'collision pair (HFIELD, {_GT(t2).name}) has no collider in the '
        'general step')
  k = HFIELD_NCON[t2]

  def collider(m: types.Model, d: types.Data, g1, g2):
    dev = d.geom_xpos.device
    W, n = d.geom_xpos.shape[0], len(g1)
    dist = torch.empty((W, k, n), dtype=d.geom_xpos.dtype, device=dev)
    pos = dist.new_empty((W, k, n, 3))
    nrm = dist.new_empty((W, k, n, 3))
    g1 = np.asarray(g1)
    # the pairs of each height-field geom at once
    for hf in np.unique(g1):
      sel = np.nonzero(g1 == hf)[0]
      ge = ix(np.asarray(g2)[sel], dev)
      dataid = int(m.geom_dataid[int(hf)])
      hp, hm = d.geom_xpos[:, int(hf)], d.geom_xmat[:, int(hf)]
      p = torch.einsum('wji,wnj->wni', hm, d.geom_xpos[:, ge] - hp[:, None])
      R = torch.einsum('wji,wnjk->wnik', hm, d.geom_xmat[:, ge])
      pts, r_eff = _pair_points(m, dataid, t2, p, R, m.geom_size[ge])
      dd, pp, nn = point_contacts(m, dataid, pts, r_eff)
      if t2 == _GT.BOX:
        # the four deepest corners, ties to the lower corner
        order = torch.sort(dd, dim=-1, stable=True).indices[..., :4]
        dd = torch.gather(dd, -1, order)
        pp = torch.gather(pp, 2, order[..., None].expand(order.shape + (3,)))
        nn = torch.gather(nn, 2, order[..., None].expand(order.shape + (3,)))
      si = ix(sel, dev)
      dist[:, :, si] = dd.transpose(1, 2)
      pos[:, :, si] = (hp[:, None, None] + torch.einsum(
          'wij,wnkj->wnki', hm, pp)).transpose(1, 2)
      nrm[:, :, si] = torch.einsum('wij,wnkj->wnki', hm, nn).transpose(1, 2)
    return dist, pos, nrm

  return collider
