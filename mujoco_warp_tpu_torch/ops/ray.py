"""Ray casting against geoms, world-major.

Counterpart of ``mujoco_warp_tpu/ops/ray.py``: the analytic casts
``_to_local`` (:27), ``_quadratic`` (:50) and ``_ray_plane`` / ``sphere``
/ ``capsule`` / ``ellipsoid`` / ``cylinder`` / ``box`` (:36-131), each
over (W, R) rays against every geom of its type at once; the triangle
test ``_ray_triangles`` (:134) on a height field's surface triangles
(``_hfield_tris`` :156), and ``rays`` / ``ray`` (:185, :272): the nearest
hit of each ray and its geom, -1 where nothing is hit, with
``bodyexclude`` and ``flg_static``.

A height field is cast by a walk over its cells where the JAX package
walks a BVH of its triangles (``bvh.py:68`` ``build_tri_bvh``, :153
``ray_mesh_bvh``): each ray's parameter range inside the field's box
(its x and y extent, z between its lowest and highest height) gives its
first and last cell, and every trip tests the two triangles of each
ray's current cell and steps to the neighbour cell the ray enters next
(a 2D DDA), until the ray hits, leaves the box or runs out of cells.
Cells come in the order of the ray's parameter, so the first cell with a
hit holds the nearest hit: the walk is exact, at most ``nrow + ncol - 3``
trips for any ray; a cast takes as many trips as the most cells any of
its rays crosses (one host read), and every ``EXIT_EVERY`` trips one
more host read ends the walk once every ray is done.  Each cell is split
along its (r, c)-(r+1, c+1) diagonal, as mj_ray splits it, the opposite
of the collision prisms' split (``collision_hfield.surface``).  Meshes
wait for the mesh slice and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import collision_hfield, math
from mujoco_warp_tpu_torch.ops.util import bmask, host_item, ix

_GT = types.GeomType
_INF = float('inf')

# trips the height-field walks have taken (``hfield_walk``), and walks
trips = 0
walks = 0
# trips between the walk's reads of whether every ray is done
EXIT_EVERY = 8


def _to_local(pnt, vec, pos, mat):
  """Rays pnt, vec (W, R, 3) in the frames of geoms at pos (W, G, 3),
  mat (W, G, 3, 3): (W, R, G, 3) each."""
  rel = pnt[:, :, None] - pos[:, None]
  lp = torch.einsum('wgij,wrgi->wrgj', mat, rel)
  lv = torch.einsum('wgij,wri->wrgj', mat, vec)
  return lp, lv


def _safe(x, eps):
  """x where |x| > eps, else eps (the JAX package's guard)."""
  return torch.where(torch.abs(x) > eps, x, torch.full_like(x, eps))


def _inf_where(ok, t):
  return torch.where(ok, t, torch.full_like(t, _INF))


def _ray_plane(lp, lv, size):
  """The z = 0 plane, bounded by size[0] and size[1] where they are
  positive (``ray.py:36``)."""
  t = -lp[..., 2] / _safe(lv[..., 2], 1e-15)
  px = lp[..., 0] + t * lv[..., 0]
  py = lp[..., 1] + t * lv[..., 1]
  ok = (t >= 0) & (torch.abs(lv[..., 2]) > 1e-15)
  ok = ok & ((size[..., 0] <= 0) | (torch.abs(px) <= size[..., 0]))
  ok = ok & ((size[..., 1] <= 0) | (torch.abs(py) <= size[..., 1]))
  return _inf_where(ok, t)


def _quadratic(a, b, c):
  """The smallest non-negative root of a t^2 + 2 b t + c, else inf
  (``ray.py:50``)."""
  det = b * b - a * c
  sq = torch.sqrt(torch.clamp(det, min=0.0))
  a_s = _safe(a, 1e-15)
  t0 = (-b - sq) / a_s
  t1 = (-b + sq) / a_s
  t = torch.where(t0 >= 0, t0, _inf_where(t1 >= 0, t1))
  return _inf_where(det >= 0, t)


def _ray_sphere(lp, lv, r):
  return _quadratic(torch.sum(lv * lv, -1), torch.sum(lp * lv, -1),
                    torch.sum(lp * lp, -1) - r * r)


def _ray_capsule(lp, lv, r, half):
  """The side where |z| <= half, and the two caps beyond it
  (``ray.py:69``)."""
  a = lv[..., 0] ** 2 + lv[..., 1] ** 2
  b = lp[..., 0] * lv[..., 0] + lp[..., 1] * lv[..., 1]
  c = lp[..., 0] ** 2 + lp[..., 1] ** 2 - r * r
  t = _quadratic(a, b, c)
  t = _inf_where(torch.abs(lp[..., 2] + t * lv[..., 2]) <= half, t)
  a2 = torch.sum(lv * lv, -1)
  for sign in (1.0, -1.0):
    capc = torch.stack([lp[..., 0], lp[..., 1], lp[..., 2] - sign * half],
                       -1)
    t_cap = _quadratic(a2, torch.sum(capc * lv, -1),
                       torch.sum(capc * capc, -1) - r * r)
    zc = lp[..., 2] + t_cap * lv[..., 2]
    valid = zc > half if sign > 0 else zc < -half
    t = torch.minimum(t, _inf_where(valid, t_cap))
  return t


def _ray_ellipsoid(lp, lv, size):
  inv = 1.0 / torch.clamp(size, min=1e-15)
  p, v = lp * inv, lv * inv
  return _quadratic(torch.sum(v * v, -1), torch.sum(p * v, -1),
                    torch.sum(p * p, -1) - 1.0)


def _ray_cylinder(lp, lv, r, half):
  """The side where |z| <= half, and the two end disks
  (``ray.py:100``)."""
  a = lv[..., 0] ** 2 + lv[..., 1] ** 2
  b = lp[..., 0] * lv[..., 0] + lp[..., 1] * lv[..., 1]
  c = lp[..., 0] ** 2 + lp[..., 1] ** 2 - r * r
  t = _quadratic(a, b, c)
  t = _inf_where(torch.abs(lp[..., 2] + t * lv[..., 2]) <= half, t)
  vz = _safe(lv[..., 2], 1e-15)
  for sign in (1.0, -1.0):
    t_cap = (sign * half - lp[..., 2]) / vz
    x = lp[..., 0] + t_cap * lv[..., 0]
    y = lp[..., 1] + t_cap * lv[..., 1]
    ok = (t_cap >= 0) & (x * x + y * y <= r * r)
    t = torch.minimum(t, _inf_where(ok, t_cap))
  return t


def _ray_box(lp, lv, size):
  """The six faces (``ray.py:119``)."""
  t_best = torch.full(lp.shape[:-1], _INF, dtype=lp.dtype, device=lp.device)
  for axis in range(3):
    o1, o2 = (axis + 1) % 3, (axis + 2) % 3
    va = _safe(lv[..., axis], 1e-15)
    for sign in (1.0, -1.0):
      t = (sign * size[..., axis] - lp[..., axis]) / va
      p1 = lp[..., o1] + t * lv[..., o1]
      p2 = lp[..., o2] + t * lv[..., o2]
      ok = (t >= 0) & (torch.abs(p1) <= size[..., o1]) & \
          (torch.abs(p2) <= size[..., o2])
      t_best = torch.minimum(t_best, _inf_where(ok, t))
  return t_best


def ray_triangle(lp, lv, v0, v1, v2):
  """The hit parameter of rays lp, lv (..., 3) on triangles v0, v1, v2
  (..., 3) by Moller-Trumbore, inf where they miss
  (``ray.py:134``)."""
  e1, e2 = v1 - v0, v2 - v0
  h = math.cross(lv, e2)
  a = torch.sum(e1 * h, -1)
  f = 1.0 / _safe(a, 1e-12)
  s = lp - v0
  u = f * torch.sum(s * h, -1)
  q = math.cross(s, e1)
  v = f * torch.sum(lv * q, -1)
  t = f * torch.sum(e2 * q, -1)
  ok = (torch.abs(a) > 1e-12) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & \
      (u + v <= 1.0) & (t >= 0.0)
  return _inf_where(ok, t)


def _slab(p, v, lo, hi):
  """The parameter range [t0, t1] of rays p + t v (N, 3), t >= 0, inside
  the box [lo, hi] (3 bounds each, a float or one per ray (N,)), and
  whether it is not empty."""
  t0 = torch.zeros_like(p[:, 0])
  t1 = torch.full_like(p[:, 0], _INF)
  live = torch.ones_like(t0, dtype=torch.bool)
  for a in range(3):
    flat = torch.abs(v[:, a]) < 1e-15
    live = live & ~(flat & ((p[:, a] < lo[a]) | (p[:, a] > hi[a])))
    va = _safe(v[:, a], 1e-15)
    ta, tb = (lo[a] - p[:, a]) / va, (hi[a] - p[:, a]) / va
    t0 = torch.where(flat, t0, torch.maximum(t0, torch.minimum(ta, tb)))
    t1 = torch.where(flat, t1, torch.minimum(t1, torch.maximum(ta, tb)))
  return t0, t1, live & (t0 <= t1)


def hfield_walk(m: types.Model, dataid: int, lp, lv) -> torch.Tensor:
  """The nearest hit parameter of rays lp, lv (..., 3) of the height
  field's frame on its surface, inf where they miss: the cell walk of
  the module's docstring over the triangles (c, r), (c+1, r), (c+1, r+1)
  and (c, r), (c+1, r+1), (c, r+1) of each cell (``_hfield_tris``
  :156-183)."""
  global trips, walks
  shape = lp.shape[:-1]
  p, v = lp.reshape(-1, 3), lv.reshape(-1, 3)
  dt, dev = p.dtype, p.device
  nrow, ncol = int(m.hfield_nrow[dataid]), int(m.hfield_ncol[dataid])
  # the field's size and heights: one row, or each world's where batched
  hs = types.world_field(m, 'hfield_size')[:, dataid]  # (1 or W, 4)
  z = collision_hfield.heights(m, dataid).to(dt)
  xs = torch.linspace(-1.0, 1.0, ncol, dtype=dt, device=dev) * \
      hs[:, 0:1].to(dt)
  ys = torch.linspace(-1.0, 1.0, nrow, dtype=dt, device=dev) * \
      hs[:, 1:2].to(dt)
  # each ray its world's size and height bounds (one world's, as every
  # world shares them, where they are not batched)
  hs64 = types.host(hs, np.float64)
  sx, sy = hs64[:, 0], hs64[:, 1]
  dx, dy = 2.0 * sx / (ncol - 1), 2.0 * sy / (nrow - 1)
  per_world = p.shape[0] // max(shape[0], 1)
  ray_of = lambda x: torch.as_tensor(x, dtype=dt, device=dev).expand(
      shape[0]).repeat_interleave(per_world)
  lo = (ray_of(-sx), ray_of(-sy), ray_of(z.amin(1)))
  hi = (ray_of(sx), ray_of(sy), ray_of(z.amax(1)))
  t0, t1, live = _slab(p, v, lo, hi)
  sx, sy, dx, dy = ray_of(sx), ray_of(sy), ray_of(dx), ray_of(dy)
  grid = lambda tab, i: collision_hfield.take(
      tab, i.reshape(shape)).reshape(i.shape)

  def cell(t):
    q = p + torch.where(live, t, torch.zeros_like(t))[:, None] * v
    c = torch.clamp(torch.floor((q[:, 0] + sx) / dx), 0, ncol - 2)
    r = torch.clamp(torch.floor((q[:, 1] + sy) / dy), 0, nrow - 2)
    return c.long(), r.long()

  c, r = cell(t0)
  ce, re = cell(t1)
  n_cells = (torch.abs(ce - c) + torch.abs(re - r) + 1) * live
  ntrip = int(host_item(n_cells.max(), 'ray')) if p.shape[0] else 0
  sc = torch.sign(v[:, 0]).long()
  sr = torch.sign(v[:, 1]).long()
  flat_x = torch.abs(v[:, 0]) < 1e-15
  flat_y = torch.abs(v[:, 1]) < 1e-15
  vx, vy = _safe(v[:, 0], 1e-15), _safe(v[:, 1], 1e-15)
  # the parameter at which each ray crosses into the next column / row
  tmc = torch.where(flat_x, torch.full_like(t0, _INF),
                    (-sx + (c + (sc > 0).long()).to(dt) * dx - p[:, 0]) / vx)
  tmr = torch.where(flat_y, torch.full_like(t0, _INF),
                    (-sy + (r + (sr > 0).long()).to(dt) * dy - p[:, 1]) / vy)
  tdc = torch.where(flat_x, torch.full_like(t0, _INF), dx / torch.abs(vx))
  tdr = torch.where(flat_y, torch.full_like(t0, _INF), dy / torch.abs(vy))
  best = torch.full_like(t0, _INF)
  done = ~live
  walked = 0
  for _ in range(ntrip):
    if walked and walked % EXIT_EVERY == 0 and \
        host_item(done.all(), 'ray'):
      break
    walked += 1
    cc, rr = torch.clamp(c, 0, ncol - 2), torch.clamp(r, 0, nrow - 2)
    i00 = rr * ncol + cc
    x0, x1 = grid(xs, cc), grid(xs, cc + 1)
    y0, y1 = grid(ys, rr), grid(ys, rr + 1)
    v00 = torch.stack([x0, y0, grid(z, i00)], -1)
    v01 = torch.stack([x1, y0, grid(z, i00 + 1)], -1)
    v10 = torch.stack([x0, y1, grid(z, i00 + ncol)], -1)
    v11 = torch.stack([x1, y1, grid(z, i00 + ncol + 1)], -1)
    th = torch.minimum(ray_triangle(p, v, v00, v01, v11),
                       ray_triangle(p, v, v00, v11, v10))
    hit = ~done & torch.isfinite(th)
    best = torch.where(hit, th, best)
    step_c = tmc < tmr
    tnext = torch.minimum(tmc, tmr)
    c = c + torch.where(step_c, sc, 0)
    r = r + torch.where(step_c, 0, sr)
    tmc = torch.where(step_c, tmc + tdc, tmc)
    tmr = torch.where(step_c, tmr, tmr + tdr)
    done = done | hit | (tnext > t1) | (c < 0) | (c > ncol - 2) | \
        (r < 0) | (r > nrow - 2)
  trips += walked
  walks += 1
  return best.reshape(shape)


_PRIMITIVES = {
    int(_GT.PLANE): lambda lp, lv, s: _ray_plane(lp, lv, s),
    int(_GT.SPHERE): lambda lp, lv, s: _ray_sphere(lp, lv, s[..., 0]),
    int(_GT.CAPSULE): lambda lp, lv, s: _ray_capsule(lp, lv, s[..., 0],
                                                    s[..., 1]),
    int(_GT.ELLIPSOID): lambda lp, lv, s: _ray_ellipsoid(lp, lv, s),
    int(_GT.CYLINDER): lambda lp, lv, s: _ray_cylinder(lp, lv, s[..., 0],
                                                      s[..., 1]),
    int(_GT.BOX): lambda lp, lv, s: _ray_box(lp, lv, s),
}


def rays(m: types.Model, d: types.Data, pnt, vec, flg_static: bool = True,
         bodyexclude: int = -1):
  """The nearest hit of rays pnt + t vec, t >= 0, (W, R, 3) each
  (``ray.py:185``): dist (W, R), the parameter t, and geomid (W, R)
  int32, -1 both where no geom is hit.  Geoms of body ``bodyexclude``
  are skipped, and without ``flg_static`` the world body's too."""
  dev, dt = pnt.device, pnt.dtype
  W, R = pnt.shape[:2]
  gt = np.asarray(m.geom_type)
  if np.any(gt == _GT.MESH):
    raise NotImplementedError('ray casts on mesh geoms wait for the mesh '
                              'slice')
  keep = np.ones(m.ngeom, bool)
  if bodyexclude >= 0:
    keep &= np.asarray(m.geom_bodyid) != bodyexclude
  if not flg_static:
    keep &= np.asarray(m.geom_bodyid) != 0
  t_all = torch.full((W, R, m.ngeom), _INF, dtype=dt, device=dev)
  prim = np.nonzero(np.isin(gt, list(_PRIMITIVES)) & keep)[0]
  if len(prim):
    gi = ix(prim, dev)
    lp, lv = _to_local(pnt, vec, d.geom_xpos[:, gi], d.geom_xmat[:, gi])
    size = m.geom_size[gi].to(dt)
    for t in np.unique(gt[prim]):
      k = np.nonzero(gt[prim] == t)[0]
      ki = ix(k, dev)
      t_all[:, :, gi[ki]] = _PRIMITIVES[int(t)](lp[:, :, ki], lv[:, :, ki],
                                                size[ki])
  for g in np.nonzero((gt == _GT.HFIELD) & keep)[0]:
    g = int(g)
    lp, lv = _to_local(pnt, vec, d.geom_xpos[:, g:g + 1],
                       d.geom_xmat[:, g:g + 1])
    t_all[:, :, g] = hfield_walk(m, int(m.geom_dataid[g]), lp[:, :, 0],
                                 lv[:, :, 0])
  t_all = torch.where(bmask(keep, dev), t_all, torch.full_like(t_all, _INF))
  t, gid = torch.min(t_all, -1)
  hit = torch.isfinite(t)
  return (torch.where(hit, t, torch.full_like(t, -1.0)),
          torch.where(hit, gid, torch.full_like(gid, -1)).to(torch.int32))


def ray(m: types.Model, d: types.Data, pnt, vec, **kw):
  """One ray per world, pnt and vec (W, 3) (``ray.py:272``): dist (W,)
  and geomid (W,)."""
  dist, gid = rays(m, d, pnt[:, None], vec[:, None], **kw)
  return dist[:, 0], gid[:, 0]
