"""Analytic primitive colliders of the general step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/collision_primitive.py``: the
eleven colliders ``plane_sphere`` (:54), ``plane_capsule`` (:72),
``plane_ellipsoid`` (:99), ``plane_cylinder`` (:114), ``plane_box``
(:146), ``sphere_sphere`` (:170), ``sphere_capsule`` (:193),
``sphere_cylinder`` (:202), ``sphere_box`` (:230), ``capsule_capsule``
(:278) and ``capsule_box`` (:287).  Sphere-ellipsoid has its point count
here but no collider, as in JAX: it runs MPR.  Each takes static geom id arrays ``g1``, ``g2`` (n,) of one pair
group and returns ``(dist, pos, normal[, frame])`` of shapes (W, k, n),
(W, k, n, 3), (W, k, n, 3)[, (W, k, n, 3, 3)], k the group's contact
points per pair.  Normals point from geom1 into geom2.  These are not the
fused step's lane colliders (``fused/k1_ref.py``), which follow K1.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import math
from mujoco_warp_tpu_torch.ops.util import fmask, ix

_GT = types.GeomType

# contact points per pair of each (geomtype1, geomtype2) collider
PAIR_NCON = {
    (_GT.PLANE, _GT.SPHERE): 1,
    (_GT.PLANE, _GT.CAPSULE): 2,
    (_GT.PLANE, _GT.ELLIPSOID): 1,
    (_GT.PLANE, _GT.CYLINDER): 3,
    (_GT.PLANE, _GT.BOX): 4,
    (_GT.SPHERE, _GT.SPHERE): 1,
    (_GT.SPHERE, _GT.CAPSULE): 1,
    (_GT.SPHERE, _GT.BOX): 1,
    (_GT.SPHERE, _GT.ELLIPSOID): 1,
    (_GT.SPHERE, _GT.CYLINDER): 1,
    (_GT.CAPSULE, _GT.CAPSULE): 1,
    (_GT.CAPSULE, _GT.BOX): 2,
}


def _geom(m, d, g):
  """Pose (W, n, 3), (W, n, 3, 3) and size (n, 3) of static geom ids."""
  t = ix(g, d.geom_xpos.device)
  return d.geom_xpos[:, t], d.geom_xmat[:, t], m.geom_size[t]


def _clip(x, lo, hi):
  """``jnp.clip``: min(max(x, lo), hi), tensor bounds allowed."""
  lo = lo if isinstance(lo, torch.Tensor) else torch.full_like(x, lo)
  hi = hi if isinstance(hi, torch.Tensor) else torch.full_like(x, hi)
  return torch.minimum(torch.maximum(x, lo), hi)


def _lowest(x, k):
  """The k smallest of x along dim 1 and their indices, ties to the lower
  index (``lax.top_k`` of -x)."""
  vals, idx = torch.sort(x, dim=1, stable=True)
  return vals[:, :k], idx[:, :k]


def _take(x, idx):
  """x gathered along dim 1 at idx, which has x's leading dims (the
  trailing dims of x ride along)."""
  extra = x.dim() - idx.dim()
  shape = idx.shape + x.shape[idx.dim():]
  return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * extra)
                      .expand(shape))


def plane_sphere(m, d, g1, g2):
  p_pos, p_mat, _ = _geom(m, d, g1)
  s_pos, _, s_size = _geom(m, d, g2)
  n = p_mat[..., 2]
  dist, pos = _plane_sphere_point(n, p_pos, s_pos, s_size[:, 0])
  return dist[:, None], pos[:, None], n[:, None]


def _plane_sphere_point(n, p_pos, center, r):
  h = math.dot(n, center - p_pos)
  dist = h - r
  pos = center - n * (r + 0.5 * dist)[..., None]
  return dist, pos


def plane_capsule(m, d, g1, g2):
  p_pos, p_mat, _ = _geom(m, d, g1)
  c_pos, c_mat, c_size = _geom(m, d, g2)
  n = p_mat[..., 2]
  axis = c_mat[..., 2]
  r, half = c_size[:, 0], c_size[:, 1]
  seg = axis * half[:, None]
  d1, p1 = _plane_sphere_point(n, p_pos, c_pos + seg, r)
  d2, p2 = _plane_sphere_point(n, p_pos, c_pos - seg, r)
  # frame tangent along the capsule axis (collision_primitive.py:84-95)
  b = axis - n * math.dot(n, axis, keepdim=True)
  b_norm = math.norm(b, keepdim=True)
  fallback = torch.where(torch.abs(n[..., 1:2]) < 0.5,
                         fmask([0.0, 1.0, 0.0], n), fmask([0.0, 0.0, 1.0], n))
  b = torch.where(b_norm < 0.5, fallback, b / torch.clamp(b_norm, min=1e-12))
  frame = torch.stack([n, b, math.cross(n, b)], dim=-2)
  return (torch.stack([d1, d2], 1), torch.stack([p1, p2], 1),
          torch.stack([n, n], 1), torch.stack([frame, frame], 1))


def plane_ellipsoid(m, d, g1, g2):
  """The ellipsoid's support point along -n."""
  p_pos, p_mat, _ = _geom(m, d, g1)
  e_pos, e_mat, e_size = _geom(m, d, g2)
  n = p_mat[..., 2]
  nl = torch.einsum('wnij,wni->wnj', e_mat, n)  # n in the ellipsoid frame
  v = -(e_size ** 2) * nl
  nrm = torch.sqrt(torch.sum(nl * nl * e_size * e_size, dim=-1))
  v = v / torch.clamp(nrm, min=1e-12)[..., None]
  sp = e_pos + torch.einsum('wnij,wnj->wni', e_mat, v)
  dist = math.dot(n, sp - p_pos)
  pos = sp - 0.5 * dist[..., None] * n
  return dist[:, None], pos[:, None], n[:, None]


def plane_cylinder(m, d, g1, g2):
  """Three rim points of the lower cap: the deepest, and two at +-120
  degrees from it."""
  p_pos, p_mat, _ = _geom(m, d, g1)
  c_pos, c_mat, c_size = _geom(m, d, g2)
  n = p_mat[..., 2]
  axis = c_mat[..., 2]
  r, half = c_size[:, 0], c_size[:, 1]
  a_n = math.dot(axis, n)
  sgn = -torch.sign(torch.where(torch.abs(a_n) < 1e-12,
                                torch.ones_like(a_n), a_n))
  cap = c_pos + axis * (half * sgn)[..., None]
  radial = n - axis * a_n[..., None]
  rn = math.norm(radial, keepdim=True)
  # the axis along the normal: any radial direction
  radial = torch.where(rn > 1e-8, radial / torch.clamp(rn, min=1e-12),
                       math.orthogonals(axis)[0])
  rim = cap - radial * r[:, None]
  zero = torch.zeros_like(a_n)
  d0, p0 = _plane_sphere_point(n, p_pos, rim, zero)
  t = math.cross(axis, radial)
  back = cap - radial * (0.5 * r)[:, None]
  side = t * (0.866 * r)[:, None]
  d1, p1 = _plane_sphere_point(n, p_pos, back + side, zero)
  d2, p2 = _plane_sphere_point(n, p_pos, back - side, zero)
  return (torch.stack([d0, d1, d2], 1), torch.stack([p0, p1, p2], 1),
          torch.stack([n, n, n], 1))


_CORNERS = np.asarray([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                       for sz in (-1, 1)], np.float32)


def plane_box(m, d, g1, g2):
  p_pos, p_mat, _ = _geom(m, d, g1)
  b_pos, b_mat, b_size = _geom(m, d, g2)
  n = p_mat[..., 2]
  local = fmask(_CORNERS, b_size)[None] * b_size[:, None, :]  # (n, 8, 3)
  corners = b_pos[:, :, None, :] + torch.einsum('wnij,nkj->wnki', b_mat,
                                                local)
  hgt = math.dot(n[:, :, None, :], corners - p_pos[:, :, None, :])  # (W, n, 8)
  W, npair = hgt.shape[:2]
  dist4, idx = _lowest(hgt.reshape(W * npair, 8), 4)
  corner4 = _take(corners.reshape(W * npair, 8, 3), idx).reshape(
      W, npair, 4, 3)
  dist4 = dist4.reshape(W, npair, 4)
  pos4 = corner4 - 0.5 * dist4[..., None] * n[:, :, None, :]
  return (dist4.transpose(1, 2), pos4.transpose(1, 2),
          n[:, None].expand(W, 4, npair, 3))


def _sphere_sphere_point(p1, r1, p2, r2):
  vec = p2 - p1
  ln = math.safe_norm(vec)
  n = vec / torch.clamp(ln, min=1e-12)[..., None]
  dist = ln - r1 - r2
  pos = p1 + n * (r1 + 0.5 * dist)[..., None]
  return dist[:, None], pos[:, None], n[:, None]


def sphere_sphere(m, d, g1, g2):
  p1, _, s1 = _geom(m, d, g1)
  p2, _, s2 = _geom(m, d, g2)
  return _sphere_sphere_point(p1, s1[:, 0], p2, s2[:, 0])


def _closest_segment_point(a, b, p):
  ab = b - a
  t = math.dot(p - a, ab) / torch.clamp(math.dot(ab, ab), min=1e-12)
  return a + ab * _clip(t, 0.0, 1.0)[..., None]


def sphere_capsule(m, d, g1, g2):
  s_pos, _, s_size = _geom(m, d, g1)
  c_pos, c_mat, c_size = _geom(m, d, g2)
  seg = c_mat[..., 2] * c_size[:, 1:2]
  pt = _closest_segment_point(c_pos - seg, c_pos + seg, s_pos)
  return _sphere_sphere_point(s_pos, s_size[:, 0], pt, c_size[:, 0])


def sphere_cylinder(m, d, g1, g2):
  """The point of the solid cylinder nearest the sphere's center; a
  center inside goes to the nearer of the side wall and the cap."""
  s_pos, _, s_size = _geom(m, d, g1)
  c_pos, c_mat, c_size = _geom(m, d, g2)
  r_cyl, half = c_size[:, 0], c_size[:, 1]
  rel = torch.einsum('wnij,wni->wnj', c_mat, s_pos - c_pos)
  x, y, z = rel.unbind(-1)
  rad = torch.sqrt(x * x + y * y + 1e-24)
  scale = torch.minimum(rad, r_cyl.expand(rad.shape)) / rad
  closest = torch.stack([x * scale, y * scale, _clip(z, -half, half)], -1)
  inside = (rad < r_cyl) & (torch.abs(z) < half)
  side_pt = torch.stack([x * r_cyl / rad, y * r_cyl / rad, z], -1)
  cap_pt = torch.stack([x, y, torch.sign(z) * half], -1)
  closest_in = torch.where((r_cyl - rad < half - torch.abs(z))[..., None],
                           side_pt, cap_pt)
  closest = torch.where(inside[..., None], closest_in, closest)
  cw = c_pos + torch.einsum('wnij,wnj->wni', c_mat, closest)
  return _sphere_sphere_point(s_pos, s_size[:, 0], cw, torch.zeros_like(
      r_cyl))


def sphere_box(m, d, g1, g2):
  s_pos, _, s_size = _geom(m, d, g1)
  b_pos, b_mat, b_size = _geom(m, d, g2)
  r = s_size[:, 0]
  rel = torch.einsum('wnij,wni->wnj', b_mat, s_pos - b_pos)
  size = b_size.expand(rel.shape)
  clamped = _clip(rel, -size, size)
  inside = torch.all(torch.abs(rel) < size, dim=-1)
  # inside: push to the nearest face
  k = torch.argmin(size - torch.abs(rel), dim=-1, keepdim=True)
  sign = torch.sign(torch.gather(rel, -1, k))[..., 0]
  sign = torch.where(sign == 0, torch.ones_like(sign), sign)
  face_val = sign * torch.gather(size, -1, k)[..., 0]
  onehot = torch.arange(3, device=rel.device) == k
  pushed = torch.where(onehot, face_val[..., None], clamped)
  local = torch.where(inside[..., None], pushed, clamped)
  closest = b_pos + torch.einsum('wnij,wnj->wni', b_mat, local)
  vec = closest - s_pos
  ln = math.safe_norm(vec)
  n = vec / torch.clamp(ln, min=1e-12)[..., None]
  dist = torch.where(inside, -(ln + torch.abs(r)), ln - r)
  # inside: the normal points from the sphere deeper into the box
  n = torch.where(inside[..., None], -n, n)
  pos = s_pos + n * (r + 0.5 * dist)[..., None]
  return dist[:, None], pos[:, None], n[:, None]


def _closest_segment_segment(a0, a1, b0, b1):
  da, db, r = a1 - a0, b1 - b0, a0 - b0
  A, B, C = math.dot(da, da), math.dot(da, db), math.dot(db, db)
  D, E = math.dot(da, r), math.dot(db, r)
  denom = A * C - B * B
  s = torch.where(denom > 1e-12,
                  (B * E - C * D) / torch.clamp(denom, min=1e-12),
                  torch.zeros_like(denom))
  s = _clip(s, 0.0, 1.0)
  t = _clip((B * s + E) / torch.clamp(C, min=1e-12), 0.0, 1.0)
  s2 = _clip((B * t - D) / torch.clamp(A, min=1e-12), 0.0, 1.0)
  return a0 + da * s2[..., None], b0 + db * t[..., None]


def capsule_capsule(m, d, g1, g2):
  p1, m1, s1 = _geom(m, d, g1)
  p2, m2, s2 = _geom(m, d, g2)
  ax1 = m1[..., 2] * s1[:, 1:2]
  ax2 = m2[..., 2] * s2[:, 1:2]
  pa, pb = _closest_segment_segment(p1 - ax1, p1 + ax1, p2 - ax2, p2 + ax2)
  return _sphere_sphere_point(pa, s1[:, 0], pb, s2[:, 0])


def capsule_box(m, d, g1, g2):
  """Sphere-box probes at both segment ends and at the segment point
  closest to the box center; the deepest two of the three."""
  c_pos, c_mat, c_size = _geom(m, d, g1)
  b_pos, b_mat, b_size = _geom(m, d, g2)
  seg = c_mat[..., 2] * c_size[:, 1:2]
  r = c_size[:, 0]
  size = b_size.expand(c_pos.shape)
  e0, e1 = c_pos - seg, c_pos + seg
  mid = _closest_segment_point(e0, e1, b_pos)
  dists, poss, nrms = [], [], []
  for center in (e0, e1, mid):
    rel = torch.einsum('wnij,wni->wnj', b_mat, center - b_pos)
    closest = b_pos + torch.einsum('wnij,wnj->wni', b_mat,
                                   _clip(rel, -size, size))
    vec = closest - center
    ln = math.safe_norm(vec)
    n = vec / torch.clamp(ln, min=1e-12)[..., None]
    dist = ln - r
    dists.append(dist)
    poss.append(center + n * (r + 0.5 * dist)[..., None])
    nrms.append(n)
  dist = torch.stack(dists, 1)  # (W, 3, n)
  dist2, idx = _lowest(dist, 2)
  pos2 = _take(torch.stack(poss, 1), idx)
  nrm2 = _take(torch.stack(nrms, 1), idx)
  return dist2, pos2, nrm2


COLLIDERS = {
    (_GT.PLANE, _GT.SPHERE): plane_sphere,
    (_GT.PLANE, _GT.CAPSULE): plane_capsule,
    (_GT.PLANE, _GT.ELLIPSOID): plane_ellipsoid,
    (_GT.PLANE, _GT.CYLINDER): plane_cylinder,
    (_GT.PLANE, _GT.BOX): plane_box,
    (_GT.SPHERE, _GT.SPHERE): sphere_sphere,
    (_GT.SPHERE, _GT.CAPSULE): sphere_capsule,
    (_GT.SPHERE, _GT.CYLINDER): sphere_cylinder,
    (_GT.SPHERE, _GT.BOX): sphere_box,
    (_GT.CAPSULE, _GT.CAPSULE): capsule_capsule,
    (_GT.CAPSULE, _GT.BOX): capsule_box,
}
