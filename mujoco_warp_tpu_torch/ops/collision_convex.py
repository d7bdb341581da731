"""Convex-convex narrowphase by MPR, world-major.

Counterpart of ``mujoco_warp_tpu/ops/collision_convex.py``:
``_support_local`` (:132), ``_make_support`` (:168), ``mpr`` (:187-425),
``convex_ncon`` (:429) and ``_collide`` (:489-518).  MPR runs fixed loops
(16 discover, 30 refine and 22 polish iterations) with masked updates and
no early exit, as the JAX function does; flat-flat pairs then take a
4-point manifold from supports tilted into the four tangent quadrants.
The support functions of the port's types are sphere, capsule,
ellipsoid, cylinder and box; mesh supports wait for the mesh slice
(``put_model`` raises for mesh geoms).
"""

from __future__ import annotations

import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import math
from mujoco_warp_tpu_torch.ops.util import fmask, ix

_GT = types.GeomType
_BIG = 1e10
_EPS = 1e-12

_DISCOVER_ITERS = 16
_REFINE_ITERS = 30
_POLISH_ITERS = 22
_POLISH_SIGMA0 = 0.3
_POLISH_SHRINK = 0.5
_POLISH_GROW = 1.6

CONVEX_TYPES = (int(_GT.SPHERE), int(_GT.CAPSULE), int(_GT.ELLIPSOID),
                int(_GT.CYLINDER), int(_GT.BOX), int(_GT.MESH))
# the convex types whose support the port has
PORTED_TYPES = (int(_GT.SPHERE), int(_GT.CAPSULE), int(_GT.ELLIPSOID),
                int(_GT.CYLINDER), int(_GT.BOX))
_FLAT = (_GT.CYLINDER, _GT.BOX, _GT.MESH)
_CURVED = (_GT.SPHERE, _GT.CAPSULE, _GT.ELLIPSOID)


def convex_ncon(t1: int, t2: int) -> int:
  """Contact points per pair: 4 for two flat-capable types, else 1."""
  return 4 if (t1 in _FLAT and t2 in _FLAT) else 1


def _unit(v):
  return v / torch.clamp(math.norm(v, keepdim=True), min=_EPS)


def _support_local(gtype: int, size, d):
  """Support point of a geom type in its local frame; d (.., 3) need not
  be unit, size (n, 3) broadcasts."""
  dn = _unit(d)
  if gtype == _GT.SPHERE:
    return size[..., 0:1] * dn
  if gtype == _GT.CAPSULE:
    return size[..., 0:1] * dn + torch.cat(
        [torch.zeros_like(dn[..., :2]),
         (size[..., 1:2] * torch.sign(dn[..., 2:3])).expand(dn[..., 2:3].shape)],
        dim=-1)
  if gtype == _GT.ELLIPSOID:
    nrm = torch.sqrt(torch.clamp(torch.sum(dn * size * dn * size, -1,
                                           keepdim=True), min=_EPS))
    return size * size * dn / nrm
  if gtype == _GT.CYLINDER:
    # no radial part along the axis; a zero axial component picks the
    # mid-plane (jnp.sign gives 0), unlike the box
    xy = dn[..., :2]
    xyn = math.norm(xy, keepdim=True)
    radial = torch.where(xyn > 1e-9, xy / torch.clamp(xyn, min=_EPS),
                         torch.zeros_like(xy))
    return torch.cat([size[..., 0:1] * radial,
                      size[..., 1:2] * torch.sign(dn[..., 2:3])], dim=-1)
  if gtype == _GT.BOX:
    # a zero direction component picks the + corner (jnp.sign, then 1)
    s = torch.sign(dn)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return size * s
  raise NotImplementedError(unported(gtype))


def unported(gtype: int) -> str:
  """Why the port has no convex support for ``gtype``."""
  return (f'convex support of geom type {_GT(int(gtype)).name}: mesh '
          'geoms arrive with the mesh slice of the general step '
          '(ROADMAP.md, queue 1)')


def _make_support(t1: int, t2: int):
  """CSO support S(d) = supA(d) - supB(-d), with the witness points."""

  def support(d, pos1, mat1, size1, pos2, mat2, size2, inflate):
    d1 = torch.einsum('...ij,...i->...j', mat1, d)
    d2 = torch.einsum('...ij,...i->...j', mat2, -d)
    a_l = _support_local(t1, size1, d1)
    b_l = _support_local(t2, size2, d2)
    dn = _unit(d)
    a = pos1 + torch.einsum('...ij,...j->...i', mat1, a_l) + inflate * dn
    b = pos2 + torch.einsum('...ij,...j->...i', mat2, b_l) - inflate * dn
    return a - b, a, b

  return support


def _where(mask, a, b):
  return torch.where(mask[..., None], a, b)


def mpr(t1: int, t2: int, pos1, mat1, size1, pos2, mat2, size2, inflate):
  """Batched MPR (XenoCollide): (hit, depth, normal, point) per pair.

  The CSO is A - B; the origin inside means contact.  The outward portal
  normal is the direction B must move to separate (geom1 -> geom2).
  """
  S = _make_support(t1, t2)
  sup = lambda d: S(d, pos1, mat1, size1, pos2, mat2, size2, inflate)
  c3 = lambda *v: fmask(list(v), pos1)

  # v0: an interior point of the CSO, nudged off exact symmetries
  v0 = pos1 - pos2
  scale = math.norm(v0, keepdim=True)
  v0 = v0 + c3(0.7e-4, 1.3e-4, 1.9e-4) * torch.clamp(scale, min=1e-3)
  v0 = torch.where(scale < 1e-9, v0 + c3(1e-5, 2e-5, 3e-5), v0)

  # phase 1: a portal triangle the origin ray passes through
  v1, a1, b1 = sup(-v0)
  miss = math.dot(v1, -v0) <= 0.0
  d2_ = math.cross(v1, v0)
  deg = math.norm(d2_, keepdim=True) < 1e-10
  alt = math.cross(v0, c3(0.0, 1.0, 0.0).expand(v0.shape))
  alt2 = math.cross(v0, c3(0.0, 0.0, 1.0).expand(v0.shape))
  alt = torch.where(math.norm(alt, keepdim=True) < 1e-10, alt2, alt)
  d2_ = torch.where(deg, alt, d2_)
  v2, a2, b2 = sup(d2_)
  miss = miss | (math.dot(v2, d2_) <= 0.0)
  d3_ = math.cross(v1 - v0, v2 - v0)
  flip = math.dot(d3_, v0) > 0.0
  v1, v2 = _where(flip, v2, v1), _where(flip, v1, v2)
  a1, a2 = _where(flip, a2, a1), _where(flip, a1, a2)
  b1, b2 = _where(flip, b2, b1), _where(flip, b1, b2)
  d3_ = _where(flip, -d3_, d3_)

  v3 = a3 = b3 = torch.zeros_like(v1)
  found = torch.zeros_like(miss)
  for _ in range(_DISCOVER_ITERS):
    v3n, a3n, b3n = sup(d3_)
    miss_n = math.dot(v3n, d3_) <= 0.0
    # origin outside plane (v0, v1, v3): v2 <- v3; (v0, v3, v2): v1 <- v3
    out1 = math.dot(math.cross(v1, v3n), v0) < 0.0
    out2 = math.dot(math.cross(v3n, v2), v0) < 0.0
    done_here = ~out1 & ~out2
    upd = ~found
    m1 = upd & out1 & ~done_here
    m2 = upd & out2 & ~out1
    v2, a2, b2 = (_where(m1, v3n, v2), _where(m1, a3n, a2),
                  _where(m1, b3n, b2))
    v1, a1, b1 = (_where(m2, v3n, v1), _where(m2, a3n, a1),
                  _where(m2, b3n, b1))
    d3n = math.cross(v1 - v0, v2 - v0)
    m3 = upd & done_here
    v3, a3, b3 = (_where(m3, v3n, v3), _where(m3, a3n, a3),
                  _where(m3, b3n, b3))
    miss = miss | (miss_n & ~found)
    found = found | done_here
    d3_ = _where(upd, d3n, d3_)
  miss = miss | ~found

  def portal_normal(v1, v2, v3):
    nrm = _unit(math.cross(v2 - v1, v3 - v1))
    sgn = torch.sign(math.dot(nrm, v1 - v0))[..., None]
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return nrm * sgn

  # phase 2: refine the portal toward the CSO surface
  hit = torch.zeros_like(miss)
  done = miss
  for _ in range(_REFINE_ITERS):
    nrm = portal_normal(v1, v2, v3)
    hit = hit | (math.dot(nrm, v1) >= -1e-8)
    v4, a4, b4 = sup(nrm)
    done = done | ~(math.dot(nrm, v4 - v1) > 1e-7)
    # portal split (libccd expandPortal)
    w = math.cross(v4, v0)
    t1_, t2_, t3_ = math.dot(v1, w) > 0.0, math.dot(v2, w) > 0.0, math.dot(v3, w) > 0.0
    upd = ~done
    r1 = upd & ((t1_ & t2_) | (~t1_ & ~t3_))
    r2 = upd & ~t1_ & t3_
    r3 = upd & t1_ & ~t2_
    v1, a1, b1 = _where(r1, v4, v1), _where(r1, a4, a1), _where(r1, b4, b1)
    v2, a2, b2 = _where(r2, v4, v2), _where(r2, a4, a2), _where(r2, b4, b2)
    v3, a3, b3 = _where(r3, v4, v3), _where(r3, a4, a3), _where(r3, b4, b3)
  hit = hit & ~miss

  nrm = portal_normal(v1, v2, v3)
  depth = math.dot(nrm, v1)

  # phase 3: polish the normal by a pattern search on the CSO support
  def tangents(u):
    ref = torch.where(torch.abs(u[..., 2:3]) < 0.9,
                      c3(0.0, 0.0, 1.0).expand(u.shape),
                      c3(1.0, 0.0, 0.0).expand(u.shape))
    t1_ = _unit(math.cross(ref, u))
    return t1_, math.cross(u, t1_)

  u, (w0, pa, pb) = nrm, sup(nrm)
  h = math.dot(nrm, w0)
  sig = torch.full_like(h[..., None], _POLISH_SIGMA0)
  for _ in range(_POLISH_ITERS):
    t1_, t2_ = tangents(u)
    improved = torch.zeros_like(sig, dtype=torch.bool)
    for du in (t1_, -t1_, t2_, -t2_):
      ut = _unit(u + sig * du)
      wt, pat, pbt = sup(ut)
      ht = math.dot(ut, wt)
      better = (ht < h)[..., None]
      improved = improved | better
      u = torch.where(better, ut, u)
      pa = torch.where(better, pat, pa)
      pb = torch.where(better, pbt, pb)
      h = torch.minimum(ht, h)
    sig = torch.clamp(torch.where(improved, sig * _POLISH_GROW,
                                  sig * _POLISH_SHRINK),
                      1e-5, _POLISH_SIGMA0)
  nrm = _where(hit, u, nrm)
  depth = torch.where(hit, h, depth)

  # witness: barycentric weights of the origin ray's portal crossing
  n_ = math.cross(v2 - v1, v3 - v1)
  den = torch.clamp(math.dot(n_, n_), min=_EPS)
  ws = [torch.clamp(math.dot(math.cross(q, r), n_) / den, 0.0, 1.0)
        for q, r in ((v2, v3), (v3, v1), (v1, v2))]
  wsum = torch.clamp(ws[0] + ws[1] + ws[2], min=_EPS)
  ws = [x / wsum for x in ws]
  pa_b = ws[0][..., None] * a1 + ws[1][..., None] * a2 + ws[2][..., None] * a3
  pb_b = ws[0][..., None] * b1 + ws[1][..., None] * b2 + ws[2][..., None] * b3
  point = 0.5 * (pa_b + pb_b)
  if t1 in _CURVED:
    point = _where(hit, pa - 0.5 * h[..., None] * u, point)
  elif t2 in _CURVED:
    point = _where(hit, pb + 0.5 * h[..., None] * u, point)
  return hit & (depth >= 0), depth, nrm, point


def make_convex_collider(t1: int, t2: int):
  """The collider of a convex group, ``(m, d, g1, g2)`` as the primitive
  colliders take it."""
  for t in (t1, t2):
    if int(t) not in PORTED_TYPES:
      raise NotImplementedError(unported(t))
  k = convex_ncon(t1, t2)
  return lambda m, d, g1, g2: _collide(m, d, t1, t2, k, g1, g2)


def _collide(m, d, t1, t2, k, g1, g2):
  dev = d.geom_xpos.device
  i1, i2 = ix(g1, dev), ix(g2, dev)
  pos1, mat1, size1 = d.geom_xpos[:, i1], d.geom_xmat[:, i1], m.geom_size[i1]
  pos2, mat2, size2 = d.geom_xpos[:, i2], d.geom_xmat[:, i2], m.geom_size[i2]
  gm = types.world_field(m, 'geom_margin')  # per world where batched
  margin = torch.maximum(gm[:, i1], gm[:, i2])  # (1 or W, n)
  inflate = (0.5 * margin)[..., None]
  hit, depth, normal, point = mpr(t1, t2, pos1, mat1, size1, pos2, mat2,
                                  size2, inflate)
  big = torch.full_like(depth, _BIG)
  dist = torch.where(hit, -depth + margin, big)
  if k == 1:
    return dist[:, None], point[:, None], normal[:, None]

  # 4-point manifold from quadrant-tilted supports
  S = _make_support(t1, t2)
  frame = math.make_frame(normal)
  tan1, tan2 = frame[..., 1, :], frame[..., 2, :]
  no_inf = torch.zeros_like(inflate)
  eps = 1e-2
  dists, points = [], []
  for s1, s2 in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
    dpert = normal + eps * (s1 * tan1 + s2 * tan2)
    _, a, b = S(dpert, pos1, mat1, size1, pos2, mat2, size2, no_inf)
    dists.append(torch.where(hit, math.dot(normal, b - a), big))
    points.append(0.5 * (a + b))
  pos4 = torch.stack(points, 1)
  return torch.stack(dists, 1), pos4, normal[:, None].expand(pos4.shape)
