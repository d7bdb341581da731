"""Lanes-last helpers: every per-body value is a ``(rows, W)`` tensor and
grouped narrowphase values are ``(n, rows, W)``.

Counterpart of the lane helpers in ``mujoco_warp_tpu/pallas/fused.py``
(:97-221).  Constants enter as python floats so, as in the JAX trace, zero
terms are skipped and the arithmetic matches term for term.
"""

from __future__ import annotations

import torch

MINVAL = 1e-15
BIGW = 1e10
MJ_MINIMP = 0.0001
MJ_MAXIMP = 0.9999


def cat(xs, dim=0):
  return torch.cat(xs, dim=dim)


def qmul(u, v):
  """(4, W) x (4, W) quaternion product."""
  u0, u1, u2, u3 = u[0:1], u[1:2], u[2:3], u[3:4]
  v0, v1, v2, v3 = v[0:1], v[1:2], v[2:3], v[3:4]
  return cat([
      u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
      u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
      u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
      u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0])


def _terms(*terms, like):
  acc = None
  for coef, val in terms:
    if coef == 0.0:
      continue
    term = val * coef if coef != 1.0 else val
    acc = term if acc is None else acc + term
  return acc if acc is not None else torch.zeros_like(like)


def qmul_const(u, c):
  """(4, W) quaternion times a constant quaternion (zero terms skipped)."""
  c = [float(x) for x in c]
  if c == [1.0, 0.0, 0.0, 0.0]:
    return u
  u0, u1, u2, u3 = u[0:1], u[1:2], u[2:3], u[3:4]
  return cat([
      _terms((c[0], u0), (-c[1], u1), (-c[2], u2), (-c[3], u3), like=u0),
      _terms((c[1], u0), (c[0], u1), (c[3], u2), (-c[2], u3), like=u0),
      _terms((c[2], u0), (-c[3], u1), (c[0], u2), (c[1], u3), like=u0),
      _terms((c[3], u0), (c[2], u1), (-c[1], u2), (c[0], u3), like=u0)])


def qnormalize(q):
  n = torch.sqrt(torch.clamp(torch.sum(q * q, dim=0, keepdim=True),
                             min=MINVAL))
  return q / n


def q2mat(q):
  """(4, W) quaternion -> (9, W) row-major rotation matrix."""
  w, x, y, z = q[0:1], q[1:2], q[2:3], q[3:4]
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  return cat([
      1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
      2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
      2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)])


def mat_vec_const(R, c):
  """(9, W) row-major matrix times a constant 3-vector -> (3, W)."""
  c = [float(x) for x in c]
  return cat([_terms(*[(c[k], R[3 * r + k:3 * r + k + 1]) for k in range(3)],
                     like=R[0:1]) for r in range(3)])


def qrot_const(c, q):
  """Rotate constant vector c by quaternion (4, W); None when c is 0."""
  if float(c[0]) == 0.0 and float(c[1]) == 0.0 and float(c[2]) == 0.0:
    return None
  return mat_vec_const(q2mat(q), c)


def add(a, b):
  return a if b is None else a + b


def cross(a, b):
  """(3, W) x (3, W)."""
  return cat([
      a[1:2] * b[2:3] - a[2:3] * b[1:2],
      a[2:3] * b[0:1] - a[0:1] * b[2:3],
      a[0:1] * b[1:2] - a[1:2] * b[0:1]])


def gdot(a, b):
  """Grouped (n, 3, W) dot -> (n, 1, W)."""
  return torch.sum(a * b, dim=1, keepdim=True)


def gcross(a, b):
  return cat([
      a[:, 1:2] * b[:, 2:3] - a[:, 2:3] * b[:, 1:2],
      a[:, 2:3] * b[:, 0:1] - a[:, 0:1] * b[:, 2:3],
      a[:, 0:1] * b[:, 1:2] - a[:, 1:2] * b[:, 0:1]], dim=1)


def gnorm(a):
  return torch.sqrt(torch.clamp(gdot(a, a), min=MINVAL))


def make_frame_g(normal):
  """(n, 3, W) normal -> (n, 9, W) contact frame rows [n, t1, t2]."""
  a = normal / gnorm(normal)
  cond = (torch.abs(a[:, 1:2]) < 0.9).to(a.dtype)
  y = cat([torch.zeros_like(cond), cond, 1.0 - cond], dim=1)
  b = y - a * gdot(a, y)
  b = b / gnorm(b)
  return cat([a, b, gcross(a, b)], dim=1)
