"""Quaternion and spatial (6D) algebra on batched tensors.

Counterpart of ``mujoco_warp_tpu/ops/math.py``: every function broadcasts
over leading dimensions.  Spatial vectors are ``[angular(3); linear(3)]``.
"""

from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from mujoco_warp_tpu_torch.ops.util import fmask

_EPS = 1e-12
_CONJ = np.array([1.0, -1.0, -1.0, -1.0])
_IDENT = np.array([1.0, 0.0, 0.0, 0.0])


def cross(a, b):
  """a x b over the last axis (``jnp.cross``), broadcasting."""
  a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
  b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
  return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                      a0 * b1 - a1 * b0], dim=-1)


def norm(v, dim=-1, keepdim=False):
  return torch.linalg.vector_norm(v, dim=dim, keepdim=keepdim)


# ----------------------------------------------------------------- quaternion


def mul_quat(u, v):
  """Hamilton product of quaternions (w, x, y, z); broadcasts."""
  u0, u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
  v0, v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
  return torch.stack([
      u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
      u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
      u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
      u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0], dim=-1)


def rot_vec_quat(vec, quat):
  """Rotate vec by quat: q * [0, v] * q^-1 (fast form)."""
  w = quat[..., :1]
  u = quat[..., 1:]
  c = cross(u, vec)
  return vec + 2.0 * (w * c + cross(u, c))


def quat_inv(quat):
  return quat * fmask(_CONJ, quat)


def normalize_quat(quat):
  return quat / torch.clamp(norm(quat, keepdim=True), min=_EPS)


def quat_to_mat(quat):
  """Quaternion (w, x, y, z) -> rotation matrix (..., 3, 3)."""
  w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
  xx, yy, zz = x * x, y * y, z * z
  wx, wy, wz = w * x, w * y, w * z
  xy, xz, yz = x * y, x * z, y * z
  m = torch.stack([
      1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
      2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
      2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
  return m.reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis, angle):
  """Unit axis + angle -> quaternion; broadcasts angle over axis batch."""
  s = torch.sin(angle * 0.5)
  return torch.cat([torch.cos(angle * 0.5)[..., None], axis * s[..., None]],
                   dim=-1)


def quat_integrate(quat, vel, dt):
  """Integrate a quaternion by angular velocity * dt in the local frame
  (mju_quatIntegrate); rotations below 1e-12 rad/s leave it as it is."""
  angle = norm(vel)
  scaled = angle * dt
  axis = vel / torch.clamp(angle, min=_EPS)[..., None]
  q_rot = axis_angle_to_quat(axis, scaled)
  q_rot = torch.where((angle > _EPS)[..., None], q_rot, fmask(_IDENT, quat))
  return normalize_quat(mul_quat(quat, q_rot))


def quat_to_vel(quat):
  """Quaternion -> rotation vector (axis * angle), mju_quat2Vel."""
  axis = quat[..., 1:]
  sin_a_2 = norm(axis)
  speed = 2.0 * torch.atan2(sin_a_2, quat[..., 0])
  speed = torch.where(speed > _pymath.pi, speed - 2.0 * _pymath.pi, speed)
  scale = torch.where(sin_a_2 > _EPS,
                      speed / torch.clamp(sin_a_2, min=_EPS),
                      torch.full_like(speed, 2.0))
  return axis * scale[..., None]


def quat_mul_axis(quat, axis):
  """Quaternion times a pure-vector quaternion (0, axis)."""
  w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
  ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
  return torch.stack([
      -x * ax - y * ay - z * az,
      w * ax + y * az - z * ay,
      w * ay + z * ax - x * az,
      w * az + x * ay - y * ax], dim=-1)


def quat_sub(qa, qb):
  """v with qb * exp(v) = qa (mju_subQuat)."""
  q = mul_quat(quat_inv(qb), qa)
  q = q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
  sin_half = norm(q[..., 1:])
  angle = 2.0 * torch.atan2(sin_half, q[..., 0])
  axis = q[..., 1:] / torch.clamp(sin_half, min=_EPS)[..., None]
  return torch.where((sin_half > _EPS)[..., None], axis * angle[..., None],
                     torch.zeros_like(q[..., 1:]))


# -------------------------------------------------------------------- spatial


def skew(v):
  """Cross-product matrix (..., 3, 3)."""
  x, y, z = v[..., 0], v[..., 1], v[..., 2]
  zero = torch.zeros_like(x)
  m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
  return m.reshape(v.shape[:-1] + (3, 3))


def motion_cross(v, u):
  """Spatial motion cross product v x u for motion vectors [ang; lin]."""
  va, vl = v[..., :3], v[..., 3:]
  ua, ul = u[..., :3], u[..., 3:]
  return torch.cat([cross(va, ua), cross(vl, ua) + cross(va, ul)], dim=-1)


def motion_cross_force(v, f):
  """Spatial force cross product v x* f."""
  va, vl = v[..., :3], v[..., 3:]
  fa, fl = f[..., :3], f[..., 3:]
  return torch.cat([cross(va, fa) + cross(vl, fl), cross(va, fl)], dim=-1)


def inert_matrix(inertia_diag, mass, com, rot):
  """Spatial inertia (..., 6, 6) about a frame origin offset by ``com``
  from the body's CoM, [[I_c + m c^ c^T, m c^], [m c^T, m 1]]."""
  ic = rot @ (inertia_diag[..., None] * rot.transpose(-1, -2))
  c_hat = skew(com)
  m = mass[..., None, None]
  tl = ic + m * (c_hat @ c_hat.transpose(-1, -2))
  tr = m * c_hat
  bl = m * c_hat.transpose(-1, -2)
  eye = torch.eye(3, dtype=inertia_diag.dtype, device=inertia_diag.device)
  br = m * eye.expand(c_hat.shape)
  return torch.cat([torch.cat([tl, tr], dim=-1),
                    torch.cat([bl, br], dim=-1)], dim=-2)


def transform_motion(vec, offset):
  """Motion vector with its origin moved by +offset."""
  ang, lin = vec[..., :3], vec[..., 3:]
  return torch.cat([ang, lin - cross(offset, ang)], dim=-1)


def transform_force(vec, offset):
  """Force vector with its origin moved by +offset."""
  ang, lin = vec[..., :3], vec[..., 3:]
  return torch.cat([ang - cross(offset, lin), lin], dim=-1)


def dot(a, b, keepdim=False):
  """Inner product over the last axis."""
  return torch.sum(a * b, dim=-1, keepdim=keepdim)


def safe_norm(v, dim=-1):
  return torch.sqrt(torch.sum(v * v, dim=dim) + _EPS * _EPS)


def orthogonals(a):
  """Two unit vectors orthogonal to unit vector a."""
  y = torch.where(torch.abs(a[..., 1:2]) < 0.9, fmask([0.0, 1.0, 0.0], a),
                  fmask([0.0, 0.0, 1.0], a))
  b = y - a * torch.sum(a * y, dim=-1, keepdim=True)
  b = b / torch.clamp(norm(b, keepdim=True), min=_EPS)
  return b, cross(a, b)


def make_frame(a):
  """3x3 frame whose first row is unit(a) (contact frame rows)."""
  a = a / torch.clamp(norm(a, keepdim=True), min=_EPS)
  b, c = orthogonals(a)
  return torch.stack([a, b, c], dim=-2)
