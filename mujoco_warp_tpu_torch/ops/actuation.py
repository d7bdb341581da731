"""Muscle curves and activation dynamics, elementwise on tensors.

Counterpart of ``mujoco_warp_tpu/ops/actuation.py``: ``muscle_gain_length``
(:16), ``_norm_len`` (:31), ``_force_scale`` (:39), ``muscle_gain`` (:45),
``muscle_bias`` (:63), ``_sigmoid`` (:78) and ``muscle_dynamics`` (:84).
Every function broadcasts over leading axes (worlds, actuators); ``prm``
holds the actuator's ten parameters on its last axis.  Each branch is
picked by ``torch.where`` and every divisor is held above ``_MINVAL``, so
a branch not taken never multiplies a non-finite value in.
"""

from __future__ import annotations

import torch

_MINVAL = 1e-15


def _floor(x):
  """max(x, _MINVAL)."""
  return torch.clamp(x, min=_MINVAL)


def muscle_gain_length(length, lmin, lmax):
  """The normalized bump of the active force over normalized length
  (``actuation.py:16``): two quadratic halves on each side of 1, zero
  outside [lmin, lmax]."""
  a = 0.5 * (lmin + 1.0)
  b = 0.5 * (1.0 + lmax)
  x1 = (length - lmin) / _floor(a - lmin)
  x2 = (1.0 - length) / _floor(1.0 - a)
  x3 = (length - 1.0) / _floor(b - 1.0)
  x4 = (lmax - length) / _floor(lmax - b)
  out = torch.where(
      length <= a, 0.5 * x1 * x1,
      torch.where(length <= 1.0, 1.0 - 0.5 * x2 * x2,
                  torch.where(length <= b, 1.0 - 0.5 * x3 * x3,
                              0.5 * x4 * x4)))
  return torch.where((lmin > length) | (length > lmax),
                     torch.zeros_like(out), out)


def _norm_len(length, lengthrange, prm):
  """(L, L0): the length normalized by the optimal length L0, and L0
  (``actuation.py:31``)."""
  rng0, rng1 = prm[..., 0], prm[..., 1]
  L0 = (lengthrange[..., 1] - lengthrange[..., 0]) / _floor(rng1 - rng0)
  L = rng0 + (length - lengthrange[..., 0]) / _floor(L0)
  return L, L0


def _force_scale(prm, acc0):
  """The peak force: prm[2], or where it is negative prm[3] / acc0
  (``actuation.py:39``)."""
  return torch.where(prm[..., 2] < 0.0, prm[..., 3] / _floor(acc0),
                     prm[..., 2])


def muscle_gain(length, vel, lengthrange, acc0, prm):
  """The active muscle force per unit activation, a pull (negative)
  (``actuation.py:45``): peak force x length curve x velocity curve."""
  force = _force_scale(prm, acc0)
  lmin, lmax = prm[..., 4], prm[..., 5]
  vmax, fvmax = prm[..., 6], prm[..., 8]
  L, L0 = _norm_len(length, lengthrange, prm)
  V = vel / _floor(L0 * vmax)
  FL = muscle_gain_length(L, lmin, lmax)
  y = fvmax - 1.0
  FV = torch.where(
      V <= -1.0, torch.zeros_like(V),
      torch.where(V <= 0.0, (V + 1.0) ** 2,
                  torch.where(V <= y, fvmax - (y - V) ** 2 / _floor(y),
                              fvmax)))
  return -force * FL * FV


def muscle_bias(length, lengthrange, acc0, prm):
  """The passive muscle force (``actuation.py:63``): zero below the
  optimal length, a quadratic to b = (1 + lmax) / 2, linear beyond."""
  force = _force_scale(prm, acc0)
  lmax, fpmax = prm[..., 5], prm[..., 7]
  L, _ = _norm_len(length, lengthrange, prm)
  b = 0.5 * (1.0 + lmax)
  x_mid = (L - 1.0) / _floor(b - 1.0)
  x_hi = (L - b) / _floor(b - 1.0)
  return torch.where(
      L <= 1.0, torch.zeros_like(L),
      torch.where(L <= b, -force * fpmax * 0.5 * x_mid * x_mid,
                  -force * fpmax * (0.5 + x_hi)))


def _sigmoid(x):
  """The quintic smoothstep on [0, 1] (``actuation.py:78``)."""
  xc = torch.clamp(x, 0.0, 1.0)
  return xc * xc * xc * (3.0 * xc * (2.0 * xc - 5.0) + 10.0)


def muscle_dynamics(ctrl, act, prm):
  """The activation's rate toward the clamped control
  (``actuation.py:84``): time constants prm[0] (activation) and prm[1]
  (deactivation) scaled by the activation, blended over the width prm[2]
  by ``_sigmoid``, or switched hard where that width is 0."""
  ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
  actclamp = torch.clamp(act, 0.0, 1.0)
  tau_act = prm[..., 0] * (0.5 + 1.5 * actclamp)
  tau_deact = prm[..., 1] / (0.5 + 1.5 * actclamp)
  smooth_width = prm[..., 2]
  dctrl = ctrlclamp - act
  tau_hard = torch.where(dctrl > 0.0, tau_act, tau_deact)
  tau_smooth = tau_deact + (tau_act - tau_deact) * _sigmoid(
      dctrl / _floor(smooth_width) + 0.5)
  tau = torch.where(smooth_width < _MINVAL, tau_hard, tau_smooth)
  return dctrl / _floor(tau)
