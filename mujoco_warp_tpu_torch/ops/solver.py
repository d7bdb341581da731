"""The Newton and CG solves of the general step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/solver.py`` for frictionless,
pyramidal and elliptic contact, limit, equality and friction-loss rows:
``_static_tables`` (:71), ``_update_constraint`` (:116), ``_cone_hessian``
(:184), ``_eval_delta`` (:222), ``_elliptic_ls_coeffs`` (:328),
``_eval_p0`` (:373), ``_in_bracket`` (:420), ``_linesearch`` (:425),
``_gradient`` (:682) and ``solve`` (:720).  The JAX package runs
it under ``vmap`` for a Newton system beyond nefc * nv 12,000
(``pallas/solver.py`` ``_use_big``) and for the CG solver at every size
(its Pallas solve is Newton-only, :110-112); here every world is a row of
one batch.  Newton: H = qM + J^T diag(D quad) J and the J products are
batched matrix products; H^-1 grad goes through the ``chol_batched``
kernel (jitter 1e-15) and the ``chol_solve`` kernel, as
``_make_chol_solve`` (:534) swaps in the Pallas pair; with elliptic
cones H also takes the middle-zone cone curvature, formed per contact as
Jc^T C Jc and summed by one batched product.  The elliptic contacts'
linesearch segments stay on the device, with no host read of their
own.  CG: M^-1 grad
through the ``chol_solve`` kernel on the mass factor qLD
(``smooth.solve_m``, :699-700), the search direction -M^-1 grad plus the
Polak-Ribiere beta (at least 0) times the last one (:761-766), and no
model-improvement stop.

The loops keep the semantics of a ``while_loop`` under ``vmap``: each trip
computes every world, a world whose loop is done keeps its carry, and the
loop runs until every world is done (the Newton loop also stops at
``opt.iterations``, the linesearch's bracket loop at ``ls_iterations``).
Each trip reads ``done.all()`` on the host, one synchronisation per trip.
The linesearch of a world whose Newton loop is done is discarded, so its
bracket loop waits only for the live worlds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, host_item, ix

_CT = types.ConstraintType
_MINVAL = 1e-15
_SATISFIED, _QUADRATIC, _LINEARNEG, _LINEARPOS, _CONE = 0, 1, 2, 3, 4

# Newton or CG trips (iterations of the batched loop) of every solve so far
trips = 0


class _Ell(NamedTuple):
  """The elliptic contacts' tables (``_static_tables`` :80-99): per
  elliptic contact slot ``con`` (nec,), its rows ``adr`` (nec, maxdim),
  padded with row 0 where ``mask`` (nec, maxdim) is False, and the rows
  and flat (contact, place) positions of the real entries, ``rows`` and
  ``flat``, for scattering back only those (the JAX update scatters the
  padding too, over row 0's cone force: ROADMAP queue 3); ``mu_scale`` =
  1 / sqrt(impratio), (1 or W, 1), each world's."""

  con: torch.Tensor
  adr: torch.Tensor
  mask: torch.Tensor
  rows: torch.Tensor
  flat: torch.Tensor
  maxdim: int
  mu_scale: torch.Tensor


class _Static(NamedTuple):
  """Row classes as float masks (None: the class has no row), and the
  elliptic contacts (None without them)."""

  is_eq: torch.Tensor
  is_fri: torch.Tensor
  is_quadlike: torch.Tensor
  ell: _Ell


def _static_tables(m: types.Model, like: torch.Tensor) -> _Static:
  t = m.efc.efc_type
  quad = np.isin(t, (_CT.LIMIT_JOINT, _CT.LIMIT_TENDON,
                     _CT.CONTACT_FRICTIONLESS, _CT.CONTACT_PYRAMIDAL))
  mask = lambda x: fmask(x.astype(np.float32), like) if np.any(x) else None
  ell = None
  if m.ncon and m.opt.cone == types.ConeType.ELLIPTIC:
    cons = np.nonzero(np.asarray(m.con_dim) > 1)[0]
    if len(cons):
      dims = np.asarray(m.con_dim)[cons]
      maxdim = int(dims.max())
      emask = np.arange(maxdim)[None] < dims[:, None]
      adr = np.where(emask, np.asarray(m.con_efc_address)[cons][:, None] +
                     np.arange(maxdim), 0)
      dev = like.device
      mu_scale = 1.0 / torch.sqrt(torch.clamp(types.world_field(
          m, 'opt.impratio').to(like.dtype), min=_MINVAL))[:, None]
      ell = _Ell(ix(cons, dev), ix(adr, dev), bmask(emask, dev),
                 ix(adr[emask], dev), ix(np.nonzero(emask.reshape(-1))[0],
                                         dev), maxdim, mu_scale)
  return _Static(mask(t == _CT.EQUALITY),
                 mask((t == _CT.FRICTION_DOF) | (t == _CT.FRICTION_TENDON)),
                 mask(quad), ell)


def _weighted_sum(st: _Static, eq, ql, fr):
  """sum over rows of w_eq eq + w_ql ql + w_fr fr (a class without rows
  adds exact zeros and is left out; the elliptic rows are in no class)."""
  terms = [w * x for w, x in ((st.is_eq, eq), (st.is_quadlike, ql),
                              (st.is_fri, fr)) if w is not None]
  if not terms:
    return torch.zeros_like(eq[..., 0])
  tot = terms[0]
  for x in terms[1:]:
    tot = tot + x
  return torch.sum(tot, dim=-1)


def _safe_div(a, b):
  return a / torch.where(torch.abs(b) > _MINVAL, b,
                         torch.where(b >= 0, torch.full_like(b, _MINVAL),
                                     torch.full_like(b, -_MINVAL)))


def _mv(A, x):
  """Batched matrix (W, a, b) times vectors (W, b)."""
  return torch.matmul(A, x[..., None])[..., 0]


def _ell_gather(d, e: _Ell, x):
  """Per elliptic contact of every world: x's entries at its rows, (W,
  nec, maxdim), and mu = friction[0] mu_scale and the tangent scales
  f_j (zero on the padding), (W, nec) and (W, nec, maxdim - 1)."""
  fric = d.contact.friction[:, e.con]  # (W, nec, 5)
  mu = fric[..., 0] * e.mu_scale
  fr_j = fric[..., :e.maxdim - 1] * e.mask[:, 1:].to(x.dtype)
  return x[:, e.adr], mu, fr_j


def _ell_scatter(e: _Ell, full, vals):
  """``full`` (W, nefc) with the elliptic rows set from ``vals`` (W, nec,
  maxdim)."""
  W = full.shape[0]
  return full.index_copy(1, e.rows, vals.reshape(W, -1)[:, e.flat])


def _update_constraint(d, st: _Static, Jaref):
  """Row forces and states (``solver.py:116``), the elliptic contacts'
  zones among them: top (satisfied), bottom (every row quadratic) and the
  middle zone (``_CONE``)."""
  D, fl = d.efc_D, d.efc_frictionloss
  zero = torch.zeros_like(Jaref)
  act = Jaref < 0.0
  force = torch.where(act, -D * Jaref, zero)
  state = torch.where(act, _QUADRATIC, _SATISFIED)
  if st.is_eq is not None:
    eq = st.is_eq > 0
    force = torch.where(eq, -D * Jaref, force)
    state = torch.where(eq, torch.full_like(state, _QUADRATIC), state)
  if st.is_fri is not None:
    fri = st.is_fri > 0
    rf = _safe_div(fl, D)
    f_fri = torch.where(Jaref <= -rf, fl,
                        torch.where(Jaref >= rf, -fl, -D * Jaref))
    s_fri = torch.where(Jaref <= -rf, _LINEARNEG,
                        torch.where(Jaref >= rf, _LINEARPOS, _QUADRATIC))
    force = torch.where(fri, f_fri, force)
    state = torch.where(fri, s_fri, state)
  e = st.ell
  if e is not None:
    jar, mu, fr_j = _ell_gather(d, e, Jaref)
    Dc = D[:, e.adr]
    u = jar[..., 1:] * fr_j
    TT = torch.sum(u * u, -1)
    T = torch.sqrt(torch.clamp(TT, min=0.0))
    N = jar[..., 0] * mu
    top = (N >= mu * T) | ((TT <= 0.0) & (N >= 0.0))
    bottom = ((mu * N + T <= 0.0) | ((TT <= 0.0) & (N < 0.0))) & ~top
    dm = _safe_div(Dc[..., 0], mu * mu * (1.0 + mu * mu))
    f_normal = -dm * (N - mu * T) * mu
    f_tan = -_safe_div(f_normal, T)[..., None] * u * fr_j
    f_cone = torch.cat([f_normal[..., None], f_tan], dim=-1)
    f_con = torch.where(top[..., None], torch.zeros_like(f_cone),
                        torch.where(bottom[..., None], -Dc * jar, f_cone))
    s_con = torch.where(top, _SATISFIED,
                        torch.where(bottom, _QUADRATIC, _CONE))
    force = _ell_scatter(e, force, f_con)
    state = _ell_scatter(e, state, s_con[..., None].expand(jar.shape))
  return force, state


def _cone_hessian(d, st: _Static, Jaref, state):
  """The middle-zone cone curvature of the elliptic contacts summed into
  one (W, nv, nv) term (``solver.py:184``).  Each contact's term is
  Jc^T C Jc over its rows Jc (maxdim x nv), with the symmetric block C
  (maxdim x maxdim; q_j = u_j f_j): C00 = mu^2, C0j = -(mu^2 / t) q_j,
  Cjk = (mu N / t^3) q_j q_k + (mu^2 - N mu / t) f_j^2 [j = k], times
  D / (mu^2 (1 + mu^2)) in the middle zone and 0 elsewhere; then one
  batched product sums every contact (no (nec, nv, nv) temporary)."""
  e = st.ell
  W, nv = Jaref.shape[0], d.efc_J.shape[-1]
  jar, mu, fr_j = _ell_gather(d, e, Jaref)
  Dc0 = d.efc_D[:, e.adr[:, 0]]
  u = jar[..., 1:] * fr_j
  t = torch.clamp(torch.sqrt(torch.clamp(torch.sum(u * u, -1), min=0.0)),
                  min=_MINVAL)
  n = jar[..., 0] * mu
  dm = _safe_div(Dc0, mu * mu * (1.0 + mu * mu))
  is_cone = (state[:, e.adr[:, 0]] == _CONE) & (dm != 0.0)
  w = dm * is_cone.to(dm.dtype)
  ttt = torch.clamp(t * t * t, min=_MINVAL)
  mu_t = _safe_div(mu, t)
  q = u * fr_j  # (W, nec, maxdim - 1)
  C0j = (-w * mu * mu_t)[..., None] * q
  Cjk = (w * mu * _safe_div(n, ttt))[..., None, None] * \
      (q[..., :, None] * q[..., None, :]) + torch.diag_embed(
          (w * (mu * mu - n * mu_t))[..., None] * fr_j * fr_j)
  C = torch.cat([torch.cat([(w * mu * mu)[..., None, None],
                            C0j[..., None, :]], dim=-1),
                 torch.cat([C0j[..., :, None], Cjk], dim=-1)], dim=-2)
  Jc = d.efc_J[:, e.adr]  # (W, nec, maxdim, nv)
  CJ = torch.matmul(C, Jc).reshape(W, -1, nv)
  return torch.bmm(Jc.reshape(W, -1, nv).transpose(1, 2), CJ)


def _fri_pt(D, fl, jv, jvD, hess, rf, xx):
  mid = (-rf < xx) & (xx < rf)
  c = torch.where(mid, 0.5 * D * xx * xx,
                  torch.where(xx <= -rf, fl * (-0.5 * rf - xx),
                              fl * (-0.5 * rf + xx)))
  g = torch.where(mid, jvD * xx, torch.where(xx <= -rf, -fl * jv, fl * jv))
  h = torch.where(mid, hess, torch.zeros_like(hess))
  return c, g, h


def _elliptic_ls_coeffs(d, st: _Static, Jaref, jv):
  """Per elliptic contact, the linesearch's coefficients and its zone at
  alpha 0 (``solver.py:328``): (mu, quad (W, nec, 3), u0, v0, uu, uv, vv,
  dm, cost0, T0, r0, state0), each (W, nec)."""
  e = st.ell
  jar, mu, fr_j = _ell_gather(d, e, Jaref)
  jvc = jv[:, e.adr]
  Dc = d.efc_D[:, e.adr]
  maskf = e.mask.to(Jaref.dtype)
  DJ = Dc * jar * maskf
  quad = torch.stack([torch.sum(0.5 * jar * DJ, -1),
                      torch.sum(jvc * DJ, -1),
                      torch.sum(0.5 * jvc * Dc * jvc * maskf, -1)], dim=-1)
  u = jar[..., 1:] * fr_j
  v = jvc[..., 1:] * fr_j
  u0 = jar[..., 0] * mu
  v0 = jvc[..., 0] * mu
  uu = torch.sum(u * u, -1)
  uv = torch.sum(u * v, -1)
  vv = torch.sum(v * v, -1)
  dm = _safe_div(Dc[..., 0], mu * mu * (1.0 + mu * mu))
  T0r = torch.sqrt(torch.clamp(uu, min=0.0))
  no_t = uu <= 0.0
  satisfied = torch.where(no_t, u0 >= 0.0, u0 >= mu * T0r)
  quad_zone = torch.where(no_t, u0 < 0.0, mu * u0 + T0r <= 0.0)
  r0 = u0 - mu * T0r
  zero = torch.zeros_like(u0)
  cost0 = torch.where(satisfied, zero,
                      torch.where(quad_zone, quad[..., 0], 0.5 * dm * r0 * r0))
  state0 = torch.where(satisfied, _SATISFIED,
                       torch.where(quad_zone, _QUADRATIC, _CONE))
  return (mu, quad, u0, v0, uu, uv, vv, dm, cost0, T0r,
          torch.where(state0 == _CONE, r0, zero), state0)


def _ell_delta(ell, a):
  """The elliptic contacts' (cost change, slope, curvature) at step a
  (W, 1), each summed over contacts to (W,) (``solver.py:269-318``)."""
  (mu, quad, u0, v0, uu, uv, vv, dm, cost0e, T0, r0, state0) = ell
  N = u0 + a * v0
  Tsqr_delta = a * (2.0 * uv + a * vv)
  Tsqr = uu + Tsqr_delta
  T = torch.sqrt(torch.clamp(Tsqr, min=0.0))
  in_quad_zone = torch.where(Tsqr <= 0.0, N < 0.0, mu * N + T <= 0.0)
  in_top = (Tsqr > 0.0) & (N >= mu * T)
  in_mid = (Tsqr > 0.0) & ~in_top & ~in_quad_zone
  zero = torch.zeros_like(N)
  aq2 = a * quad[..., 2]
  c_q = a * (aq2 + quad[..., 1])
  boundary = mu * N + T
  gap = 0.5 * dm * boundary * boundary
  c_q = c_q + torch.where(
      state0 == _CONE, 0.5 * dm * (mu * u0 + T0) ** 2,
      torch.where(state0 == _SATISFIED,
                  0.5 * dm * (1.0 + mu * mu) * (
                      N * N + torch.clamp(Tsqr, min=0.0)), zero))
  g_q = 2.0 * aq2 + quad[..., 1]
  h_q = 2.0 * quad[..., 2]
  T_inv = 1.0 / torch.clamp(T, min=_MINVAL)
  T1 = (uv + a * vv) * T_inv
  T2 = (vv - T1 * T1) * T_inv
  r = N - mu * T
  r1 = v0 - mu * T1
  T_delta = Tsqr_delta / torch.clamp(T + T0, min=_MINVAL)
  r_delta = a * v0 - mu * T_delta
  c_m = torch.where(
      state0 == _CONE, 0.5 * dm * r_delta * (2.0 * r0 + r_delta),
      torch.where(state0 == _QUADRATIC, a * (aq2 + quad[..., 1]) - gap,
                  0.5 * dm * r * r))
  g_m = dm * r * r1
  h_m = dm * (r1 * r1 + r * (-mu * T2))
  c_e = torch.where(in_quad_zone, c_q, torch.where(in_mid, c_m, -cost0e))
  g_e = torch.where(in_quad_zone, g_q, torch.where(in_mid, g_m, zero))
  h_e = torch.where(in_quad_zone, h_q, torch.where(in_mid, h_m, zero))
  return torch.sum(c_e, -1), torch.sum(g_e, -1), torch.sum(h_e, -1)


def _eval_delta(d, st, Jaref, jv, quad_gauss, ell, alpha):
  """(cost change, slope, curvature) at step alpha (W,), as (W, 3)
  (``solver.py:222``)."""
  D, fl = d.efc_D, d.efc_frictionloss
  a = alpha[:, None]
  x = Jaref + a * jv
  jvD = jv * D
  grad0 = jvD * Jaref
  hess = jv * jvD
  zero = torch.zeros_like(x)
  c_eq = a * (grad0 + 0.5 * a * hess)
  g_eq = grad0 + a * hess
  quad0 = 0.5 * D * Jaref * Jaref
  cost0 = torch.where(Jaref < 0.0, quad0, zero)
  neg = x < 0.0
  c_ql = torch.where(neg, c_eq + (quad0 - cost0), -cost0)
  g_ql = torch.where(neg, g_eq, zero)
  h_ql = torch.where(neg, hess, zero)
  c_fr = g_fr = h_fr = None
  if st.is_fri is not None:
    rf = _safe_div(fl, D)
    cf, g_fr, h_fr = _fri_pt(D, fl, jv, jvD, hess, rf, x)
    cf0, _, _ = _fri_pt(D, fl, jv, jvD, hess, rf, Jaref)
    c_fr = cf - cf0
  cost = _weighted_sum(st, c_eq, c_ql, c_fr)
  grad = _weighted_sum(st, g_eq, g_ql, g_fr)
  hessian = _weighted_sum(st, hess, h_ql, h_fr)
  if ell is not None:
    ce, ge, he = _ell_delta(ell, a)
    cost, grad, hessian = cost + ce, grad + ge, hessian + he
  g1, g2 = quad_gauss
  cost = cost + alpha * alpha * g2 + alpha * g1
  grad = grad + 2.0 * alpha * g2 + g1
  hessian = hessian + 2.0 * g2
  return torch.stack([cost, grad, hessian], dim=-1)


def _eval_p0(d, st, Jaref, jv, quad_gauss, ell):
  """(0, slope, curvature) at alpha 0, as (W, 3) (``solver.py:373``)."""
  D, fl = d.efc_D, d.efc_frictionloss
  jvD = jv * D
  grad0 = jvD * Jaref
  hess = jv * jvD
  zero = torch.zeros_like(hess)
  act = Jaref < 0.0
  g_ql = torch.where(act, grad0, zero)
  h_ql = torch.where(act, hess, zero)
  g_fr = h_fr = None
  if st.is_fri is not None:
    rf = _safe_div(fl, D)
    mid = (-rf < Jaref) & (Jaref < rf)
    g_fr = torch.where(mid, grad0,
                       torch.where(Jaref <= -rf, -fl * jv, fl * jv))
    h_fr = torch.where(mid, hess, zero)
  grad = _weighted_sum(st, grad0, g_ql, g_fr)
  hessian = _weighted_sum(st, hess, h_ql, h_fr)
  if ell is not None:
    (mu, quad, u0, v0, uu, uv, vv, dm, cost0e, T0, r0, state0) = ell
    T0_inv = 1.0 / torch.clamp(T0, min=_MINVAL)
    T1 = uv * T0_inv
    T2 = (vv - T1 * T1) * T0_inv
    r1 = v0 - mu * T1
    g_m = dm * r0 * r1
    h_m = dm * (r1 * r1 - mu * r0 * T2)
    z = torch.zeros_like(u0)
    g_e = torch.where(state0 == _QUADRATIC, quad[..., 1],
                      torch.where(state0 == _CONE, g_m, z))
    h_e = torch.where(state0 == _QUADRATIC, 2.0 * quad[..., 2],
                      torch.where(state0 == _CONE, h_m, z))
    grad = grad + torch.sum(g_e, -1)
    hessian = hessian + torch.sum(h_e, -1)
  g1, g2 = quad_gauss
  return torch.stack([torch.zeros_like(grad), grad + g1,
                      hessian + 2.0 * g2], dim=-1)


def _in_bracket(x, y):
  """``solver.py:420`` on (W, 3) points."""
  return (((x[:, 1] < y[:, 1]) & (y[:, 1] < 0.0)) |
          ((x[:, 1] > y[:, 1]) & (y[:, 1] > 0.0)))


def _sel(mask, a, b):
  return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)


def _linesearch(m, d, st, Ma, Jaref, search, live):
  """The iterative 3-alpha bracketed linesearch (``solver.py:425``) of
  every world; ``live`` marks the worlds whose result is used.  Returns
  (alpha, improvement, J search, M search)."""
  dt = Jaref.dtype
  jv = _mv(d.efc_J, search)
  mv = _mv(d.qM, search)
  g1 = torch.sum(search * (Ma - d.qfrc_smooth), dim=-1)
  g2 = 0.5 * torch.sum(search * mv, dim=-1)
  quad_gauss = (g1, g2)
  ell = None if st.ell is None else _elliptic_ls_coeffs(d, st, Jaref, jv)
  snorm = torch.sqrt(torch.clamp(torch.sum(search * search, dim=-1),
                                 min=0.0))
  scale = m.stat.meaninertia * float(m.nv)
  # each world's (1 or W,): a world stops on its own test
  tol, ls_tol = (types.world_field(m, 'opt.tolerance'),
                 types.world_field(m, 'opt.ls_tolerance'))
  gtol = torch.clamp(tol * ls_tol * snorm * scale, min=1e-6)
  ev = lambda a: _eval_delta(d, st, Jaref, jv, quad_gauss, ell, a)
  p0 = _eval_p0(d, st, Jaref, jv, quad_gauss, ell)
  p0_delta = p0.clone()
  p0_delta[:, 0] = 0.0

  lo_alpha_in = -_safe_div(p0[:, 1], p0[:, 2])
  lo_in = ev(lo_alpha_in)
  initial_converged = (torch.abs(lo_in[:, 1]) < gtol) & (lo_in[:, 0] < 0.0)
  zero = torch.zeros_like(lo_alpha_in)
  lo_less = lo_in[:, 1] < p0[:, 1]
  lo, lo_alpha = _sel(lo_less, lo_in, p0_delta), _sel(lo_less, lo_alpha_in,
                                                      zero)
  hi, hi_alpha = _sel(lo_less, p0_delta, lo_in), _sel(lo_less, zero,
                                                      lo_alpha_in)
  alpha, improvement = zero, zero
  it = 0
  ls_done = torch.zeros_like(lo_less)
  while it < m.opt.ls_iterations:
    run = ~ls_done
    if not host_item((run & live).any(), 'solver'):
      break
    lo_next_alpha = lo_alpha - _safe_div(lo[:, 1], lo[:, 2])
    hi_next_alpha = hi_alpha - _safe_div(hi[:, 1], hi[:, 2])
    mid_alpha = 0.5 * (lo_alpha + hi_alpha)
    lo_next, hi_next, midv = ev(lo_next_alpha), ev(hi_next_alpha), \
        ev(mid_alpha)

    swap_ll = _in_bracket(lo, lo_next)
    lo1, lo_a1 = _sel(swap_ll, lo_next, lo), _sel(swap_ll, lo_next_alpha,
                                                  lo_alpha)
    swap_lm = _in_bracket(lo1, midv)
    lo2, lo_a2 = _sel(swap_lm, midv, lo1), _sel(swap_lm, mid_alpha, lo_a1)
    swap_lh = _in_bracket(lo2, hi_next)
    lo3, lo_a3 = _sel(swap_lh, hi_next, lo2), _sel(swap_lh, hi_next_alpha,
                                                   lo_a2)
    swap_lo = swap_ll | swap_lm | swap_lh

    swap_hh = _in_bracket(hi, hi_next)
    hi1, hi_a1 = _sel(swap_hh, hi_next, hi), _sel(swap_hh, hi_next_alpha,
                                                  hi_alpha)
    swap_hm = _in_bracket(hi1, midv)
    hi2, hi_a2 = _sel(swap_hm, midv, hi1), _sel(swap_hm, mid_alpha, hi_a1)
    swap_hl = _in_bracket(hi2, lo_next)
    hi3, hi_a3 = _sel(swap_hl, lo_next, hi2), _sel(swap_hl, lo_next_alpha,
                                                   hi_a2)
    swap_hi = swap_hh | swap_hm | swap_hl

    done_now = ((~swap_lo & ~swap_hi) |
                ((lo3[:, 0] < 0.0) & (lo3[:, 1] < 0.0) &
                 (lo3[:, 1] > -gtol)) |
                ((hi3[:, 0] < 0.0) & (hi3[:, 1] > 0.0) & (hi3[:, 1] < gtol)))
    improved = (lo3[:, 0] < 0.0) | (hi3[:, 0] < 0.0)
    lo_better = lo3[:, 0] < hi3[:, 0]
    best_alpha = torch.where(lo_better, lo_a3, hi_a3)
    best_delta = torch.where(lo_better, lo3[:, 0], hi3[:, 0])
    alpha1 = torch.where(improved, best_alpha, alpha)
    improvement1 = torch.where(improved, -best_delta, improvement)

    # worlds whose loop ended keep their carry
    lo, lo_alpha = _sel(run, lo3, lo), _sel(run, lo_a3, lo_alpha)
    hi, hi_alpha = _sel(run, hi3, hi), _sel(run, hi_a3, hi_alpha)
    alpha = torch.where(run, alpha1, alpha)
    improvement = torch.where(run, improvement1, improvement)
    ls_done = ls_done | (run & done_now)
    it += 1

  alpha = torch.where(initial_converged, lo_alpha_in, alpha)
  improvement = torch.where(initial_converged, -lo_in[:, 0], improvement)
  return alpha, improvement, jv, mv


def _hessian(d, st, state, Jaref):
  """The Newton H = qM + J^T diag(D quad) J, plus the elliptic cone
  curvature (``solver.py:695-697``), world-major and contiguous."""
  J = d.efc_J
  Dq = d.efc_D * (state == _QUADRATIC).to(d.efc_D.dtype)
  # qM may be a transposed view of the mass chain's lanes-last output
  H = d.qM + torch.matmul(J.transpose(1, 2) * Dq[:, None, :], J)
  if st.ell is not None:
    H = H + _cone_hessian(d, st, Jaref, state)
  return H.contiguous()


def first_hessian(m, d):
  """The H of the Newton's first gradient, at the warmstart (or at
  qacc_smooth where the warmstart is off), as ``solve`` forms it."""
  st = _static_tables(m, d.qpos)
  qacc = d.qacc_smooth if m.opt.disableflags & types.DisableBit.WARMSTART \
      else d.qacc_warmstart
  Jaref = _mv(d.efc_J, qacc) - d.efc_aref
  return _hessian(d, st, _update_constraint(d, st, Jaref)[1], Jaref)


def _gradient(m, d, st, Ma, force, state, Jaref):
  """grad and its preconditioned form (``solver.py:682``): H^-1 grad with
  the dense Newton H (plus the elliptic cone curvature, :696-697), or
  M^-1 grad for CG."""
  J = d.efc_J
  qfrc_constraint = _mv(J.transpose(1, 2), force)
  grad = Ma - d.qfrc_smooth - qfrc_constraint
  if m.opt.solver == types.SolverType.CG:
    return grad, klinalg.chol_solve_batched(m, d.qLD, grad), qfrc_constraint
  L = klinalg.chol_batched(m, _hessian(d, st, state, Jaref),
                           jitter=_MINVAL)
  return grad, klinalg.chol_solve_batched(m, L, grad), qfrc_constraint


def _dot(a, b):
  return torch.sum(a * b, dim=-1)


def _polak_ribiere(grad, Mgrad, prev_grad, prev_Mgrad):
  """CG's beta, at least 0 (``solver.py:761-763``)."""
  return torch.clamp(_dot(grad, Mgrad - prev_Mgrad) / torch.clamp(
      _dot(prev_grad, prev_Mgrad), min=_MINVAL), min=0.0)


def solve(m: types.Model, d: types.Data) -> types.Data:
  """Constrained qacc by Newton's method or CG (``solver.py:720``) for
  batched Data after the rows and qacc_smooth."""
  global trips
  W, dt = d.qpos.shape[0], d.qpos.dtype
  cg = m.opt.solver == types.SolverType.CG
  if not cg and m.opt.solver != types.SolverType.NEWTON:
    raise NotImplementedError('the PGS solver is not ported')
  st = _static_tables(m, d.qpos)
  if m.opt.disableflags & types.DisableBit.WARMSTART:
    qacc = d.qacc_smooth
  else:
    qacc = d.qacc_warmstart
  Jaref = _mv(d.efc_J, qacc) - d.efc_aref
  Ma = _mv(d.qM, qacc)
  force, state = _update_constraint(d, st, Jaref)
  grad, Mgrad, _ = _gradient(m, d, st, Ma, force, state, Jaref)
  search = -Mgrad
  prev_grad, prev_Mgrad = grad, Mgrad
  tol = types.world_field(m, 'opt.tolerance')  # each world's (1 or W,)
  rescale = 1.0 / (m.stat.meaninertia * float(m.nv))
  improvement = torch.full((W,), float('inf'), dtype=dt, device=d.qpos.device)
  niter = torch.zeros(W, dtype=torch.int32, device=d.qpos.device)
  done = torch.zeros(W, dtype=torch.bool, device=d.qpos.device)
  conv = torch.zeros_like(done)

  while not host_item(done.all(), 'solver'):
    trips += 1
    live = ~done
    alpha, impr_ls, jv, mv = _linesearch(m, d, st, Ma, Jaref, search, live)
    qacc_n = qacc + alpha[:, None] * search
    Ma_n = Ma + alpha[:, None] * mv
    Jaref_n = Jaref + alpha[:, None] * jv
    force_n, state_n = _update_constraint(d, st, Jaref_n)
    grad_n, Mgrad_n, _ = _gradient(m, d, st, Ma_n, force_n, state_n,
                                   Jaref_n)
    if cg:
      beta = _polak_ribiere(grad_n, Mgrad_n, prev_grad, prev_Mgrad)
      search_n = -Mgrad_n + beta[:, None] * search
      model_improvement = torch.full_like(beta, float('inf'))
    else:
      search_n = -Mgrad_n
      model_improvement = rescale * 0.5 * _dot(grad_n, Mgrad_n)
    niter_n = niter + 1
    grad_norm = rescale * torch.sqrt(torch.clamp(
        torch.sum(grad_n * grad_n, dim=-1), min=0.0))
    impr = rescale * impr_ls
    converged = (impr < tol) | (grad_norm < tol) | (model_improvement < tol)
    # frozen worlds keep their carry
    keep = lambda new, old: _sel(done, old, new)
    qacc, Ma, Jaref = keep(qacc_n, qacc), keep(Ma_n, Ma), \
        keep(Jaref_n, Jaref)
    force, state = keep(force_n, force), keep(state_n, state)
    search = keep(search_n, search)
    prev_grad, prev_Mgrad = keep(grad_n, prev_grad), keep(Mgrad_n,
                                                          prev_Mgrad)
    improvement = keep(impr, improvement)
    niter = keep(niter_n, niter)
    conv = conv | (live & converged)
    done = done | converged | (niter_n >= m.opt.iterations)

  qfrc_constraint = _mv(d.efc_J.transpose(1, 2), force)
  overflow = d.overflow | torch.where(
      conv, 0, int(types.OverflowType.SOLVER)).to(torch.int32)
  return d.replace(qacc=qacc, qacc_warmstart=qacc,
                   qfrc_constraint=qfrc_constraint, efc_force=force,
                   overflow=overflow, solver_niter=niter)
