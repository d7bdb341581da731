"""The Newton and CG solves of the general step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/solver.py`` for pyramidal and
frictionless contact, limit, equality and friction-loss rows:
``_static_tables`` (:71), ``_update_constraint`` (:116), ``_eval_delta``
(:222), ``_eval_p0`` (:373), ``_in_bracket`` (:420), ``_linesearch``
(:425), ``_gradient`` (:682) and ``solve`` (:720).  The JAX package runs
it under ``vmap`` for a Newton system beyond nefc * nv 12,000
(``pallas/solver.py`` ``_use_big``) and for the CG solver at every size
(its Pallas solve is Newton-only, :110-112); here every world is a row of
one batch.  Newton: H = qM + J^T diag(D quad) J and the J products are
batched matrix products; H^-1 grad goes through the ``chol_batched``
kernel (jitter 1e-15) and the ``chol_solve`` kernel, as
``_make_chol_solve`` (:534) swaps in the Pallas pair.  CG: M^-1 grad
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
from mujoco_warp_tpu_torch.ops.util import fmask, host_item

_CT = types.ConstraintType
_MINVAL = 1e-15
_SATISFIED, _QUADRATIC, _LINEARNEG, _LINEARPOS = 0, 1, 2, 3

# Newton or CG trips (iterations of the batched loop) of every solve so far
trips = 0


class _Static(NamedTuple):
  """Row classes as float masks (None: the class has no row)."""

  is_eq: torch.Tensor
  is_fri: torch.Tensor
  is_quadlike: torch.Tensor


def _static_tables(m: types.Model, like: torch.Tensor) -> _Static:
  t = m.efc.efc_type
  if np.any(t == _CT.CONTACT_ELLIPTIC):
    raise NotImplementedError('elliptic cones in the large-system Newton')
  quad = np.isin(t, (_CT.LIMIT_JOINT, _CT.LIMIT_TENDON,
                     _CT.CONTACT_FRICTIONLESS, _CT.CONTACT_PYRAMIDAL))
  mask = lambda x: fmask(x.astype(np.float32), like) if np.any(x) else None
  return _Static(mask(t == _CT.EQUALITY),
                 mask((t == _CT.FRICTION_DOF) | (t == _CT.FRICTION_TENDON)),
                 mask(quad))


def _weighted_sum(st: _Static, eq, ql, fr):
  """sum over rows of w_eq eq + w_ql ql + w_fr fr (a class without rows
  adds exact zeros and is left out)."""
  terms = [w * x for w, x in ((st.is_eq, eq), (st.is_quadlike, ql),
                              (st.is_fri, fr)) if w is not None]
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


def _update_constraint(d, st: _Static, Jaref):
  """Row forces and states (``solver.py:116``)."""
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
  return force, state


def _fri_pt(D, fl, jv, jvD, hess, rf, xx):
  mid = (-rf < xx) & (xx < rf)
  c = torch.where(mid, 0.5 * D * xx * xx,
                  torch.where(xx <= -rf, fl * (-0.5 * rf - xx),
                              fl * (-0.5 * rf + xx)))
  g = torch.where(mid, jvD * xx, torch.where(xx <= -rf, -fl * jv, fl * jv))
  h = torch.where(mid, hess, torch.zeros_like(hess))
  return c, g, h


def _eval_delta(d, st, Jaref, jv, quad_gauss, alpha):
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
  g1, g2 = quad_gauss
  cost = _weighted_sum(st, c_eq, c_ql, c_fr) + alpha * alpha * g2 + \
      alpha * g1
  grad = _weighted_sum(st, g_eq, g_ql, g_fr) + 2.0 * alpha * g2 + g1
  hessian = _weighted_sum(st, hess, h_ql, h_fr) + 2.0 * g2
  return torch.stack([cost, grad, hessian], dim=-1)


def _eval_p0(d, st, Jaref, jv, quad_gauss):
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
  g1, g2 = quad_gauss
  grad = _weighted_sum(st, grad0, g_ql, g_fr)
  hessian = _weighted_sum(st, hess, h_ql, h_fr)
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
  snorm = torch.sqrt(torch.clamp(torch.sum(search * search, dim=-1),
                                 min=0.0))
  scale = m.stat.meaninertia * float(m.nv)
  gtol = torch.clamp(m.opt.tolerance * m.opt.ls_tolerance * snorm * scale,
                     min=1e-6)
  ev = lambda a: _eval_delta(d, st, Jaref, jv, quad_gauss, a)
  p0 = _eval_p0(d, st, Jaref, jv, quad_gauss)
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


def _gradient(m, d, Ma, force, state):
  """grad and its preconditioned form (``solver.py:682``): H^-1 grad with
  the dense Newton H, or M^-1 grad for CG."""
  J = d.efc_J
  qfrc_constraint = _mv(J.transpose(1, 2), force)
  grad = Ma - d.qfrc_smooth - qfrc_constraint
  if m.opt.solver == types.SolverType.CG:
    return grad, klinalg.chol_solve_batched(m, d.qLD, grad), qfrc_constraint
  Dq = d.efc_D * (state == _QUADRATIC).to(d.efc_D.dtype)
  # qM may be a transposed view of the mass chain's lanes-last output
  H = (d.qM + torch.matmul(J.transpose(1, 2) * Dq[:, None, :], J)
       ).contiguous()
  L = klinalg.chol_batched(m, H, jitter=_MINVAL)
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
  grad, Mgrad, _ = _gradient(m, d, Ma, force, state)
  search = -Mgrad
  prev_grad, prev_Mgrad = grad, Mgrad
  tol = m.opt.tolerance
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
    grad_n, Mgrad_n, _ = _gradient(m, d, Ma_n, force_n, state_n)
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
