"""Plain PyTorch Newton solve over one batch of worlds, lanes-last.

Counterpart of ``mujoco_warp_tpu/pallas/solver.py`` ``solve_core`` (:269)
for what the ported steps use: dense rows, pyramidal or frictionless
contacts (no elliptic cones), one-hot ``diag`` rows for joint limits,
``w_eq`` for equality rows and ``w_fri`` / ``fl`` for friction-loss rows
(:321-329, :434, :717-720), with ``_chol_tile`` (:158) and
``_chol_solve_tile`` (:176).  Cholesky-factor reuse is kept: a world whose
constraint state did not flip keeps its factor, which is the exact factor
of its unchanged H.  The loops run until every world is done; done worlds
are frozen, so each world's iterates are its own.

``solve_batched`` is the plain counterpart of the standalone solver kernel
(``pallas/solver.py`` ``solve_batched`` :1145) on world-major Data.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused.lane import MINVAL


def chol_tile(H, nv):
  """Cholesky of (nv, nv, W) by right-looking rank-1 updates; reads only
  the lower triangle.  Pivots are ``rsqrt(max(A_jj, 1e-15))``."""
  A = H
  cols = []
  row = torch.arange(nv, device=H.device)[:, None]
  for j in range(nv):
    pivot = torch.rsqrt(torch.clamp(A[j, j], min=MINVAL))
    col = torch.where(row >= j, A[:, j] * pivot[None], torch.zeros_like(A[:, j]))
    cols.append(col)
    A = A - col[:, None, :] * col[None, :, :]
  return torch.stack(cols, dim=1)


def chol_solve_tile(Lf, b, nv):
  """Solve L Lᵀ x = b, b (nv, W), with ``max(L_jj, 1e-15)`` divisors."""
  r = b
  ys = []
  for j in range(nv):
    yj = r[j] / torch.clamp(Lf[j, j], min=MINVAL)
    ys.append(yj)
    r = r - Lf[:, j] * yj[None]
  r = torch.stack(ys)
  xs = [None] * nv
  for i in reversed(range(nv)):
    xi = r[i] / torch.clamp(Lf[i, i], min=MINVAL)
    xs[i] = xi
    r = r - Lf[i] * xi[None]
  return torch.stack(xs)


def sdiv(a, b):
  """a / b with |b| floored at 1e-15, keeping b's sign."""
  return a / torch.where(torch.abs(b) > MINVAL, b,
                         torch.where(b >= 0, torch.full_like(b, MINVAL),
                                     torch.full_like(b, -MINVAL)))


def solve_core(m, J, D, aref, M, qfrc_smooth, qacc_in, w_eq, tol, ls_tol,
               meaninertia, diag=(), w_fri=None, fl=None):
  """Newton solve.  Returns (qacc (nv, W), force (nefc, W), niter (1, W)
  float).

  J: (ncr, nv, W) dense rows or None; D, aref: (nefc, W) with the
  ``len(diag)`` one-hot rows first; diag: [(dof, sign (1, W))]; w_eq:
  (nefc, 1) marking equality rows, or None; w_fri: (nefc, 1) marking
  friction-loss rows, or None, with fl (nefc, W) their friction loss;
  tol, ls_tol, meaninertia: 0-d float32 tensors.
  """
  nv = m.nv
  nl = len(diag)
  ncr = 0 if J is None else J.shape[0]
  W = qacc_in.shape[-1]
  dt = qacc_in.dtype
  iterations = int(m.opt.iterations)
  ls_iterations = int(m.opt.ls_iterations)
  has_eq = w_eq is not None
  has_fri = w_fri is not None
  # friction rows: linear beyond |Jaref| = fl / D, quadratic inside
  rf = fl / torch.clamp(D, min=MINVAL) if has_fri else None
  rescale = 1.0 / (meaninertia * float(nv))
  by_dof = {}
  for r, (dof, _) in enumerate(diag):
    by_dof.setdefault(dof, []).append(r)

  def mat_vec_M(v):
    return torch.sum(M * v[None], dim=1)

  def J_vec(v):
    parts = [s * v[dof:dof + 1] for dof, s in diag]
    if ncr:
      parts.append(torch.sum(J * v[None], dim=1))
    return torch.cat(parts) if len(parts) > 1 else parts[0]

  def JT_vec(f):
    if ncr:
      dense = torch.sum(J * f[nl:][:, None], dim=0)
    else:
      dense = torch.zeros((nv, W), dtype=dt, device=f.device)
    if nl:
      corr = []
      for d in range(nv):
        rs = by_dof.get(d)
        if not rs:
          corr.append(torch.zeros((1, W), dtype=dt, device=f.device))
          continue
        acc = diag[rs[0]][1] * f[rs[0]:rs[0] + 1]
        for r in rs[1:]:
          acc = acc + diag[r][1] * f[r:r + 1]
        corr.append(acc)
      dense = dense + torch.cat(corr)
    return dense

  def update_constraint(Jaref):
    act = (Jaref < 0.0).to(dt)
    nDJ = -D * Jaref
    f, q = nDJ * act, act
    if has_eq:
      f = torch.where(w_eq > 0, nDJ, f)
      q = torch.where(w_eq > 0, torch.ones_like(act), q)
    if has_fri:
      f_fri = torch.where(Jaref <= -rf, fl, torch.where(Jaref >= rf, -fl, nDJ))
      q_fri = ((Jaref > -rf) & (Jaref < rf)).to(dt)
      f = torch.where(w_fri > 0, f_fri, f)
      q = torch.where(w_fri > 0, q_fri, q)
    return f, q

  tril = torch.tril(torch.ones((nv, nv), dtype=torch.bool, device=M.device))

  def factor(quad):
    """H = M + Jᵀ diag(D·quad) J (lower triangle), then Cholesky."""
    Dq = D * quad
    if ncr:
      JD = J * Dq[nl:][:, None]
      low = torch.einsum('rik,rjk->ijk', JD, J)
    else:
      low = torch.zeros_like(M)
    for i, rs in by_dof.items():
      add = diag[rs[0]][1] ** 2 * Dq[rs[0]]
      for r in rs[1:]:
        add = add + diag[r][1] ** 2 * Dq[r]
      low[i, i] = low[i, i] + add[0]
    return chol_tile(M + torch.where(tril[:, :, None], low, 0.0), nv)

  def linesearch(Ma, Jaref, search, active):
    jv = J_vec(search)
    mv = mat_vec_M(search)
    g1 = torch.sum(search * (Ma - qfrc_smooth), dim=0, keepdim=True)
    g2 = 0.5 * torch.sum(search * mv, dim=0, keepdim=True)
    snorm = torch.sqrt(torch.clamp(
        torch.sum(search * search, dim=0, keepdim=True), min=0.0))
    gtol = torch.clamp(tol * ls_tol * snorm * meaninertia * float(nv),
                       min=1e-6)
    jvD = jv * D
    grad0 = jvD * Jaref
    hess = jv * jvD
    quad0 = 0.5 * D * Jaref * Jaref
    cost0 = quad0 * (Jaref < 0.0).to(dt)
    offset = quad0 - cost0
    if has_fri:
      cf0 = torch.where((-rf < Jaref) & (Jaref < rf), quad0,
                        torch.where(Jaref <= -rf, fl * (-0.5 * rf - Jaref),
                                    fl * (-0.5 * rf + Jaref)))

    def ev(alpha):
      x = Jaref + alpha * jv
      g_eq = grad0 + alpha * hess
      c_eq = 0.5 * alpha * (grad0 + g_eq)
      on = (x < 0.0).to(dt)
      c = torch.where(x < 0.0, c_eq + offset, -cost0)
      g = g_eq * on
      h = hess * on
      if has_eq:
        c = torch.where(w_eq > 0, c_eq, c)
        g = torch.where(w_eq > 0, g_eq, g)
        h = torch.where(w_eq > 0, hess, h)
      if has_fri:
        mid = (-rf < x) & (x < rf)
        lo = x <= -rf
        cf = torch.where(mid, 0.5 * D * x * x,
                         torch.where(lo, fl * (-0.5 * rf - x),
                                     fl * (-0.5 * rf + x)))
        gf = torch.where(mid, jvD * x, torch.where(lo, -fl * jv, fl * jv))
        c = torch.where(w_fri > 0, cf - cf0, c)
        g = torch.where(w_fri > 0, gf, g)
        h = torch.where(w_fri > 0, hess * mid.to(dt), h)
      return (torch.sum(c, 0, keepdim=True) + alpha * alpha * g2 + alpha * g1,
              torch.sum(g, 0, keepdim=True) + 2.0 * alpha * g2 + g1,
              torch.sum(h, 0, keepdim=True) + 2.0 * g2)

    on = (Jaref < 0.0).to(dt)
    g = grad0 * on
    h = hess * on
    if has_eq:
      g = torch.where(w_eq > 0, grad0, g)
      h = torch.where(w_eq > 0, hess, h)
    if has_fri:
      mid = (-rf < Jaref) & (Jaref < rf)
      g_fr = torch.where(mid, grad0,
                         torch.where(Jaref <= -rf, -fl * jv, fl * jv))
      g = torch.where(w_fri > 0, g_fr, g)
      h = torch.where(w_fri > 0, hess * mid.to(dt), h)
    p1 = torch.sum(g, 0, keepdim=True) + g1
    p2 = torch.sum(h, 0, keepdim=True) + 2.0 * g2
    p0c = torch.zeros_like(p1)
    lo_alpha_in = -sdiv(p1, p2)
    li_c, li_g, li_h = ev(lo_alpha_in)
    init_conv = (torch.abs(li_g) < gtol) & (li_c < 0.0)
    lo_less = li_g < p1
    sel = torch.where
    lo = [sel(lo_less, li_c, p0c), sel(lo_less, li_g, p1),
          sel(lo_less, li_h, p2), sel(lo_less, lo_alpha_in, p0c)]
    hi = [sel(lo_less, p0c, li_c), sel(lo_less, p1, li_g),
          sel(lo_less, p2, li_h), sel(lo_less, p0c, lo_alpha_in)]
    alpha = torch.zeros_like(p1)
    improve = torch.zeros_like(p1)
    # done worlds skip the bracket loop (their results are discarded)
    ls_done = init_conv | ~active

    def in_bracket(xg, yg):
      return ((xg < yg) & (yg < 0.0)) | ((xg > yg) & (yg > 0.0))

    def swap3(cur, new):
      sw = in_bracket(cur[1], new[1])
      return [sel(sw, n, c) for c, n in zip(cur, new)], sw

    it = 0
    while it < ls_iterations and not bool(ls_done.all()):
      lo_next_a = lo[3] - sdiv(lo[1], lo[2])
      hi_next_a = hi[3] - sdiv(hi[1], hi[2])
      mid_a = 0.5 * (lo[3] + hi[3])
      ln = list(ev(lo_next_a)) + [lo_next_a]
      hn = list(ev(hi_next_a)) + [hi_next_a]
      md = list(ev(mid_a)) + [mid_a]
      lo_n, s1 = swap3(lo, ln)
      lo_n, s2 = swap3(lo_n, md)
      lo_n, s3 = swap3(lo_n, hn)
      hi_n, t1 = swap3(hi, hn)
      hi_n, t2 = swap3(hi_n, md)
      hi_n, t3 = swap3(hi_n, ln)
      swap_lo, swap_hi = s1 | s2 | s3, t1 | t2 | t3
      lc, lg, hc, hg = lo_n[0], lo_n[1], hi_n[0], hi_n[1]
      done_now = ((~swap_lo & ~swap_hi) |
                  ((lc < 0.0) & (lg < 0.0) & (lg > -gtol)) |
                  ((hc < 0.0) & (hg > 0.0) & (hg < gtol)))
      improved = (lc < 0.0) | (hc < 0.0)
      lo_better = lc < hc
      upd = improved & ~ls_done
      alpha = sel(upd, sel(lo_better, lo_n[3], hi_n[3]), alpha)
      improve = sel(upd, -sel(lo_better, lc, hc), improve)
      lo = [sel(ls_done, o, n) for o, n in zip(lo, lo_n)]
      hi = [sel(ls_done, o, n) for o, n in zip(hi, hi_n)]
      ls_done = ls_done | done_now
      it += 1
    alpha = sel(init_conv, lo_alpha_in, alpha)
    improve = sel(init_conv, -li_c, improve)
    return alpha, improve, jv, mv

  Jaref = J_vec(qacc_in) - aref
  Ma = mat_vec_M(qacc_in)
  force, quad = update_constraint(Jaref)
  Lc = factor(quad)
  grad = Ma - qfrc_smooth - JT_vec(force)
  search = -chol_solve_tile(Lc, grad, nv)
  qacc = qacc_in
  niter = torch.zeros((1, W), dtype=dt, device=qacc.device)
  gnorm0 = rescale * torch.sqrt(torch.clamp(
      torch.sum(grad * grad, 0, keepdim=True), min=0.0))
  done = gnorm0 < tol
  while not bool(done.all()):
    alpha, improve, jv, mv = linesearch(Ma, Jaref, search, ~done)
    qacc_n = qacc + alpha * search
    Ma_n = Ma + alpha * mv
    Jaref_n = Jaref + alpha * jv
    force_n, quad_n = update_constraint(Jaref_n)
    # done worlds keep their mask, so a rebuild reproduces their factor
    quad_k = torch.where(done, quad, quad_n)
    if bool((quad_k != quad).any()):
      Lc = factor(quad_k)
    grad_n = Ma_n - qfrc_smooth - JT_vec(force_n)
    Mgrad_n = chol_solve_tile(Lc, grad_n, nv)
    niter_n = niter + (~done).to(dt)
    gnorm = rescale * torch.sqrt(torch.clamp(
        torch.sum(grad_n * grad_n, 0, keepdim=True), min=0.0))
    impr = rescale * improve
    model_impr = rescale * 0.5 * torch.sum(grad_n * Mgrad_n, 0, keepdim=True)
    done_now = ((impr < tol) | (gnorm < tol) | (model_impr < tol) |
                (niter_n >= iterations))
    keep = lambda new, old: torch.where(done, old, new)
    qacc, Ma, Jaref = keep(qacc_n, qacc), keep(Ma_n, Ma), keep(Jaref_n, Jaref)
    force, search = keep(force_n, force), keep(-Mgrad_n, search)
    niter = niter_n
    quad = quad_k
    done = done | done_now
  return qacc, force, niter


def row_weights(m, device):
  """(w_eq, w_fri): (nefc, 1) float32 masks of the equality and the
  friction-loss rows (``pallas/solver.py`` ``_masks`` :133), each None
  when the model has no such row."""
  t = m.efc.efc_type
  _CT = types.ConstraintType
  out = []
  for sel in (t == _CT.EQUALITY,
              (t == _CT.FRICTION_DOF) | (t == _CT.FRICTION_TENDON)):
    out.append(torch.as_tensor(sel.astype(np.float32), device=device)[:, None]
               if sel.any() else None)
  return tuple(out)


def scalars(m, device):
  """tolerance, ls_tolerance and meaninertia as 0-d float32 tensors."""
  f = lambda x: torch.as_tensor(types.host(x, np.float32), device=device)
  return f(m.opt.tolerance), f(m.opt.ls_tolerance), f(m.stat.meaninertia)


def solve_tiles(m, J, D, aref, fl, M, qfrc_smooth, qacc0):
  """The standalone solve on lanes-last tensors (``pallas/solver.py``
  ``_solve_tiles`` :1091): J (nefc, nv, W), D, aref, fl (nefc, W), M
  (nv, nv, W), qfrc_smooth and qacc0 (nv, W).  Returns qacc (nv, W),
  force (nefc, W), qfrc_constraint (nv, W) and niter (1, W) int32."""
  w_eq, w_fri = row_weights(m, J.device)
  tol, ls_tol, mi = scalars(m, J.device)
  qacc, force, niter = solve_core(m, J, D, aref, M, qfrc_smooth, qacc0, w_eq,
                                  tol, ls_tol, mi, w_fri=w_fri, fl=fl)
  qfrc_c = torch.sum(J * force[:, None, :], dim=0)
  return qacc, force, qfrc_c, niter.to(torch.int32)


def solve_batched(m, d, solve=solve_tiles):
  """The batched Newton solve on world-major Data (``pallas/solver.py``
  ``solve_batched`` :1145): lanes-last transposes, ``solve`` (the plain
  ``solve_tiles`` or the kernel's wrapper), and the SOLVER overflow bit
  where the iteration cap fired (:1196-1204).  Pyramidal and frictionless
  rows only."""
  if m.opt.cone == types.ConeType.ELLIPTIC and m.ncon:
    raise NotImplementedError('elliptic cones (_ell_perm) are not ported')
  from mujoco_warp_tpu_torch.kernels import lanes
  if m.opt.disableflags & types.DisableBit.WARMSTART:
    qacc0 = d.qacc_smooth
  else:
    qacc0 = d.qacc_warmstart
  qacc, force, qfrc_c, niter = solve(
      m, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
      lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
      lanes(qacc0))
  niter_w = niter[0]
  overflow = d.overflow | torch.where(
      niter_w >= int(m.opt.iterations), int(types.OverflowType.SOLVER),
      0).to(torch.int32)
  qacc_w = qacc.T
  return d.replace(qacc=qacc_w, qacc_warmstart=qacc_w,
                   qfrc_constraint=qfrc_c.T, efc_force=force.T,
                   overflow=overflow, solver_niter=niter_w)
