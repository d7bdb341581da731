"""Plain PyTorch Newton solve over one batch of worlds, lanes-last.

Counterpart of ``mujoco_warp_tpu/pallas/solver.py`` ``solve_core`` (:269)
for what the ported steps use: dense rows, frictionless, pyramidal and
elliptic contacts, one-hot ``diag`` rows for joint limits, ``w_eq`` for
equality rows and ``w_fri`` / ``fl`` for friction-loss rows (:321-329,
:434, :717-720), with ``_chol_tile`` (:158) and ``_chol_solve_tile``
(:176).  Elliptic contacts (``ell``) follow the JAX text: their zones and
forces (:445-486), the middle-zone cone blocks of H (``_cone_col``
:499-519), the per-contact linesearch coefficients (:619-651) and
segments (``_ell_ev`` :653-696, ``_ell_p0`` :698-713).  The rows stay in
the model's order: each condim group gathers its contacts' rows by index
where the JAX kernel permutes them into contiguous blocks (``_ell_perm``
:70).  Cholesky-factor reuse is kept without elliptic rows: a world whose
constraint state did not flip keeps its factor, which is the exact factor
of its unchanged H; with elliptic rows H is rebuilt every iteration
(:969), since the middle-zone blocks vary with Jaref.  The loops run until
every world is done; done worlds are frozen, so each world's iterates are
its own.

``solve_batched`` is the plain counterpart of the standalone solver kernel
(``pallas/solver.py`` ``solve_batched`` :1145) on world-major Data.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused.lane import MINVAL
from mujoco_warp_tpu_torch.kernels import TableCache


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


def ell_groups(m: types.Model):
  """The elliptic contacts by condim, [(dim, contact ids (n,), rows (n,
  dim))] in the model's row order (the groups of ``pallas/solver.py``
  ``_ell_perm`` :70); empty without elliptic contacts."""
  if not m.ncon or m.opt.cone != types.ConeType.ELLIPTIC:
    return []
  dims = np.asarray(m.con_dim)
  adr = np.asarray(m.con_efc_address)
  ell = np.nonzero(dims > 1)[0]
  out = []
  for d0 in sorted(set(int(x) for x in dims[ell])):
    ids = ell[dims[ell] == d0]
    out.append((d0, ids, adr[ids][:, None] + np.arange(d0)))
  return out


def _scale_tables(m: types.Model, device):
  """Per row of the model: the column of the flattened (ncon * 5)
  friction table its scale comes from, and whether it is an elliptic
  normal row or friction row (float masks)."""
  src = np.zeros(m.nefc, np.int64)
  normal = np.zeros(m.nefc, np.float32)
  fric = np.zeros(m.nefc, np.float32)
  for d0, ids, rows in ell_groups(m):
    src[rows] = 5 * ids[:, None] + np.maximum(np.arange(d0) - 1, 0)
    normal[rows[:, 0]] = 1.0
    fric[rows[:, 1:]] = 1.0
  return tuple(torch.as_tensor(x, device=device) for x in (src, normal, fric))


_SCALE_TABLES = TableCache(_scale_tables)


def ell_scales(m: types.Model, friction):
  """(nefc, W) per-row scales of the elliptic rows from the contacts'
  friction (W, ncon, 5): [mu mu_scale, f_1 .. f_{dim-1}] per contact with
  mu_scale = 1 / sqrt(impratio) (``pallas/solver.py`` :1177-1185), 0 on
  the other rows; the row tables go to the device once per model."""
  src, normal, fric = _SCALE_TABLES.get(m, friction.device)
  mu_scale = 1.0 / torch.sqrt(torch.clamp(
      m.opt.impratio.to(friction.dtype), min=MINVAL))
  w = normal.to(friction.dtype) * mu_scale + fric.to(friction.dtype)
  return (friction.reshape(friction.shape[0], -1)[:, src] * w).T.contiguous()


def ell_zone(N, TT, mu):
  """The zones of elliptic contacts (``pallas/solver.py`` :454-459) from
  N = mu Jaref_n and TT = |u|^2: (top, bottom, middle) boolean masks."""
  T = torch.sqrt(torch.clamp(TT, min=0.0))
  top = (N >= mu * T) | ((TT <= 0.0) & (N >= 0.0))
  bottom = ((mu * N + T <= 0.0) | ((TT <= 0.0) & (N < 0.0))) & ~top
  return top, bottom, ~top & ~bottom


def ell_zone_counts(m: types.Model, J, D, aref, qacc, s) -> dict:
  """How many live elliptic contacts (D > 0 on the normal row) of all
  worlds sit in each zone at ``qacc`` (nv, W), lanes-last J (nefc, nv,
  W), D, aref and s (nefc, W)."""
  jaref = torch.sum(J * qacc[None], dim=1) - aref
  out = {'top': 0, 'middle': 0, 'bottom': 0}
  for _, _, rows in ell_groups(m):
    ix = torch.as_tensor(rows, device=J.device)
    su = jaref[ix] * s[ix]
    top, bottom, mid = ell_zone(su[:, 0],
                                torch.sum(su[:, 1:] * su[:, 1:], dim=1),
                                s[ix][:, 0])
    live = D[ix][:, 0] > 0.0
    out['top'] += int((top & live).sum())
    out['middle'] += int((mid & live).sum())
    out['bottom'] += int((bottom & live).sum())
  return out


def solve_core(m, J, D, aref, M, qfrc_smooth, qacc_in, w_eq, tol, ls_tol,
               meaninertia, diag=(), w_fri=None, fl=None, ell=None):
  """Newton solve.  Returns (qacc (nv, W), force (nefc, W), niter (1, W)
  float).

  J: (ncr, nv, W) dense rows or None; D, aref: (nefc, W) with the
  ``len(diag)`` one-hot rows first; diag: [(dof, sign (1, W))]; w_eq:
  (nefc, 1) marking equality rows, or None; w_fri: (nefc, 1) marking
  friction-loss rows, or None, with fl (nefc, W) their friction loss;
  tol, ls_tol, meaninertia: 0-d float32 tensors; ell: (``ell_groups``,
  ``ell_scales``) of the elliptic contacts, or None (not with ``diag``).
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
  egroups = ell[0] if ell else []
  if egroups:
    assert nl == 0, 'elliptic rows need the dense layout'
    eix = [torch.as_tensor(rows, device=D.device) for _, _, rows in egroups]
    svals = [ell[1][ix] for ix in eix]  # (n, dim, W)
    Dells = [D[ix] for ix in eix]
    is_ell = torch.zeros((D.shape[0], 1), dtype=torch.bool, device=D.device)
    for ix in eix:
      is_ell[ix.reshape(-1)] = True
    head = lambda x: torch.where(is_ell, torch.zeros_like(x), x)

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
    if not egroups:
      return f, q, None
    # elliptic contacts: zones per contact from N = mu Jaref[normal] and
    # T = |u|, u_j = f_j Jaref[j] (pallas/solver.py :445-486)
    f, q, cone = f.clone(), q.clone(), []
    for g, ix in enumerate(eix):
      jar, s, Dc = Jaref[ix], svals[g], Dells[g]
      mu = s[:, 0]
      su = jar * s
      N = su[:, 0]
      TT = torch.sum(su[:, 1:] * su[:, 1:], dim=1)
      T = torch.sqrt(torch.clamp(TT, min=0.0))
      top, bottom, mid = ell_zone(N, TT, mu)
      dm = sdiv(Dc[:, 0], mu * mu * (1.0 + mu * mu))
      nmt = N - mu * T
      f_normal = -dm * nmt * mu
      f_tan = -sdiv(f_normal, T)[:, None] * su[:, 1:] * s[:, 1:]
      f_quad = -Dc * jar
      f_cone = torch.cat([f_normal[:, None], f_tan], dim=1)
      f[ix] = torch.where(top[:, None], torch.zeros_like(f_quad),
                          torch.where(bottom[:, None], f_quad, f_cone))
      q[ix] = bottom[:, None].to(dt).expand(jar.shape)
      # middle-zone cone block C (dim x dim, symmetric) with q_j = u_j f_j:
      # C00 = mu^2, C0j = -(mu^2 / t) q_j,
      # Cjk = (mu N / t^3) q_j q_k + (mu^2 - N mu / t) f_j^2 delta_jk
      w = dm * mid.to(dt) * (dm != 0.0).to(dt)
      t = torch.clamp(T, min=MINVAL)
      ttt = torch.clamp(t * t * t, min=MINVAL)
      qv = su[:, 1:] * s[:, 1:]
      cone.append(dict(C00=w * mu * mu, C0=(-w * mu * mu / t)[:, None] * qv,
                       pp=w * mu * N / ttt, dg=w * (mu * mu - N * mu / t),
                       qv=qv, f2=s[:, 1:] * s[:, 1:]))
    return f, q, cone

  tril = torch.tril(torch.ones((nv, nv), dtype=torch.bool, device=M.device))

  def factor(quad, cone=None):
    """H = M + Jᵀ diag(D·quad) J (+ the middle-zone cone blocks, lower
    triangle), then Cholesky."""
    Dq = D * quad
    if ncr:
      JD = J * Dq[nl:][:, None]
      low = torch.einsum('rik,rjk->ijk', JD, J)
    else:
      low = torch.zeros_like(M)
    for ix, c in zip(eix if egroups else (), cone or ()):
      # C times the contact's rows (_cone_col :499-519), then against J
      Jc = J[ix]  # (n, dim, nv, W)
      pJ = torch.sum(c['qv'][:, :, None] * Jc[:, 1:], dim=1)
      r0c = c['C00'][:, None] * Jc[:, 0] + torch.sum(
          c['C0'][:, :, None] * Jc[:, 1:], dim=1)
      rjc = (c['C0'][:, :, None] * Jc[:, 0:1] +
             c['pp'][:, None, None] * c['qv'][:, :, None] * pJ[:, None] +
             c['dg'][:, None, None] * c['f2'][:, :, None] * Jc[:, 1:])
      CJ = torch.cat([r0c[:, None], rjc], dim=1)
      low = low + torch.einsum('nrik,nrjk->ijk', CJ, Jc)
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

    # per-elliptic-contact coefficients and the zones at alpha = 0
    # (pallas/solver.py :619-651)
    ecoef = []
    for g, ix in enumerate(eix if egroups else ()):
      jar, jvc, sc, Dc = Jaref[ix], jv[ix], svals[g], Dells[g]
      mu = sc[:, 0]
      DJ = Dc * jar
      q0e = torch.sum(0.5 * jar * DJ, dim=1)
      q1e = torch.sum(jvc * DJ, dim=1)
      q2e = torch.sum(0.5 * jvc * Dc * jvc, dim=1)
      su, sv = jar * sc, jvc * sc
      u0, v0 = su[:, 0], sv[:, 0]
      uu = torch.sum(su[:, 1:] * su[:, 1:], dim=1)
      uv = torch.sum(su[:, 1:] * sv[:, 1:], dim=1)
      vv = torch.sum(sv[:, 1:] * sv[:, 1:], dim=1)
      dm = sdiv(Dc[:, 0], mu * mu * (1.0 + mu * mu))
      T0 = torch.sqrt(torch.clamp(uu, min=0.0))
      no_t = uu <= 0.0
      sat = (no_t & (u0 >= 0.0)) | (~no_t & (u0 >= mu * T0))
      qz = (no_t & (u0 < 0.0)) | (~no_t & (mu * u0 + T0 <= 0.0))
      s0_quad = (qz & ~sat).to(dt)
      s0_cone = (~sat & ~qz).to(dt)
      r0r = u0 - mu * T0
      cost0e = (1.0 - sat.to(dt)) * torch.where(qz & ~sat, q0e,
                                                0.5 * dm * r0r * r0r)
      ecoef.append(dict(mu=mu, q1=q1e, q2=q2e, u0=u0, v0=v0, uu=uu, uv=uv,
                        vv=vv, dm=dm, T0=T0, cost0=cost0e, r0=s0_cone * r0r,
                        s0_quad=s0_quad, s0_cone=s0_cone))

    def ell_ev(alpha):
      """Per-contact elliptic (cost change, slope, curvature) sums
      (``_ell_ev`` :653-696)."""
      cs = gs = hs = 0.0
      for c in ecoef:
        mu, dm = c['mu'], c['dm']
        N = c['u0'] + alpha * c['v0']
        Tsqr_delta = alpha * (2.0 * c['uv'] + alpha * c['vv'])
        Tsqr = c['uu'] + Tsqr_delta
        T = torch.sqrt(torch.clamp(Tsqr, min=0.0))
        no_t = Tsqr <= 0.0
        in_quad = (no_t & (N < 0.0)) | (~no_t & (mu * N + T <= 0.0))
        in_top = ~no_t & (N >= mu * T)
        in_mid = ~no_t & ~in_top & ~in_quad
        aq2 = alpha * c['q2']
        boundary = mu * N + T
        gap = 0.5 * dm * boundary * boundary
        c_q = alpha * (aq2 + c['q1']) + (
            c['s0_cone'] * 0.5 * dm * (mu * c['u0'] + c['T0']) ** 2 +
            (1.0 - c['s0_cone'] - c['s0_quad']) * 0.5 * dm *
            (1.0 + mu * mu) * (N * N + torch.clamp(Tsqr, min=0.0)))
        g_q = 2.0 * aq2 + c['q1']
        h_q = 2.0 * c['q2']
        T_inv = 1.0 / torch.clamp(T, min=MINVAL)
        T1 = (c['uv'] + alpha * c['vv']) * T_inv
        T2 = (c['vv'] - T1 * T1) * T_inv
        r = N - mu * T
        r1 = c['v0'] - mu * T1
        T_delta = Tsqr_delta / torch.clamp(T + c['T0'], min=MINVAL)
        r_delta = alpha * c['v0'] - mu * T_delta
        c_m = (c['s0_cone'] * 0.5 * dm * r_delta *
               (2.0 * c['r0'] + r_delta) +
               c['s0_quad'] * (alpha * (aq2 + c['q1']) - gap) +
               (1.0 - c['s0_cone'] - c['s0_quad']) * 0.5 * dm * r * r)
        g_m = dm * r * r1
        h_m = dm * (r1 * r1 + r * (-mu * T2))
        zero = torch.zeros_like(N)
        c_e = torch.where(in_quad, c_q, torch.where(in_mid, c_m, -c['cost0']))
        g_e = torch.where(in_quad, g_q, torch.where(in_mid, g_m, zero))
        h_e = torch.where(in_quad, h_q, torch.where(in_mid, h_m, zero))
        cs = cs + torch.sum(c_e, 0, keepdim=True)
        gs = gs + torch.sum(g_e, 0, keepdim=True)
        hs = hs + torch.sum(h_e, 0, keepdim=True)
      return cs, gs, hs

    def ell_p0():
      """The elliptic terms of the slope and curvature at alpha = 0
      (``_ell_p0`` :698-713)."""
      gs = hs = 0.0
      for c in ecoef:
        mu, dm = c['mu'], c['dm']
        T0_inv = 1.0 / torch.clamp(c['T0'], min=MINVAL)
        T1 = c['uv'] * T0_inv
        T2 = (c['vv'] - T1 * T1) * T0_inv
        r1 = c['v0'] - mu * T1
        g_m = dm * c['r0'] * r1
        h_m = dm * (r1 * r1 - mu * c['r0'] * T2)
        g_e = c['s0_quad'] * c['q1'] + c['s0_cone'] * g_m
        h_e = c['s0_quad'] * 2.0 * c['q2'] + c['s0_cone'] * h_m
        gs = gs + torch.sum(g_e, 0, keepdim=True)
        hs = hs + torch.sum(h_e, 0, keepdim=True)
      return gs, hs

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
      if not egroups:
        return (torch.sum(c, 0, keepdim=True) + alpha * alpha * g2 +
                alpha * g1,
                torch.sum(g, 0, keepdim=True) + 2.0 * alpha * g2 + g1,
                torch.sum(h, 0, keepdim=True) + 2.0 * g2)
      ce, ge, he = ell_ev(alpha)
      return (torch.sum(head(c), 0, keepdim=True) + alpha * alpha * g2 +
              alpha * g1 + ce,
              torch.sum(head(g), 0, keepdim=True) + 2.0 * alpha * g2 + g1 +
              ge,
              torch.sum(head(h), 0, keepdim=True) + 2.0 * g2 + he)

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
    if egroups:
      ge, he = ell_p0()
      p1 = torch.sum(head(g), 0, keepdim=True) + g1 + ge
      p2 = torch.sum(head(h), 0, keepdim=True) + 2.0 * g2 + he
    else:
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
  force, quad, cone = update_constraint(Jaref)
  Lc = factor(quad, cone)
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
    force_n, quad_n, cone_n = update_constraint(Jaref_n)
    if egroups:
      # the cone blocks vary with Jaref: no factor reuse (:969)
      quad_k = quad_n
      Lc = factor(quad_n, cone_n)
    else:
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
  """tolerance, ls_tolerance and meaninertia as 0-d tensors of the
  Model's dtype."""
  f = lambda x: torch.as_tensor(types.host(x, types.np_float(x.dtype)),
                               device=device)
  return f(m.opt.tolerance), f(m.opt.ls_tolerance), f(m.stat.meaninertia)


def solve_tiles(m, J, D, aref, fl, M, qfrc_smooth, qacc0, s=None):
  """The standalone solve on lanes-last tensors (``pallas/solver.py``
  ``_solve_tiles`` :1091): J (nefc, nv, W), D, aref, fl (nefc, W), M
  (nv, nv, W), qfrc_smooth and qacc0 (nv, W), and for a model with
  elliptic contacts their row scales s (nefc, W) (``ell_scales``).
  Returns qacc (nv, W), force (nefc, W), qfrc_constraint (nv, W) and
  niter (1, W) int32."""
  w_eq, w_fri = row_weights(m, J.device)
  tol, ls_tol, mi = scalars(m, J.device)
  groups = ell_groups(m)
  if groups and s is None:
    raise ValueError('elliptic contacts need their row scales s')
  qacc, force, niter = solve_core(m, J, D, aref, M, qfrc_smooth, qacc0, w_eq,
                                  tol, ls_tol, mi, w_fri=w_fri, fl=fl,
                                  ell=(groups, s) if groups else None)
  qfrc_c = torch.sum(J * force[:, None, :], dim=0)
  return qacc, force, qfrc_c, niter.to(torch.int32)


def solve_batched(m, d, solve=solve_tiles):
  """The batched Newton solve on world-major Data (``pallas/solver.py``
  ``solve_batched`` :1145): lanes-last transposes, the elliptic rows'
  scales from ``d.contact.friction`` (:1167-1185), ``solve`` (the plain
  ``solve_tiles`` or the kernel's wrapper), and the SOLVER overflow bit
  where the iteration cap fired (:1196-1204).  efc_force comes back in
  the model's row order."""
  from mujoco_warp_tpu_torch.kernels import lanes
  if m.opt.disableflags & types.DisableBit.WARMSTART:
    qacc0 = d.qacc_smooth
  else:
    qacc0 = d.qacc_warmstart
  qacc, force, qfrc_c, niter = solve(
      m, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
      lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
      lanes(qacc0),
      ell_scales(m, d.contact.friction) if ell_groups(m) else None)
  niter_w = niter[0]
  overflow = d.overflow | torch.where(
      niter_w >= int(m.opt.iterations), int(types.OverflowType.SOLVER),
      0).to(torch.int32)
  qacc_w = qacc.T
  return d.replace(qacc=qacc_w, qacc_warmstart=qacc_w,
                   qfrc_constraint=qfrc_c.T, efc_force=force.T,
                   overflow=overflow, solver_niter=niter_w)
