"""Plain PyTorch K4: constraint rows, the Newton solve and the integrator,
lanes-last ``(rows, W)``.

Counterpart of ``mujoco_warp_tpu/pallas/fused.py`` ``_make_k4`` (:1247)
with ``_kbi_lane`` (:1141), ``_eq_joint_tables`` (:1169),
``_limit_tables`` (:1206), ``_k4_has_rows`` (:1237) and
``_quat_integrate_lane`` (:1491).  The CUDA kernel
(``kernels/csrc/k4.cu``) is held against this module.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import lane as L
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.fused.solver_ref import (chol_solve_tile,
                                                    chol_tile, solve_core)

_JT = types.JointType
host = types.host

# compacted contact arrays in K4's argument order, with rows per slot
CON_KEYS = (('dist', 1), ('pos', 3), ('frame', 9), ('im', 1),
            ('friction', 5), ('solref', 2), ('solimp', 5), ('invweight', 1),
            ('mask1', None), ('mask2', None), ('com1', 3), ('com2', 3))


def kbi(tc, dr, i0, i1, i2, i3, i4, pos_imp, h, refsafe):
  """Stiffness, damping and impedance per row (``_kbi_lane``).  All
  arguments are float32 tensors ((), or (1, W))."""
  dmin = torch.clamp(i0, L.MJ_MINIMP, L.MJ_MAXIMP)
  dmax = torch.clamp(i1, L.MJ_MINIMP, L.MJ_MAXIMP)
  width = torch.clamp(i2, min=L.MINVAL)
  mid = torch.clamp(i3, L.MJ_MINIMP, L.MJ_MAXIMP)
  power = torch.clamp(i4, min=1.0)
  tc_eff = torch.maximum(tc, 2.0 * h) if refsafe else tc
  dmax_sq = dmax * dmax
  k = 1.0 / torch.clamp(dmax_sq * tc_eff * tc_eff * dr * dr, min=L.MINVAL)
  b = 2.0 / torch.clamp(dmax * tc_eff, min=L.MINVAL)
  k = torch.where(tc <= 0, -tc / dmax_sq, k)
  b = torch.where(dr <= 0, -dr / dmax, b)
  imp_x = torch.abs(pos_imp) / width
  imp_a = (1.0 / mid ** (power - 1.0)) * imp_x ** power
  imp_b = 1.0 - (1.0 / (1.0 - mid) ** (power - 1.0)) * (1.0 - imp_x) ** power
  imp = dmin + torch.where(imp_x < mid, imp_a, imp_b) * (dmax - dmin)
  imp = torch.minimum(torch.maximum(imp, dmin), dmax)
  imp = torch.where(imp_x > 1.0, dmax, imp)
  return k, b, imp


def eq_joint_tables(m: types.Model):
  """Per-row constants of active JOINT equality rows (``_eq_joint_tables``)."""
  out = []
  if not len(m.efc.joint_id):
    return out
  data, sr, si = host(m.eq_data), host(m.eq_solref), host(m.eq_solimp)
  iw, q0 = host(m.dof_invweight0), host(m.qpos0)
  for eqid in m.efc.joint_id:
    eqid = int(eqid)
    if not bool(m.eq_active0[eqid]):
      continue
    j1, j2 = int(m.eq_obj1id[eqid]), int(m.eq_obj2id[eqid])
    j2c = max(j2, 0)
    out.append(dict(
        qadr1=int(m.jnt_qposadr[j1]), dadr1=int(m.jnt_dofadr[j1]),
        has2=j2 > -1, qadr2=int(m.jnt_qposadr[j2c]),
        dadr2=int(m.jnt_dofadr[j2c]),
        q01=float(q0[int(m.jnt_qposadr[j1])]),
        q02=float(q0[int(m.jnt_qposadr[j2c])]),
        data=tuple(float(x) for x in data[eqid][:5]),
        solref=tuple(float(x) for x in sr[eqid]),
        solimp=tuple(float(x) for x in si[eqid]),
        invw=float(iw[int(m.jnt_dofadr[j1])]) +
        (float(iw[int(m.jnt_dofadr[j2c])]) if j2 > -1 else 0.0)))
  return out


def limit_tables(m: types.Model):
  """Per-row constants of joint-limit rows (``_limit_tables``)."""
  jr, jm = host(m.jnt_range), host(m.jnt_margin)
  sr, si, iw = host(m.jnt_solref), host(m.jnt_solimp), host(m.dof_invweight0)
  out = []
  for j in m.efc.lim_jnt_id:
    j = int(j)
    dadr = int(m.jnt_dofadr[j])
    out.append(dict(
        qadr=int(m.jnt_qposadr[j]), dadr=dadr, lo=float(jr[j, 0]),
        hi=float(jr[j, 1]), margin=float(jm[j]),
        solref=tuple(float(x) for x in sr[j]),
        solimp=tuple(float(x) for x in si[j]), invw=float(iw[dadr])))
  return out


def has_rows(m: types.Model) -> bool:
  """Does K4 assemble any constraint rows?  (``_k4_has_rows``)"""
  return bool(len(m.efc.lim_jnt_id) or eq_joint_tables(m) or
              (m.ncon and m.opt.run_collision_detection))


def quat_integrate(q, w, h):
  """mju_quatIntegrate in lane form: local-frame rotation by w*h."""
  angle = torch.sqrt(torch.clamp(torch.sum(w * w, 0, keepdim=True), min=0.0))
  ok = angle > 1e-9
  axis = w / torch.clamp(angle, min=1e-9)
  half = 0.5 * angle * h
  qrot = L.cat([torch.cos(half), axis * torch.sin(half)])
  qid = torch.zeros_like(qrot)
  qid[0] = 1.0
  return L.qnormalize(L.qmul(q, torch.where(ok, qrot, qid)))


def scalars(m: types.Model, device='cpu'):
  """K4's scalar inputs as 0-d float32 tensors: tolerance, ls_tolerance,
  meaninertia, timestep and 1/impratio."""
  f = lambda x: torch.as_tensor(host(x, np.float32), device=device)
  impratio_inv = 1.0 / torch.clamp(f(m.opt.impratio), min=L.MINVAL)
  return solver_ref.scalars(m, device) + (f(m.opt.timestep), impratio_inv)


def damped(m: types.Model) -> bool:
  """Does K4 (and the general step's Euler) solve (M + h diag(damping))
  for the integrator?  For a batched ``dof_damping`` yes, unless a flag
  says no: JAX takes that branch where the damping is a tracer
  (``forward.py:544-545``), which is right for every value, and a host
  read of the per-world damping every step would wait for the card."""
  dsbl = m.opt.disableflags
  any_damping = 'dof_damping' in m.batch_fields or bool(
      np.any(host(m.dof_damping, np.float32) > 0))
  if m.opt.integrator == types.IntegratorType.IMPLICITFAST:
    # within the fused gate (M - h qDeriv) is exactly M + h diag(damping)
    return not (dsbl & types.DisableBit.DAMPER) and any_damping
  return (not (dsbl & (types.DisableBit.EULERDAMP | types.DisableBit.DAMPER))
          and any_damping)


def rows(m: types.Model, qpos, qvel, cdof, con):
  """Constraint rows in solve order [limits | equality | contacts].

  Returns (J (ncr, nv, W) dense rows or None, D (nrow, W), aref (nrow, W),
  diag [(dof, sign (1, W))] of the one-hot limit rows, w_eq (nrow, 1) or
  None)."""
  nv, W = m.nv, qpos.shape[-1]
  dt, dev = qpos.dtype, qpos.device
  _, _, _, h, ir = scalars(m, dev)
  refsafe = not (m.opt.disableflags & types.DisableBit.REFSAFE)
  f = lambda x: torch.tensor(x, dtype=dt, device=dev)
  J_rows, D_rows, aref_rows, diag_rows = [], [], [], []
  eq_D, eq_aref = [], []

  def onehot(val, idx):
    out = torch.zeros((nv, W), dtype=dt, device=dev)
    out[idx:idx + 1] = val
    return out

  for t in eq_joint_tables(m):
    q1 = qpos[t['qadr1']:t['qadr1'] + 1]
    d0, d1, d2, d3, d4 = t['data']
    if t['has2']:
      dif = qpos[t['qadr2']:t['qadr2'] + 1] - t['q02']
      rhs = d0 + dif * (d1 + dif * (d2 + dif * (d3 + dif * d4)))
      deriv2 = d1 + dif * (2.0 * d2 + dif * (3.0 * d3 + dif * 4.0 * d4))
      pos = q1 - t['q01'] - rhs
      vel = qvel[t['dadr1']:t['dadr1'] + 1] - \
          deriv2 * qvel[t['dadr2']:t['dadr2'] + 1]
      Jrow = onehot(torch.ones((1, W), dtype=dt, device=dev), t['dadr1']) + \
          onehot(-deriv2, t['dadr2'])
    else:
      pos = q1 - t['q01'] - d0
      vel = qvel[t['dadr1']:t['dadr1'] + 1]
      Jrow = onehot(torch.ones((1, W), dtype=dt, device=dev), t['dadr1'])
    k, b, imp = kbi(f(t['solref'][0]), f(t['solref'][1]),
                    *[f(x) for x in t['solimp']], pos, h, refsafe)
    J_rows.append(Jrow)
    eq_D.append(1.0 / torch.clamp(t['invw'] * (1.0 - imp) / imp, min=L.MINVAL))
    eq_aref.append(-k * imp * pos - b * vel)

  for t in limit_tables(m):
    q = qpos[t['qadr']:t['qadr'] + 1]
    dmin_, dmax_ = q - t['lo'], t['hi'] - q
    pos = torch.minimum(dmin_, dmax_) - t['margin']
    active = (pos < 0.0).to(dt)
    sign = torch.where(dmin_ < dmax_, 1.0, -1.0).to(dt)
    vel = sign * qvel[t['dadr']:t['dadr'] + 1]
    k, b, imp = kbi(f(t['solref'][0]), f(t['solref'][1]),
                    *[f(x) for x in t['solimp']], pos, h, refsafe)
    D = 1.0 / torch.clamp(t['invw'] * (1.0 - imp) / imp, min=L.MINVAL)
    diag_rows.append((t['dadr'], sign * active))
    D_rows.append(D * active)
    aref_rows.append((-k * imp * pos - b * vel) * active)
  D_rows += eq_D
  aref_rows += eq_aref

  if con is not None and m.ncon and m.opt.run_collision_detection:
    cdof3 = cdof.reshape(nv, 6, W)
    ang = [cdof3[:, k] for k in range(3)]
    lin = [cdof3[:, 3 + k] for k in range(3)]
    fri, sr, si, iwv = (con['friction'], con['solref'], con['solimp'],
                        con['invweight'])
    for s in range(m.ncon):
      dim = int(m.con_dim[s])
      d_s, im_s = con['dist'][s:s + 1], con['im'][s:s + 1]
      active = (d_s < im_s).to(dt)
      cp = d_s - im_s
      fr = con['frame'][9 * s:9 * s + 9]
      p_s = con['pos'][3 * s:3 * s + 3]
      m1 = con['mask1'][s * nv:(s + 1) * nv]
      m2 = con['mask2'][s * nv:(s + 1) * nv]
      o1 = p_s - con['com1'][3 * s:3 * s + 3]
      o2 = p_s - con['com2'][3 * s:3 * s + 3]
      dm = m2 - m1

      def axis_row(t):
        lt = lin[0] * t[0:1] + lin[1] * t[1:2] + lin[2] * t[2:3]
        u1, u2 = L.cross(o1, t), L.cross(o2, t)
        au1 = ang[0] * u1[0:1] + ang[1] * u1[1:2] + ang[2] * u1[2:3]
        au2 = ang[0] * u2[0:1] + ang[1] * u2[1:2] + ang[2] * u2[2:3]
        return dm * lt + m2 * au2 - m1 * au1

      def rot_row(t):
        return dm * (ang[0] * t[0:1] + ang[1] * t[1:2] + ang[2] * t[2:3])

      Jn = axis_row(fr[0:3])
      veln = torch.sum(Jn * qvel, 0, keepdim=True)
      if dim == 1:
        rows = [(Jn, veln)]
        iw = iwv[s:s + 1]
      else:
        dirs = [axis_row(fr[3:6]), axis_row(fr[6:9])]
        if dim >= 4:
          dirs.append(rot_row(fr[0:3]))
        if dim == 6:
          dirs += [rot_row(fr[3:6]), rot_row(fr[6:9])]
        rows = []
        for fi, Jd in enumerate(dirs):
          fc = fri[5 * s + fi:5 * s + fi + 1]
          veld = torch.sum(Jd * qvel, 0, keepdim=True)
          rows.append((Jn + fc * Jd, veln + fc * veld))
          rows.append((Jn - fc * Jd, veln - fc * veld))
        f0, iw0 = fri[5 * s:5 * s + 1], iwv[s:s + 1]
        iw = (iw0 + f0 * f0 * iw0) * 2.0 * f0 * f0 * ir
      k, b, imp = kbi(sr[2 * s:2 * s + 1], sr[2 * s + 1:2 * s + 2],
                      *[si[5 * s + i:5 * s + i + 1] for i in range(5)],
                      cp, h, refsafe)
      D = active / torch.clamp(iw * (1.0 - imp) / imp, min=L.MINVAL)
      for r, vel in rows:
        J_rows.append(r * active)
        D_rows.append(D)
        aref_rows.append((-k * imp * cp - b * vel) * active)

  if not (J_rows or diag_rows):
    return None, None, None, [], None
  w_eq = None
  if eq_D:  # packed rows [diag | eq | contacts]
    w_eq = torch.zeros((len(D_rows), 1), dtype=dt, device=dev)
    w_eq[len(diag_rows):len(diag_rows) + len(eq_D)] = 1.0
  return (torch.stack(J_rows) if J_rows else None, L.cat(D_rows),
          L.cat(aref_rows), diag_rows, w_eq)


def k4(m: types.Model, qM, qLD, qfs, ws, qvel, qpos, cdof, con):
  """Plain K4.  ``con``: dict of compacted contact arrays (CON_KEYS) or
  None.  Returns (qpos, qvel, warmstart, qacc, niter (1, W) int32)."""
  nv, W = m.nv, qpos.shape[-1]
  dt, dev = qpos.dtype, qpos.device
  tol, lstol, mi, h, _ = scalars(m, dev)
  qM3 = qM.reshape(nv, nv, W)
  J, Dv, aref, diag, w_eq = rows(m, qpos, qvel, cdof, con)
  if Dv is not None:
    qacc, _, niter = solve_core(m, J, Dv, aref, qM3, qfs, ws, w_eq, tol,
                                lstol, mi, diag=diag)
  else:
    qacc = chol_solve_tile(qLD.reshape(nv, nv, W), qfs, nv)
    niter = torch.zeros((1, W), dtype=dt, device=dev)

  if damped(m):
    damp = torch.as_tensor(host(m.dof_damping, np.float32), device=dev)
    eye = torch.eye(nv, dtype=dt, device=dev)
    Ld = chol_tile(qM3 + eye[:, :, None] * (h * damp)[:, None, None], nv)
    qacc_i = chol_solve_tile(Ld, torch.sum(qM3 * qacc[None], dim=1), nv)
  else:
    qacc_i = qacc
  qvel_n = qvel + h * qacc_i

  qrows = [None] * m.nq
  for j in range(m.njnt):
    jt, qadr, dadr = (int(m.jnt_type[j]), int(m.jnt_qposadr[j]),
                      int(m.jnt_dofadr[j]))
    if jt == _JT.FREE:
      for a in range(3):
        qrows[qadr + a] = qpos[qadr + a:qadr + a + 1] + \
            h * qvel_n[dadr + a:dadr + a + 1]
      qn = quat_integrate(L.qnormalize(qpos[qadr + 3:qadr + 7]),
                          qvel_n[dadr + 3:dadr + 6], h)
      for a in range(4):
        qrows[qadr + 3 + a] = qn[a:a + 1]
    else:  # HINGE / SLIDE
      qrows[qadr] = qpos[qadr:qadr + 1] + h * qvel_n[dadr:dadr + 1]
  return (L.cat(qrows), qvel_n, qacc, qacc_i, niter.to(torch.int32))
