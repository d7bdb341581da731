"""Plain PyTorch K1: forward kinematics, com quantities, geom frames, the
lane narrowphase and the mass chain, lanes-last ``(rows, W)``.

Counterpart of ``mujoco_warp_tpu/pallas/fused.py`` ``_make_k1`` (:986)
with ``_fk`` (:620), ``_com_quantities`` (:684), ``_narrowphase`` (:339)
and ``mujoco_warp_tpu/pallas/smooth.py`` ``mass_chain_core`` (:43).  The
CUDA kernel (``kernels/csrc/k1.cu``) is held against this module.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import lane as L
from mujoco_warp_tpu_torch.fused.solver_ref import chol_tile

_JT = types.JointType
_GT = types.GeomType
host = types.host


def fk(m: types.Model, qpos):
  """Per-body xpos/xquat lists and per-joint xanchor/xaxis lists."""
  body_pos, body_quat = host(m.body_pos), host(m.body_quat)
  jnt_pos, jnt_axis, qpos0 = host(m.jnt_pos), host(m.jnt_axis), host(m.qpos0)
  W = qpos.shape[-1]
  kw = dict(dtype=qpos.dtype, device=qpos.device)
  z3 = torch.zeros((3, W), **kw)
  id4 = L.cat([torch.ones((1, W), **kw), torch.zeros((3, W), **kw)])
  xpos = [z3] + [None] * (m.nbody - 1)
  xquat = [id4] + [None] * (m.nbody - 1)
  xanchor = [None] * m.njnt
  xaxis = [None] * m.njnt
  for b in [int(b) for ids in m.tree.body_levels for b in ids]:
    p = int(m.body_parentid[b])
    pos = L.add(xpos[p], L.qrot_const(body_pos[b], xquat[p]))
    quat = L.qmul_const(xquat[p], body_quat[b])
    for k in range(int(m.body_jntnum[b])):
      j = int(m.body_jntadr[b]) + k
      jt = int(m.jnt_type[j])
      qadr = int(m.jnt_qposadr[j])
      if jt == _JT.FREE:
        pos = qpos[qadr:qadr + 3]
        quat = L.qnormalize(qpos[qadr + 3:qadr + 7])
        xanchor[j] = pos
        xaxis[j] = L.cat([torch.zeros((2, W), **kw), torch.ones((1, W), **kw)])
      elif jt == _JT.SLIDE:
        axis = L.mat_vec_const(L.q2mat(quat), jnt_axis[j])
        anchor = L.add(pos, L.qrot_const(jnt_pos[j], quat))
        pos = pos + axis * (qpos[qadr:qadr + 1] - float(qpos0[qadr]))
        xanchor[j] = anchor
        xaxis[j] = axis
      else:  # HINGE
        anchor = L.add(pos, L.qrot_const(jnt_pos[j], quat))
        axis = L.mat_vec_const(L.q2mat(quat), jnt_axis[j])
        half = 0.5 * (qpos[qadr:qadr + 1] - float(qpos0[qadr]))
        s = torch.sin(half)
        ax = jnt_axis[j]
        qloc = L.cat([torch.cos(half), s * float(ax[0]), s * float(ax[1]),
                      s * float(ax[2])])
        quat = L.qmul(quat, qloc)
        qp = L.qrot_const(jnt_pos[j], quat)
        pos = anchor - qp if qp is not None else anchor
        xanchor[j] = anchor
        xaxis[j] = axis
    xpos[b] = pos
    xquat[b] = L.qnormalize(quat)
  return xpos, xquat, xanchor, xaxis


def com_quantities(m: types.Model, xpos, xquat, xanchor, xaxis):
  """subtree_com list (3, W), cinert list (36, W), cdof list (6, W)."""
  nb = m.nbody
  mass, subtreemass = host(m.body_mass), host(m.body_subtreemass)
  inertia = host(m.body_inertia)
  body_ipos, body_iquat = host(m.body_ipos), host(m.body_iquat)
  W = xpos[0].shape[-1]
  kw = dict(dtype=xpos[0].dtype, device=xpos[0].device)
  zero = torch.zeros((1, W), **kw)
  xipos = [L.add(xpos[b], L.qrot_const(body_ipos[b], xquat[b]))
           for b in range(nb)]
  ximat = [L.q2mat(L.qmul_const(xquat[b], body_iquat[b])) for b in range(nb)]

  subtree_com = []
  for b in range(nb):
    acc = None
    for j in np.nonzero(m.tree.subtree_mask[b])[0]:
      if mass[j] == 0.0:
        continue
      term = xipos[j] * float(mass[j])
      acc = term if acc is None else acc + term
    if acc is None:
      acc = torch.zeros((3, W), **kw)
    subtree_com.append(acc * float(1.0 / max(subtreemass[b], 1e-12)))

  cinert = []
  for b in range(nb):
    R = ximat[b]
    c = xipos[b] - subtree_com[int(m.body_rootid[b])]
    mss = float(mass[b])
    inr = [float(x) for x in inertia[b]]
    ic = [[None] * 3 for _ in range(3)]
    for a in range(3):  # ic = R diag(I) R^T
      for bb in range(a, 3):
        acc = None
        for k in range(3):
          if inr[k] == 0.0:
            continue
          t = R[3 * a + k:3 * a + k + 1] * R[3 * bb + k:3 * bb + k + 1] * inr[k]
          acc = t if acc is None else acc + t
        ic[a][bb] = ic[bb][a] = zero if acc is None else acc
    c0, c1, c2 = c[0:1], c[1:2], c[2:3]
    cc = c0 * c0 + c1 * c1 + c2 * c2
    cv = [c0, c1, c2]
    tl = [[ic[a][bb] + mss * (cc - cv[a] * cv[bb]) if a == bb
           else ic[a][bb] - mss * cv[a] * cv[bb] for bb in range(3)]
          for a in range(3)]
    ch = [[zero, -mss * c2, mss * c1],
          [mss * c2, zero, -mss * c0],
          [-mss * c1, mss * c0, zero]]
    rows = [L.cat(tl[a] + ch[a]) for a in range(3)]
    for a in range(3):
      br = [zero, zero, zero]
      br[a] = torch.full((1, W), mss, **kw)
      rows.append(L.cat([-ch[a][0], -ch[a][1], -ch[a][2]] + br))
    cinert.append(L.cat(rows))

  cdof = [None] * m.nv
  for j in range(m.njnt):
    jt = int(m.jnt_type[j])
    b = int(m.jnt_bodyid[j])
    dadr = int(m.jnt_dofadr[j])
    com = subtree_com[int(m.body_rootid[b])]
    z = torch.zeros((3, W), **kw)
    if jt == _JT.FREE:
      for a in range(3):
        ec = L.cat([torch.full((1, W), 1.0, **kw) if k == a else
                    torch.zeros((1, W), **kw) for k in range(3)])
        cdof[dadr + a] = L.cat([z, ec])
      Rb = L.q2mat(xquat[b])
      off = xpos[b] - com
      for a in range(3):
        axis = L.cat([Rb[a:a + 1], Rb[3 + a:4 + a], Rb[6 + a:7 + a]])
        cdof[dadr + 3 + a] = L.cat([axis, L.cross(off, axis)])
    elif jt == _JT.SLIDE:
      cdof[dadr] = L.cat([z, xaxis[j]])
    else:  # HINGE
      cdof[dadr] = L.cat([xaxis[j], L.cross(xanchor[j] - com, xaxis[j])])
  return subtree_com, cinert, cdof


def geom_frames(m: types.Model, xpos, xquat):
  """Per-geom world position (3, W) and rotation (9, W) lists."""
  geom_pos, geom_quat = host(m.geom_pos), host(m.geom_quat)
  gx, gmat = [], []
  for g in range(m.ngeom):
    b = int(m.geom_bodyid[g])
    gx.append(L.add(xpos[b], L.qrot_const(geom_pos[g], xquat[b])))
    gmat.append(L.q2mat(L.qmul_const(xquat[b], geom_quat[g])))
  return gx, gmat


def _sphere_sphere_g(p1, r1, p2, r2):
  vec = p2 - p1
  ln = L.gnorm(vec)
  n = vec / ln
  dist = ln - (r1 + r2)
  return dist, p1 + n * (r1 + 0.5 * dist), n


def _closest_seg_point_g(a, b, p):
  ab = b - a
  t = L.gdot(p - a, ab) / torch.clamp(L.gdot(ab, ab), min=L.MINVAL)
  return a + ab * torch.clamp(t, 0.0, 1.0)


def _closest_seg_seg_g(a0, a1, b0, b1):
  da, db, r = a1 - a0, b1 - b0, a0 - b0
  A, B, C = L.gdot(da, da), L.gdot(da, db), L.gdot(db, db)
  D, E = L.gdot(da, r), L.gdot(db, r)
  denom = A * C - B * B
  s = torch.where(denom > 1e-12, (B * E - C * D) /
                  torch.clamp(denom, min=L.MINVAL), torch.zeros_like(denom))
  s = torch.clamp(s, 0.0, 1.0)
  t = torch.clamp((B * s + E) / torch.clamp(C, min=L.MINVAL), 0.0, 1.0)
  s2 = torch.clamp((B * t - D) / torch.clamp(A, min=L.MINVAL), 0.0, 1.0)
  return a0 + da * s2, b0 + db * t


def _rot(mats, v, transpose=False):
  """Grouped (n, 9, W) rotation times (n, 3, W) vector (or its transpose)."""
  rows = []
  for r in range(3):
    idx = [r + 3 * k for k in range(3)] if transpose else \
        [3 * r + k for k in range(3)]
    rows.append(mats[:, idx[0]:idx[0] + 1] * v[:, 0:1] +
                mats[:, idx[1]:idx[1] + 1] * v[:, 1:2] +
                mats[:, idx[2]:idx[2] + 1] * v[:, 2:3])
  return L.cat(rows, dim=1)


def _pick_deepest(depths, npick, extras):
  """Index-tracked selection of the ``npick`` smallest depths, first index
  winning ties.  ``extras`` are per-candidate lists of tensors carried with
  each pick.  Returns [(depth, [extra, ...]), ...]."""
  taken = [torch.zeros_like(depths[0], dtype=torch.bool) for _ in depths]
  big = torch.full_like(depths[0], L.BIGW)
  out = []
  for _ in range(npick):
    dmin = torch.where(taken[0], big, depths[0])
    emin = [e[0] for e in extras]
    idxm = torch.zeros_like(dmin)
    for k in range(1, len(depths)):
      dk = torch.where(taken[k], big, depths[k])
      better = dk < dmin
      emin = [torch.where(better, e[k], em) for e, em in zip(extras, emin)]
      idxm = torch.where(better, torch.full_like(idxm, float(k)), idxm)
      dmin = torch.where(better, dk, dmin)
    for k in range(len(depths)):
      taken[k] = taken[k] | (idxm == float(k))
    out.append((dmin, emin))
  return out


def narrowphase(m: types.Model, gx, gmat, sizes):
  """All candidate contacts in slot order: dist (ncand, W), pos
  (3 ncand, W), frame (9 ncand, W).  ``sizes`` is geom_size (ngeom, 3)."""
  sz = host(sizes)
  W = gx[0].shape[-1]
  kw = dict(dtype=gx[0].dtype, device=gx[0].device)
  dists, poss, frames = [], [], []
  for (t1, t2, idx, _) in m.pair_groups:
    g1, g2 = m.pair_geom1[idx], m.pair_geom2[idx]
    P1 = torch.stack([gx[int(g)] for g in g1])
    P2 = torch.stack([gx[int(g)] for g in g2])
    key = (int(t1), int(t2))
    col_z = lambda gl: torch.stack([L.cat([gmat[int(g)][2:3], gmat[int(g)][5:6],
                                           gmat[int(g)][8:9]]) for g in gl])
    mats_of = lambda gl: torch.stack([gmat[int(g)] for g in gl])

    def szcol(gl, comp):
      return torch.tensor(np.asarray([sz[int(g), comp] for g in gl],
                                     np.float32), **kw)[:, None, None] \
          .expand(len(gl), 1, W)

    if key == (_GT.PLANE, _GT.SPHERE):
      nrm = col_z(g1)
      r = szcol(g2, 0)
      dist = L.gdot(nrm, P2 - P1) - r
      dists.append(dist)
      poss.append(P2 - nrm * (r + 0.5 * dist))
      frames.append(L.make_frame_g(nrm))
    elif key == (_GT.PLANE, _GT.CAPSULE):
      nrm, axis = col_z(g1), col_z(g2)
      r, half = szcol(g2, 0), szcol(g2, 1)
      seg = axis * half
      b = axis - nrm * L.gdot(nrm, axis)
      bn = L.gnorm(b)
      ny = (torch.abs(nrm[:, 1:2]) < 0.5).to(nrm.dtype)
      fb = L.cat([torch.zeros_like(ny), ny, 1.0 - ny], dim=1)
      b = torch.where(bn < 0.5, fb, b / bn)
      frame = L.cat([nrm, b, L.gcross(nrm, b)], dim=1)
      for sgn in (1.0, -1.0):
        cen = P2 + seg * sgn
        dist = L.gdot(nrm, cen - P1) - r
        dists.append(dist)
        poss.append(cen - nrm * (r + 0.5 * dist))
        frames.append(frame)
    elif key == (_GT.PLANE, _GT.BOX):
      nrm = col_z(g1)
      mats = mats_of(g2)
      sx, sy, sz_ = szcol(g2, 0), szcol(g2, 1), szcol(g2, 2)
      heights, corners = [], []
      for a in (-1.0, 1.0):
        for b in (-1.0, 1.0):
          for c in (-1.0, 1.0):
            cw = P2 + _rot(mats, L.cat([a * sx, b * sy, c * sz_], dim=1))
            heights.append(L.gdot(nrm, cw - P1))
            corners.append(cw)
      frame = L.make_frame_g(nrm)
      for hmin, (cmin,) in _pick_deepest(heights, 4, [corners]):
        dists.append(hmin)
        poss.append(cmin - nrm * (0.5 * hmin))
        frames.append(frame)
    elif key == (_GT.SPHERE, _GT.BOX):
      r = szcol(g1, 0)
      mats = mats_of(g2)
      loc = _rot(mats, P1 - P2, transpose=True)
      size = L.cat([szcol(g2, 0), szcol(g2, 1), szcol(g2, 2)], dim=1)
      cl = torch.maximum(torch.minimum(loc, size), -size)
      inside = torch.all(torch.abs(loc) < size, dim=1, keepdim=True)
      fd = size - torch.abs(loc)
      one, two = torch.ones_like(r), torch.full_like(r, 2.0)
      k01 = torch.where(fd[:, 0:1] <= fd[:, 1:2], torch.zeros_like(r), one)
      fd01 = torch.minimum(fd[:, 0:1], fd[:, 1:2])
      kmin = torch.where(fd01 <= fd[:, 2:3], k01, two)
      sgn = torch.sign(loc)
      sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
      pushed = L.cat([torch.where(kmin == float(j),
                                  sgn[:, j:j + 1] * size[:, j:j + 1],
                                  cl[:, j:j + 1]) for j in range(3)], dim=1)
      cw = P2 + _rot(mats, torch.where(inside, pushed, cl))
      vec = cw - P1
      ln = L.gnorm(vec)
      nrm = vec / ln
      dist = torch.where(inside, -(ln + r), ln - r)
      nrm = torch.where(inside, -nrm, nrm)
      dists.append(dist)
      poss.append(P1 + nrm * (r + 0.5 * dist))
      frames.append(L.make_frame_g(nrm))
    elif key == (_GT.CAPSULE, _GT.BOX):
      axis = col_z(g1)
      r, half = szcol(g1, 0), szcol(g1, 1)
      seg = axis * half
      mats = mats_of(g2)
      size = L.cat([szcol(g2, 0), szcol(g2, 1), szcol(g2, 2)], dim=1)
      e0, e1 = P1 - seg, P1 + seg
      mid = _closest_seg_point_g(e0, e1, P2)
      pd, pp, pn = [], [], []
      for center in (e0, e1, mid):
        rel = _rot(mats, center - P2, transpose=True)
        cl = torch.maximum(torch.minimum(rel, size), -size)
        vec = P2 + _rot(mats, cl) - center
        ln = L.gnorm(vec)
        nrm = vec / ln
        di = ln - r
        pd.append(di)
        pp.append(center + nrm * (r + 0.5 * di))
        pn.append(nrm)
      for dmin, (pmin, nmin) in _pick_deepest(pd, 2, [pp, pn]):
        dists.append(dmin)
        poss.append(pmin)
        frames.append(L.make_frame_g(nmin))
    elif key == (_GT.SPHERE, _GT.SPHERE):
      dist, pos, nrm = _sphere_sphere_g(P1, szcol(g1, 0), P2, szcol(g2, 0))
      dists.append(dist)
      poss.append(pos)
      frames.append(L.make_frame_g(nrm))
    elif key == (_GT.SPHERE, _GT.CAPSULE):
      axis = col_z(g2)
      seg = axis * szcol(g2, 1)
      pt = _closest_seg_point_g(P2 - seg, P2 + seg, P1)
      dist, pos, nrm = _sphere_sphere_g(P1, szcol(g1, 0), pt, szcol(g2, 0))
      dists.append(dist)
      poss.append(pos)
      frames.append(L.make_frame_g(nrm))
    elif key == (_GT.CAPSULE, _GT.CAPSULE):
      ax1 = col_z(g1) * szcol(g1, 1)
      ax2 = col_z(g2) * szcol(g2, 1)
      pa, pb = _closest_seg_seg_g(P1 - ax1, P1 + ax1, P2 - ax2, P2 + ax2)
      dist, pos, nrm = _sphere_sphere_g(pa, szcol(g1, 0), pb, szcol(g2, 0))
      dists.append(dist)
      poss.append(pos)
      frames.append(L.make_frame_g(nrm))
    else:
      raise NotImplementedError(key)
  flat = lambda xs: L.cat([x.reshape(-1, W) for x in xs])
  return flat(dists), flat(poss), flat(frames)


def mass_chain(m: types.Model, cinert, cdof, qvel, armature, gravity,
               need_L=True, ancm=None):
  """crb -> qM (+ armature) -> [Cholesky] -> com_vel -> RNE bias.

  ``mass_chain_core`` of ``mujoco_warp_tpu/pallas/smooth.py`` (:43).
  ``cinert`` and ``cdof`` are lists of (36, W) per body and (6, W) per dof.
  ``ancm`` (nv, nv) selects the large-tree form (:99-110): qM from twelve
  (nv, nv, W) products masked by the ancestor relation (1: cdof[j] f[i],
  2: cdof[i] f[j], 0: zero), and no factor.  Returns (qM (nv, nv, W), L
  or None, cvel list (6, W) per body, cdof_dot list (6, W) per dof, bias
  (nv, W)).  ``armature`` (nv,) and ``gravity`` (3,) are one model's, or
  lanes-last (nv, W) and (3, W), each world's own.
  """
  nb, nv = m.nbody, m.nv
  W = qvel.shape[-1]
  kw = dict(dtype=qvel.dtype, device=qvel.device)
  dof_bodyid = [int(x) for x in m.dof_bodyid]
  parent = [int(x) for x in m.body_parentid]
  anc = m.tree.ancestor_mask
  topo = [int(b) for lvl in m.tree.body_levels for b in lvl]
  qv = [qvel[i:i + 1] for i in range(nv)]
  cross3 = L.cross

  def mat6vec(flat36, v6):
    return L.cat([torch.sum(flat36[6 * r:6 * r + 6] * v6, dim=0, keepdim=True)
                  for r in range(6)])

  crbs = list(cinert)
  for b in reversed(topo):
    crbs[parent[b]] = crbs[parent[b]] + crbs[b]
  f = [mat6vec(crbs[dof_bodyid[i]], cdof[i]) for i in range(nv)]
  if ancm is not None:
    F, CD = torch.stack(f), torch.stack(list(cdof))  # (nv, 6, W)
    G1 = G2 = None
    for k in range(6):
      t1 = F[:, k][:, None] * CD[:, k][None]
      t2 = CD[:, k][:, None] * F[:, k][None]
      G1 = t1 if G1 is None else G1 + t1
      G2 = t2 if G2 is None else G2 + t2
    sel = torch.as_tensor(np.asarray(ancm), device=qvel.device)[:, :, None]
    zero = torch.zeros_like(G1)
    qM = torch.where(sel == 1, G1, zero) + torch.where(sel == 2, G2, zero)
    need_L = False
  else:
    zrow = torch.zeros((1, W), **kw)
    rows = []
    for i in range(nv):
      cols = []
      for j in range(nv):
        if anc[i, j] or anc[j, i]:
          jj, ii = (j, i) if anc[i, j] else (i, j)
          cols.append(torch.sum(cdof[jj] * f[ii], dim=0, keepdim=True))
        else:
          cols.append(zrow)
      rows.append(L.cat(cols))
    qM = torch.stack(rows)
  eye = torch.eye(nv, **kw)
  arm = torch.as_tensor(armature).to(**kw).reshape(nv, -1)
  qM = qM + eye[:, :, None] * arm[:, None, :]
  Lf = chol_tile(qM, nv) if need_L else None

  cdof_qvel = [cdof[i] * qv[i] for i in range(nv)]
  own = [np.nonzero(np.asarray(dof_bodyid) == b)[0] for b in range(nb)]
  cvel = [None] * nb
  cvel[0] = torch.zeros((6, W), **kw)
  for b in topo:
    acc = cvel[parent[b]]
    for i in own[b]:
      acc = acc + cdof_qvel[int(i)]
    cvel[b] = acc
  cdof_dot = []
  for i in range(nv):
    nz = np.nonzero(m.tree.cdofdot_mask[i])[0]
    if len(nz) == 0:
      vb = torch.zeros((6, W), **kw)
    else:
      vb = cdof_qvel[nz[0]]
      for j in nz[1:]:
        vb = vb + cdof_qvel[j]
    va, vl = vb[:3], vb[3:]
    ua, ul = cdof[i][:3], cdof[i][3:]
    cdof_dot.append(L.cat([cross3(va, ua), cross3(vl, ua) + cross3(va, ul)]))

  if m.opt.disableflags & types.DisableBit.GRAVITY:
    cacc0 = torch.zeros((6, W), **kw)
  else:
    g = torch.as_tensor(gravity).to(**kw).reshape(3, -1) * \
        torch.ones((3, W), **kw)
    cacc0 = L.cat([torch.zeros((3, W), **kw), -g])
  cacc = [None] * nb
  cacc[0] = cacc0
  cfrc = [None] * nb
  cfrc[0] = torch.zeros((6, W), **kw)
  for b in topo:
    acc = cacc[parent[b]]
    for i in own[b]:
      acc = acc + cdof_dot[int(i)] * qv[int(i)]
    cacc[b] = acc
    iv = mat6vec(cinert[b], cvel[b])
    ia = mat6vec(cinert[b], acc)
    va, vl = cvel[b][:3], cvel[b][3:]
    fa, fl = iv[:3], iv[3:]
    cfrc[b] = ia + L.cat([cross3(va, fa) + cross3(vl, fl), cross3(va, fl)])
  for b in reversed(topo):
    cfrc[parent[b]] = cfrc[parent[b]] + cfrc[b]
  bias = L.cat([torch.sum(cfrc[dof_bodyid[i]] * cdof[i], dim=0, keepdim=True)
                for i in range(nv)])
  return qM, Lf, cvel, cdof_dot, bias


def k1(m: types.Model, qpos, qvel, need_qLD=True):
  """Plain K1 on lanes-last state.  Returns (qM (nv*nv, W), qLD or None,
  bias (nv, W), cdof (6 nv, W), dist (ncand, W), cpos (3 ncand, W),
  cframe (9 ncand, W), subtree_com (3 nbody, W)); the four contact outputs
  are None when the model has no collision candidates."""
  nv = m.nv
  W = qpos.shape[-1]
  xpos, xquat, xanchor, xaxis = fk(m, qpos)
  stcom, cinert, cdof = com_quantities(m, xpos, xquat, xanchor, xaxis)
  dist = cpos = cframe = stcom_out = None
  if m.opt.run_collision_detection and m.ncand:
    gx, gmat = geom_frames(m, xpos, xquat)
    dist, cpos, cframe = narrowphase(m, gx, gmat, m.geom_size)
    stcom_out = L.cat(stcom)
  qM, Lf, _, _, bias = mass_chain(m, cinert, cdof, qvel, m.dof_armature,
                                  m.opt.gravity, need_L=need_qLD)
  return (qM.reshape(nv * nv, W),
          Lf.reshape(nv * nv, W) if need_qLD else None, bias, L.cat(cdof),
          dist, cpos, cframe, stcom_out)
