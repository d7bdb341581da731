"""K1 wrapper: FK, com quantities, narrowphase and mass chain.

CPU tensors run the plain version (``fused/k1_ref.py``); CUDA tensors
launch ``csrc/k1.cu`` (which replaces ``pallas/fused.py`` ``_make_k1``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import MAX_NBODY, MAX_NCAND, MAX_NV
from mujoco_warp_tpu_torch.fused import k1_ref
from mujoco_warp_tpu_torch.kernels import TableCache, build, check, \
    device_tables, ptr

# launches of the CUDA kernel (not of the plain version)
launches = 0

_INTS = ('W', 'nq', 'nv', 'nbody', 'njnt', 'ngeom', 'ngroup', 'need_qld',
         'run_col', 'no_gravity')
_PTRS = ('qpos', 'qvel', 'qM', 'qLD', 'bias', 'cdof', 'dist', 'cpos',
         'cframe', 'stcom', 'scr', 'topo', 'body_parent', 'body_jntadr',
         'body_jntnum', 'body_rootid', 'body_dofadr', 'body_dofnum',
         'subtree', 'body_pos', 'body_quat', 'body_ipos', 'body_iquat',
         'body_mass', 'body_inertia', 'body_inv_stm', 'jnt_type',
         'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid', 'jnt_pos', 'jnt_axis',
         'jnt_qpos0', 'dof_bodyid', 'ancestor', 'cdofdot', 'armature',
         'gravity', 'geom_bodyid', 'geom_pos', 'geom_quat', 'geom_size',
         'group', 'pair_g1', 'pair_g2')
K1Params = build.params_struct('K1Params', ints=_INTS, ptrs=_PTRS)


def tables(m: types.Model) -> dict:
  """Model constants K1 reads, as numpy; derived constants are computed
  in float64 and rounded once to float32, as the Pallas trace folded them."""
  if m.nv > MAX_NV or m.nbody > MAX_NBODY or m.ncand > MAX_NCAND:
    raise ValueError(f'K1 caps: nv {m.nv} <= {MAX_NV}, nbody {m.nbody} <= '
                     f'{MAX_NBODY}, ncand {m.ncand} <= {MAX_NCAND}')
  h = types.host
  f32 = lambda x: np.asarray(x, np.float32)
  dofadr = np.zeros(m.nbody, np.int32)
  dofnum = np.zeros(m.nbody, np.int32)
  for b in range(m.nbody):
    dofs = np.nonzero(m.dof_bodyid == b)[0]
    if len(dofs):
      if not np.array_equal(dofs, np.arange(dofs[0], dofs[0] + len(dofs))):
        raise ValueError(f'dofs of body {b} are not contiguous')
      dofadr[b], dofnum[b] = dofs[0], len(dofs)
  groups, g1, g2 = [], [], []
  for (t1, t2, idx, slot) in m.pair_groups:
    groups.append((t1, t2, len(idx), slot, len(g1)))
    g1 += list(m.pair_geom1[idx])
    g2 += list(m.pair_geom2[idx])
  stm = h(m.body_subtreemass)
  return dict(
      topo=[int(b) for lvl in m.tree.body_levels for b in lvl],
      body_parent=m.body_parentid, body_jntadr=m.body_jntadr,
      body_jntnum=m.body_jntnum, body_rootid=m.body_rootid,
      body_dofadr=dofadr, body_dofnum=dofnum,
      subtree=m.tree.subtree_mask.astype(np.int32),
      body_pos=f32(h(m.body_pos)), body_quat=f32(h(m.body_quat)),
      body_ipos=f32(h(m.body_ipos)), body_iquat=f32(h(m.body_iquat)),
      body_mass=f32(h(m.body_mass)), body_inertia=f32(h(m.body_inertia)),
      body_inv_stm=f32(1.0 / np.maximum(stm, 1e-12)),
      jnt_type=m.jnt_type, jnt_qposadr=m.jnt_qposadr,
      jnt_dofadr=m.jnt_dofadr, jnt_bodyid=m.jnt_bodyid,
      jnt_pos=f32(h(m.jnt_pos)), jnt_axis=f32(h(m.jnt_axis)),
      jnt_qpos0=f32(h(m.qpos0)[m.jnt_qposadr]),
      dof_bodyid=m.dof_bodyid,
      ancestor=m.tree.ancestor_mask.astype(np.int32),
      cdofdot=m.tree.cdofdot_mask.astype(np.int32),
      armature=f32(h(m.dof_armature)), gravity=f32(h(m.opt.gravity)),
      geom_bodyid=m.geom_bodyid, geom_pos=f32(h(m.geom_pos)),
      geom_quat=f32(h(m.geom_quat)), geom_size=f32(h(m.geom_size)),
      group=np.asarray(groups, np.int32).reshape(-1, 5),
      pair_g1=np.asarray(g1, np.int32), pair_g2=np.asarray(g2, np.int32))


_TABLES = TableCache(lambda m, dev: device_tables(tables(m), dev))


def k1(m: types.Model, qpos, qvel, need_qLD=True):
  """K1 on lanes-last state.  Returns (qM (nv*nv, W), qLD or None, bias
  (nv, W), cdof (6 nv, W), dist (ncand, W), cpos (3 ncand, W), cframe
  (9 ncand, W), subtree_com (3 nbody, W)); the four contact outputs are
  None without collision candidates."""
  global launches
  if qpos.device.type == 'cpu':
    return k1_ref.k1(m, qpos, qvel, need_qLD=need_qLD)
  if qpos.device.type != 'cuda':
    raise ValueError(f'K1 runs on cpu or cuda tensors, not {qpos.device}')
  dev = qpos.device
  W = qpos.shape[-1]
  nv, nb, nc = m.nv, m.nbody, m.ncand
  check(qpos, (m.nq, W), 'qpos', dev)
  check(qvel, (nv, W), 'qvel', dev)
  lib = build.load()
  if lib.mwt_k1_params_size() != ctypes.sizeof(K1Params):
    raise RuntimeError('K1Params layout differs between C and Python')
  tab = _TABLES.get(m, dev)
  run_col = bool(m.opt.run_collision_detection) and nc > 0
  new = lambda rows: torch.empty((rows, W), dtype=torch.float32, device=dev)
  qM = new(nv * nv)
  qLD = new(nv * nv) if need_qLD else None
  bias, cdof, stcom = new(nv), new(6 * nv), new(3 * nb)
  dist, cpos, cframe = (new(nc), new(3 * nc), new(9 * nc)) if run_col else \
      (None, None, None)
  scr = new(lib.mwt_k1_scratch_rows(nb, m.njnt, nv, m.ngeom))
  p = K1Params(
      W=W, nq=m.nq, nv=nv, nbody=nb, njnt=m.njnt, ngeom=m.ngeom,
      ngroup=len(m.pair_groups) if run_col else 0, need_qld=int(need_qLD),
      run_col=int(run_col),
      no_gravity=int(bool(m.opt.disableflags & types.DisableBit.GRAVITY)),
      qpos=ptr(qpos), qvel=ptr(qvel), qM=ptr(qM), qLD=ptr(qLD),
      bias=ptr(bias), cdof=ptr(cdof), dist=ptr(dist), cpos=ptr(cpos),
      cframe=ptr(cframe), stcom=ptr(stcom), scr=ptr(scr),
      **{k: ptr(v) for k, v in tab.items()})
  stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.mwt_k1_launch(ctypes.byref(p), ctypes.c_void_p(stream))
  if rc != 0:
    raise RuntimeError(f'K1 launch failed: cudaError {rc}')
  launches += 1
  return (qM, qLD, bias, cdof, dist, cpos, cframe,
          stcom if run_col else None)
