"""K4 wrapper: constraint rows, Newton solve and integration.

CPU tensors run the plain version (``fused/k4_ref.py``); CUDA tensors
launch ``csrc/k4.cu`` (which replaces ``pallas/fused.py`` ``_make_k4``).
The kernel gives each world one warp and holds the world's rows, M and
factor in shared memory: ``world_floats`` counts its floats, and ``fits``
says whether one world fits in a block (``fused.reason`` sends a model
that does not to the general step).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import MAX_NV, k4_ref
from mujoco_warp_tpu_torch.kernels import TableCache, build, check, \
    device_tables, ptr
from mujoco_warp_tpu_torch.kernels import solver

# launches of the CUDA kernel (not of the plain version)
launches = 0

_INTS = ('W', 'nq', 'nv', 'njnt', 'nlim', 'neq', 'ncon', 'nrow',
         'iterations', 'ls_iterations', 'damped', 'refsafe', 'has_rows')
_FLOATS = ('tol', 'ls_tol', 'meaninertia', 'h', 'impratio_inv')
_CON_PTRS = ('c_dist', 'c_pos', 'c_frame', 'c_im', 'c_fri', 'c_solref',
             'c_solimp', 'c_invw', 'c_mask1', 'c_mask2', 'c_com1', 'c_com2')
_TABLE_PTRS = ('lim_i', 'lim_f', 'eq_i', 'eq_f', 'con_dim', 'con_row',
               'kind', 'damping', 'jnt_type', 'jnt_qposadr', 'jnt_dofadr')
_PTRS = (('qM', 'qLD', 'qfs', 'ws', 'qvel', 'qpos', 'cdof') + _CON_PTRS +
         ('qpos_out', 'qvel_out', 'warm_out', 'qacc_out', 'niter_out') +
         _TABLE_PTRS)
K4Params = build.params_struct('K4Params', ints=_INTS, floats=_FLOATS,
                               ptrs=_PTRS)


def _slot_rows(m: types.Model) -> np.ndarray:
  """(ncon,) constraint rows of each contact slot."""
  dims = np.asarray(m.con_dim if m.ncon else [], np.int64)
  return np.where(dims == 1, 1, 2 * (dims - 1))


def con_rows(m: types.Model) -> int:
  """Constraint rows of the contact slots."""
  return int(_slot_rows(m).sum())


def nrow(m: types.Model) -> int:
  """K4's rows with the contacts of a model whose collision runs: limits,
  joint equality, contact slots."""
  con = con_rows(m) if m.opt.run_collision_detection else 0
  return len(k4_ref.limit_tables(m)) + len(k4_ref.eq_joint_tables(m)) + con


def world_floats(nrow: int, nv: int, nq: int) -> int:
  """Shared floats of one world of the kernel (``csrc/k4.cu``
  ``K4Layout``): the solve kernel's layout of nrow rows without elliptic
  contacts (``solver.world_floats``), then qpos and qvel; cdof (6 nv)
  lies in the factor's region where it fits (nv >= 6), else after
  them."""
  extra = 0 if 6 * nv <= nv * (nv | 1) else 6 * nv
  return solver.world_floats(nrow, nv, 0) + nq + nv + extra


def world_bytes(m: types.Model) -> int:
  """Shared bytes of one world of ``m`` (``nrow`` rows)."""
  return 4 * world_floats(nrow(m), m.nv, m.nq)


def fits(m: types.Model) -> bool:
  """Does one world of ``m`` fit in the shared memory of a block?"""
  return world_bytes(m) <= solver.SMEM_BLOCK


def tables(m: types.Model) -> dict:
  """Row tables K4 reads: python-float constants of the plain version,
  rounded once to float32; each contact slot's first row (``con_row``)
  and every row's kind (ROW_EQ for equality rows, ROW_INEQ for limits
  and contacts)."""
  if m.nv > MAX_NV:
    raise ValueError(f'K4 caps nv at {MAX_NV}, got {m.nv}')
  lims = k4_ref.limit_tables(m)
  eqs = k4_ref.eq_joint_tables(m)
  lim_i = [(t['qadr'], t['dadr']) for t in lims]
  lim_f = [(t['lo'], t['hi'], t['margin']) + t['solref'] + t['solimp'] +
           (t['invw'],) for t in lims]
  eq_i = [(t['qadr1'], t['dadr1'], int(t['has2']), t['qadr2'], t['dadr2'])
          for t in eqs]
  eq_f = [(t['q01'], t['q02']) + t['data'] + t['solref'] + t['solimp'] +
          (t['invw'],) for t in eqs]
  slot = _slot_rows(m)
  kind = np.full(len(lims) + len(eqs) + int(slot.sum()), solver.ROW_INEQ,
                 np.int32)
  kind[len(lims):len(lims) + len(eqs)] = solver.ROW_EQ
  return dict(
      lim_i=np.asarray(lim_i, np.int32), lim_f=np.asarray(lim_f, np.float32),
      eq_i=np.asarray(eq_i, np.int32), eq_f=np.asarray(eq_f, np.float32),
      con_dim=np.asarray(m.con_dim if m.ncon else [], np.int32),
      con_row=(len(lims) + len(eqs) + np.cumsum(slot) - slot).astype(
          np.int32),
      kind=kind, damping=types.host(m.dof_damping, np.float32),
      jnt_type=m.jnt_type, jnt_qposadr=m.jnt_qposadr,
      jnt_dofadr=m.jnt_dofadr)


def _build(m, dev):
  sc = [float(x) for x in k4_ref.scalars(m)]
  return device_tables(tables(m), dev), sc, len(k4_ref.limit_tables(m)), \
      len(k4_ref.eq_joint_tables(m))


_TABLES = TableCache(_build)


def k4(m: types.Model, qM, qLD, qfs, ws, qvel, qpos, cdof, con):
  """K4 on lanes-last tensors.  ``con``: compacted contact arrays
  (``k4_ref.CON_KEYS``) or None.  Returns (qpos, qvel, warmstart, qacc,
  niter (1, W) int32)."""
  global launches
  if qpos.device.type == 'cpu':
    return k4_ref.k4(m, qM, qLD, qfs, ws, qvel, qpos, cdof, con)
  if qpos.device.type != 'cuda':
    raise ValueError(f'K4 runs on cpu or cuda tensors, not {qpos.device}')
  dev = qpos.device
  W = qpos.shape[-1]
  nv = m.nv
  has_rows = k4_ref.has_rows(m)
  check(qpos, (m.nq, W), 'qpos', dev)
  for t, name in ((qvel, 'qvel'), (qfs, 'qfs'), (ws, 'ws')):
    check(t, (nv, W), name, dev)
  check(qM, (nv * nv, W), 'qM', dev)
  check(cdof, (6 * nv, W), 'cdof', dev)
  if not has_rows:
    check(qLD, (nv * nv, W), 'qLD', dev)
  use_con = con is not None and bool(m.ncon) and \
      bool(m.opt.run_collision_detection)
  ncon = m.ncon if use_con else 0
  if use_con:
    for key, rows in k4_ref.CON_KEYS:
      check(con[key], ((rows or nv) * ncon, W), f'con[{key}]', dev)
  tab, sc, nlim, neq = _TABLES.get(m, dev)
  nr = nlim + neq + (con_rows(m) if use_con else 0)
  floats = world_floats(nr, nv, m.nq)
  if 4 * floats > solver.SMEM_BLOCK:
    raise ValueError(f'K4: one world (nrow {nr}, nv {nv}) takes '
                     f'{4 * floats} shared bytes, more than a block\'s '
                     f'{solver.SMEM_BLOCK}')
  lib = build.load()
  if lib.mwt_k4_params_size() != ctypes.sizeof(K4Params) or \
      lib.mwt_k4_world_floats(nr, nv, m.nq) != floats:
    raise RuntimeError('K4Params or the shared layout differs between C '
                       'and Python')
  new = lambda rows, dt=torch.float32: torch.empty((rows, W), dtype=dt,
                                                   device=dev)
  qpos_out, qvel_out, warm, qacc = new(m.nq), new(nv), new(nv), new(nv)
  niter = new(1, torch.int32)
  cons = {c: ptr(con[k] if use_con else None)
          for c, (k, _) in zip(_CON_PTRS, k4_ref.CON_KEYS)}
  p = K4Params(
      W=W, nq=m.nq, nv=nv, njnt=m.njnt, nlim=nlim, neq=neq, ncon=ncon,
      nrow=nr, iterations=int(m.opt.iterations),
      ls_iterations=int(m.opt.ls_iterations), damped=int(k4_ref.damped(m)),
      refsafe=int(not (m.opt.disableflags & types.DisableBit.REFSAFE)),
      has_rows=int(has_rows), tol=sc[0], ls_tol=sc[1], meaninertia=sc[2],
      h=sc[3], impratio_inv=sc[4],
      qM=ptr(qM), qLD=ptr(qLD), qfs=ptr(qfs), ws=ptr(ws), qvel=ptr(qvel),
      qpos=ptr(qpos), cdof=ptr(cdof), qpos_out=ptr(qpos_out),
      qvel_out=ptr(qvel_out), warm_out=ptr(warm), qacc_out=ptr(qacc),
      niter_out=ptr(niter), **cons,
      **{k: ptr(tab[k]) for k in _TABLE_PTRS})
  stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.mwt_k4_launch(ctypes.byref(p), ctypes.c_void_p(stream))
  if rc != 0:
    raise RuntimeError(f'K4 launch failed: cudaError {rc}')
  launches += 1
  return qpos_out, qvel_out, warm, qacc, niter


def kernel_info(m: types.Model) -> dict:
  """The kernel on the card: registers per thread, worlds (warps) per
  block and shared bytes per block at ``m``'s sizes."""
  p = K4Params(nv=m.nv, nq=m.nq, nrow=nrow(m))
  out = (ctypes.c_int * 3)()
  rc = build.load().mwt_k4_info(ctypes.byref(p), out)
  if rc != 0:
    raise RuntimeError(f'K4 kernel attributes: cudaError {rc}')
  return {'registers': out[0], 'worlds_per_block': out[1],
          'shared_bytes_per_block': out[2]}
