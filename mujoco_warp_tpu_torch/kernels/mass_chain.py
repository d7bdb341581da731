"""Mass-chain wrapper: crb, qM, its Cholesky factor, com_vel, cdof_dot and
the RNE bias of the general step.

CPU tensors run the plain version (``fused/k1_ref.py`` ``mass_chain``);
CUDA tensors launch ``csrc/mass_chain.cu``, which replaces
``mujoco_warp_tpu/pallas/smooth.py`` ``_make_kernel`` (:211, called by
``mass_chain`` :286) in both its forms.  A large tree (``big_tree``: nv >
48 or nbody > 32) skips the factor in the kernel; qLD then comes from the
``chol_batched`` kernel with jitter 1e-12 (``pallas/smooth.py:296-304``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import k1_ref
from mujoco_warp_tpu_torch.kernels import TableCache, build, check, \
    device_tables, lanes, ptr, world
from mujoco_warp_tpu_torch.kernels import linalg as klinalg

# launches of the CUDA kernel (not of the plain version)
launches = 0

# the small-tree form (pallas/smooth.py _big_tree :196): beyond it the ancm
# mass chain and the separate factor (pallas/linalg.py chol_batched) run
MAX_NV, MAX_NBODY = 48, 32
# the jitter of the large-tree factor (pallas/smooth.py:303)
BIG_JITTER = 1e-12

_TABLE_PTRS = ('topo', 'body_parent', 'body_dofadr', 'body_dofnum',
               'dof_bodyid', 'ancestor', 'cdofdot', 'armature', 'gravity')
MassChainParams = build.params_struct(
    'MassChainParams', ints=('W', 'nb', 'nv', 'no_gravity'),
    ptrs=('cinert', 'cdof', 'qvel', 'qM', 'qLD', 'cvel', 'cdof_dot', 'bias',
          'scr') + _TABLE_PTRS)


def big_tree(m: types.Model) -> bool:
  """The large-tree form: no factor in the mass chain."""
  return m.nv > MAX_NV or m.nbody > MAX_NBODY


def ancm_table(m: types.Model) -> np.ndarray:
  """(nv, nv) qM selector of the large-tree form
  (``pallas/smooth.py:201``): 1 -> cdof[j] f[i] (j an ancestor of i),
  2 -> cdof[i] f[j], 0 -> a structural zero."""
  anc = m.tree.ancestor_mask
  sel = np.zeros(anc.shape, np.float32)
  sel[anc] = 1.0
  sel[anc.T & ~anc] = 2.0
  return sel


def tables(m: types.Model) -> dict:
  """Model tables the kernel walks, as numpy."""
  h = lambda x: np.asarray(types.host(x), np.float32)
  return dict(
      topo=[int(b) for lvl in m.tree.body_levels for b in lvl],
      body_parent=m.body_parentid, body_dofadr=m.body_dofadr,
      body_dofnum=m.body_dofnum, dof_bodyid=m.dof_bodyid,
      ancestor=m.tree.ancestor_mask.astype(np.int32),
      cdofdot=m.tree.cdofdot_mask.astype(np.int32),
      armature=h(m.dof_armature), gravity=h(m.opt.gravity))


_TABLES = TableCache(lambda m, dev: device_tables(tables(m), dev))


def mass_chain_plain(m: types.Model, cinert, cdof, qvel):
  """The plain version of ``mass_chain_lanes`` (``fused/k1_ref.py``)."""
  nb, nv = m.nbody, m.nv
  W = qvel.shape[-1]
  qM, Lf, cvel, cdd, bias = k1_ref.mass_chain(
      m, list(cinert.reshape(nb, 36, W)), list(cdof.reshape(nv, 6, W)),
      qvel, m.dof_armature, m.opt.gravity,
      ancm=ancm_table(m) if big_tree(m) else None)
  return (qM.reshape(nv * nv, W),
          None if Lf is None else Lf.reshape(nv * nv, W), torch.cat(cvel),
          torch.cat(cdd), bias)


def mass_chain_lanes(m: types.Model, cinert, cdof, qvel):
  """The mass chain on lanes-last tensors: cinert (36 nbody, W), cdof
  (6 nv, W), qvel (nv, W).  Returns qM, qLD (nv nv, W; None for a large
  tree), cvel (6 nbody, W), cdof_dot (6 nv, W) and bias (nv, W)."""
  global launches
  nb, nv = m.nbody, m.nv
  W = qvel.shape[-1]
  if qvel.device.type == 'cpu':
    return mass_chain_plain(m, cinert, cdof, qvel)
  if qvel.device.type != 'cuda':
    raise ValueError(f'mass chain runs on cpu or cuda tensors, not '
                     f'{qvel.device}')
  dev = qvel.device
  check(cinert, (36 * nb, W), 'cinert', dev)
  check(cdof, (6 * nv, W), 'cdof', dev)
  check(qvel, (nv, W), 'qvel', dev)
  lib = build.load()
  if lib.mwt_mass_chain_params_size() != ctypes.sizeof(MassChainParams):
    raise RuntimeError('MassChainParams layout differs between C and Python')
  tab = _TABLES.get(m, dev)
  new = lambda rows: torch.empty((rows, W), dtype=torch.float32, device=dev)
  qM, cvel, cdd, bias = new(nv * nv), new(6 * nb), new(6 * nv), new(nv)
  qLD = None if big_tree(m) else new(nv * nv)
  scr = new(lib.mwt_mass_chain_scratch_rows(nb, nv))
  p = MassChainParams(
      W=W, nb=nb, nv=nv,
      no_gravity=int(bool(m.opt.disableflags & types.DisableBit.GRAVITY)),
      cinert=ptr(cinert), cdof=ptr(cdof), qvel=ptr(qvel), qM=ptr(qM),
      qLD=ptr(qLD), cvel=ptr(cvel), cdof_dot=ptr(cdd), bias=ptr(bias),
      scr=ptr(scr), **{k: ptr(tab[k]) for k in _TABLE_PTRS})
  stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.mwt_mass_chain_launch(ctypes.byref(p), ctypes.c_void_p(stream))
  if rc != 0:
    raise RuntimeError(f'mass chain launch failed: cudaError {rc}')
  launches += 1
  return qM, qLD, cvel, cdd, bias


def mass_chain(m: types.Model, d: types.Data) -> types.Data:
  """The batched mass chain on world-major Data after the position stages
  (``pallas/smooth.py`` ``mass_chain`` :246): qM, qLD, cvel, cdof_dot and
  qfrc_bias; a large tree's qLD from the ``chol_batched`` kernel."""
  nb, nv = m.nbody, m.nv
  qM, qLD, cvel, cdd, bias = mass_chain_lanes(
      m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  qM = world(qM, nv, nv)
  if qLD is None:
    qLD = klinalg.chol_batched(m, qM.contiguous(), jitter=BIG_JITTER)
  else:
    qLD = world(qLD, nv, nv)
  return d.replace(qM=qM, qLD=qLD,
                   cvel=world(cvel, nb, 6), cdof_dot=world(cdd, nv, 6),
                   qfrc_bias=bias.T)
