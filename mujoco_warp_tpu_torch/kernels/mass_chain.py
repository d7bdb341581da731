"""Mass-chain wrapper: crb, qM, its Cholesky factor, com_vel, cdof_dot and
the RNE bias of the general step.

CPU tensors run the plain version (``fused/k1_ref.py`` ``mass_chain``);
CUDA tensors launch ``csrc/mass_chain.cu``, which replaces
``mujoco_warp_tpu/pallas/smooth.py`` ``_make_kernel`` (:211, called by
``mass_chain`` :286) in both its forms, one warp per world with the
world's chain in shared memory (``world_floats`` counts its floats;
``fits`` says whether one world fits in a block, and
``ops/forward.unsupported`` refuses a model whose world does not).  A
large tree (``big_tree``: nv > 48 or nbody > 32) skips the factor in the
kernel and writes qM world-major; qLD then comes from the ``chol_batched``
kernel with jitter 1e-12 (``pallas/smooth.py:296-304``), which reads that
qM in place.  A model with tendon armature takes the same large-tree
form at any size (``factor_in_kernel``): the armature term
ten_J^T diag(armature) ten_J (``ops/smooth.py`` ``tendon_armature``) is
added to that qM before ``chol_batched`` factors it; the JAX package
declines such a model in its kernel (``pallas/smooth.py:30``) and
factors the sum in jnp.

The armature and gravity come from the Model's own tensors, each at a
world stride: ``nv`` and 3 where ``io.batch_model`` batched
``dof_armature`` and ``opt.gravity`` (world w reads its own row), 0 where
it did not (every world reads the one row).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import k1_ref
from mujoco_warp_tpu_torch.kernels import TableCache, build, chain_bits, \
    check, device_tables, lanes, ptr, tree_levels, world
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import solver

# launches of the CUDA kernel (not of the plain version)
launches = 0

# the small-tree form (pallas/smooth.py _big_tree :196): beyond it the ancm
# mass chain and the separate factor (pallas/linalg.py chol_batched) run
MAX_NV, MAX_NBODY = 48, 32
# the jitter of the large-tree factor (pallas/smooth.py:303)
BIG_JITTER = 1e-12

_TABLE_PTRS = ('topo', 'level_adr', 'body_parent', 'body_dofadr',
               'body_dofnum', 'dof_bodyid', 'anc_bits', 'rel_bits',
               'cdofdot_bits')
MassChainParams = build.params_struct(
    'MassChainParams', ints=('W', 'nb', 'nv', 'nlevel', 'no_gravity', 'small',
                             'arm_ws', 'grav_ws'),
    ptrs=('cinert', 'cdof', 'qvel', 'qM', 'qLD', 'cvel', 'cdof_dot', 'bias')
    + _TABLE_PTRS + ('armature', 'gravity'))


def big_tree(m: types.Model) -> bool:
  """The large-tree form: no factor in the mass chain."""
  return m.nv > MAX_NV or m.nbody > MAX_NBODY


def factor_in_kernel(m: types.Model) -> bool:
  """Does the kernel factor qM (the small-tree form)?  Not for a large
  tree, nor where a tendon's armature adds to qM after the chain."""
  return not big_tree(m) and not (
      m.ntendon and np.any(types.host(m.tendon_armature) > 0))


def world_floats(nbody: int, nv: int, small: bool) -> int:
  """Shared floats of one world of the kernel (``csrc/mass_chain.cu``
  ``MassChainLayout``): cinert, cdof, qvel, crb, f, cvel, cdof_dot and
  bias, and for the small tree qM, then its factor in the same floats, at
  row stride nv | 1; rounded up to an odd count."""
  n = 78 * nbody + 20 * nv
  if small:
    n += nv * (nv | 1)
  return n | 1


def world_bytes(m: types.Model) -> int:
  """Shared bytes of one world of ``m``."""
  return 4 * world_floats(m.nbody, m.nv, factor_in_kernel(m))


def fits(m: types.Model) -> bool:
  """Does one world of ``m`` fit in the shared memory of a block?"""
  return world_bytes(m) <= solver.SMEM_BLOCK


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
  """The tree tables the kernel walks, as numpy."""
  return dict(
      **tree_levels(m),
      body_parent=m.body_parentid, body_dofadr=m.body_dofadr,
      body_dofnum=m.body_dofnum, dof_bodyid=m.dof_bodyid, **chain_bits(m))


_TABLES = TableCache(lambda m, dev: device_tables(tables(m), dev))


def world_params(m: types.Model, W: int):
  """The armature (1 or W, nv) and gravity (1 or W, 3) of ``m`` for a
  batch of W worlds: batched fields per world, the others as one row
  (``types.world_field``)."""
  arm = types.world_field(m, 'dof_armature')
  grav = types.world_field(m, 'opt.gravity')
  for x, name in ((arm, 'dof_armature'), (grav, 'opt.gravity')):
    if x.shape[0] not in (1, W):
      raise ValueError(f'mass chain: {name} is batched over {x.shape[0]} '
                       f'worlds, the state holds {W}')
  return arm, grav


def mass_chain_plain(m: types.Model, cinert, cdof, qvel):
  """The plain version of ``mass_chain_lanes`` (``fused/k1_ref.py``), its
  outputs in the same layouts."""
  nb, nv = m.nbody, m.nv
  W = qvel.shape[-1]
  small = factor_in_kernel(m)
  arm, grav = world_params(m, W)
  qM, Lf, cvel, cdd, bias = k1_ref.mass_chain(
      m, list(cinert.reshape(nb, 36, W)), list(cdof.reshape(nv, 6, W)),
      qvel, arm.T, grav.T, need_L=small,
      ancm=ancm_table(m) if big_tree(m) else None)
  qM = qM.reshape(nv * nv, W)
  return (qM if small else world(qM, nv, nv).contiguous(),
          None if Lf is None else Lf.reshape(nv * nv, W), torch.cat(cvel),
          torch.cat(cdd), bias)


def mass_chain_lanes(m: types.Model, cinert, cdof, qvel):
  """The mass chain on lanes-last tensors: cinert (36 nbody, W), cdof
  (6 nv, W), qvel (nv, W).  Returns qM (nv nv, W; in the large-tree
  form world-major (W, nv, nv)), qLD (nv nv, W; None in the large-tree
  form), cvel
  (6 nbody, W), cdof_dot (6 nv, W) and bias (nv, W)."""
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
  small = factor_in_kernel(m)
  floats = world_floats(nb, nv, small)
  if 4 * floats > solver.SMEM_BLOCK:
    raise ValueError(f'mass chain: one world (nv {nv}, nbody {nb}) takes '
                     f'{4 * floats} shared bytes, more than a block\'s '
                     f'{solver.SMEM_BLOCK}')
  lib = build.load()
  if lib.mwt_mass_chain_params_size() != ctypes.sizeof(MassChainParams) or \
      lib.mwt_mass_chain_world_floats(nb, nv, int(small)) != floats:
    raise RuntimeError('MassChainParams or the shared layout differs '
                       'between C and Python')
  tab = _TABLES.get(m, dev)
  arm, grav = world_params(m, W)
  check(arm, (arm.shape[0], nv), 'dof_armature', dev)
  check(grav, (grav.shape[0], 3), 'opt.gravity', dev)
  new = lambda rows: torch.empty((rows, W), dtype=torch.float32, device=dev)
  cvel, cdd, bias = new(6 * nb), new(6 * nv), new(nv)
  qM = new(nv * nv) if small else torch.empty(
      (W, nv, nv), dtype=torch.float32, device=dev)
  qLD = new(nv * nv) if small else None
  p = MassChainParams(
      W=W, nb=nb, nv=nv, nlevel=len(m.tree.body_levels),
      no_gravity=int(bool(m.opt.disableflags & types.DisableBit.GRAVITY)),
      small=int(small), arm_ws=nv if arm.shape[0] > 1 else 0,
      grav_ws=3 if grav.shape[0] > 1 else 0, cinert=ptr(cinert),
      cdof=ptr(cdof), qvel=ptr(qvel), qM=ptr(qM), qLD=ptr(qLD),
      cvel=ptr(cvel), cdof_dot=ptr(cdd), bias=ptr(bias),
      armature=ptr(arm), gravity=ptr(grav),
      **{k: ptr(tab[k]) for k in _TABLE_PTRS})
  stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.mwt_mass_chain_launch(ctypes.byref(p), ctypes.c_void_p(stream))
  if rc != 0:
    raise RuntimeError(f'mass chain launch failed: cudaError {rc}')
  launches += 1
  return qM, qLD, cvel, cdd, bias


def mass_chain(m: types.Model, d: types.Data) -> types.Data:
  """The batched mass chain on world-major Data after the position stages
  (``pallas/smooth.py`` ``mass_chain`` :246): qM, qLD, cvel, cdof_dot and
  qfrc_bias; in the large-tree form qLD from the ``chol_batched`` kernel,
  after the tendon armature term where the model has one."""
  nb, nv = m.nbody, m.nv
  qM, qLD, cvel, cdd, bias = mass_chain_lanes(
      m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  if qLD is None:  # qM world-major, read in place
    from mujoco_warp_tpu_torch.ops import smooth
    qM = smooth.tendon_armature(m, d.replace(qM=qM)).qM
    qLD = klinalg.chol_batched(m, qM, jitter=BIG_JITTER)
  else:
    qM, qLD = world(qM, nv, nv), world(qLD, nv, nv)
  return d.replace(qM=qM, qLD=qLD,
                   cvel=world(cvel, nb, 6), cdof_dot=world(cdd, nv, 6),
                   qfrc_bias=bias.T)


def kernel_info(m: types.Model) -> dict:
  """The kernel of ``m``'s form on the card: registers per thread, worlds
  (warps) per block and shared bytes per block at ``m``'s sizes."""
  p = MassChainParams(nb=m.nbody, nv=m.nv, small=int(factor_in_kernel(m)))
  out = (ctypes.c_int * 3)()
  rc = build.load().mwt_mass_chain_info(ctypes.byref(p), out)
  if rc != 0:
    raise RuntimeError(f'mass chain kernel attributes: cudaError {rc}')
  return {'registers': out[0], 'worlds_per_block': out[1],
          'shared_bytes_per_block': out[2]}
