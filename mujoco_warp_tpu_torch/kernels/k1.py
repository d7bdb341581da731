"""K1 wrapper: FK, com quantities, narrowphase and mass chain.

CPU tensors run the plain version (``fused/k1_ref.py``); CUDA tensors
launch ``csrc/k1.cu`` (which replaces ``pallas/fused.py`` ``_make_k1``).
The kernel gives each world one warp and holds the world's frames,
contacts and mass chain in shared memory: ``world_floats`` counts its
floats, and ``fits`` says whether one world fits in a block
(``fused.reason`` sends a model that does not to the general step).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import MAX_NBODY, MAX_NCAND, MAX_NV
from mujoco_warp_tpu_torch.fused import k1_ref
from mujoco_warp_tpu_torch.kernels import TableCache, bit_rows, build, \
    chain_bits, check, device_tables, ptr, tree_levels
from mujoco_warp_tpu_torch.kernels import solver

# launches of the CUDA kernel (not of the plain version)
launches = 0

_INTS = ('W', 'nq', 'nv', 'nbody', 'njnt', 'ngeom', 'ncand', 'ngroup',
         'nlevel', 'need_qld', 'no_gravity')
_PTRS = ('qpos', 'qvel', 'qM', 'qLD', 'bias', 'cdof', 'dist', 'cpos',
         'cframe', 'stcom', 'topo', 'level_adr', 'body_parent', 'body_jntadr',
         'body_jntnum', 'body_rootid', 'body_dofadr', 'body_dofnum',
         'subtree_bits', 'body_pos', 'body_quat', 'body_ipos', 'body_iquat',
         'body_mass', 'body_inertia', 'body_inv_stm', 'jnt_type',
         'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid', 'jnt_pos', 'jnt_axis',
         'jnt_qpos0', 'dof_bodyid', 'anc_bits', 'rel_bits', 'cdofdot_bits',
         'armature', 'gravity', 'geom_bodyid', 'geom_pos', 'geom_quat',
         'geom_size', 'group', 'pair_g1', 'pair_g2')
K1Params = build.params_struct('K1Params', ints=_INTS, ptrs=_PTRS)


def run_col(m: types.Model) -> bool:
  """Does K1 run the narrowphase for ``m``?"""
  return bool(m.opt.run_collision_detection) and m.ncand > 0


def world_floats(nq: int, nv: int, nbody: int, njnt: int, ngeom: int,
                 ncand: int, factor: bool) -> int:
  """Shared floats of one world of the kernel (``csrc/k1.cu``
  ``K1Layout``; ngeom and ncand 0 without collision): qpos, qvel,
  subtree_com, cinert, cdof and bias, then the larger of the frames'
  region (the geom frames, and the larger of the body and joint frames
  and the contacts, 13 floats each, which take the same floats) and the
  mass chain's (qM, crb, f, cvel, cdof_dot, and the factor at row stride
  nv | 1); rounded up to an odd count."""
  base = nq + nv + 39 * nbody + 7 * nv
  frames = 12 * ngeom + max(19 * nbody + 6 * njnt, 13 * ncand)
  chain = nv * nv + 42 * nbody + 12 * nv + (nv * (nv | 1) if factor else 0)
  return (base + max(frames, chain)) | 1


def _sizes(m: types.Model, need_qLD: bool) -> tuple:
  """``world_floats``' arguments for ``m``: ngeom and ncand 0 without
  collision."""
  col = run_col(m)
  return (m.nq, m.nv, m.nbody, m.njnt, m.ngeom if col else 0,
          m.ncand if col else 0, need_qLD)


def world_bytes(m: types.Model, need_qLD: bool = True) -> int:
  """Shared bytes of one world of ``m`` (with the factor unless told
  otherwise)."""
  return 4 * world_floats(*_sizes(m, need_qLD))


def fits(m: types.Model) -> bool:
  """Does one world of ``m``, with the factor, fit in the shared memory of
  a block?"""
  return world_bytes(m) <= solver.SMEM_BLOCK


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
      **tree_levels(m),
      body_parent=m.body_parentid, body_jntadr=m.body_jntadr,
      body_jntnum=m.body_jntnum, body_rootid=m.body_rootid,
      body_dofadr=dofadr, body_dofnum=dofnum,
      subtree_bits=bit_rows(m.tree.subtree_mask),
      body_pos=f32(h(m.body_pos)), body_quat=f32(h(m.body_quat)),
      body_ipos=f32(h(m.body_ipos)), body_iquat=f32(h(m.body_iquat)),
      body_mass=f32(h(m.body_mass)), body_inertia=f32(h(m.body_inertia)),
      body_inv_stm=f32(1.0 / np.maximum(stm, 1e-12)),
      jnt_type=m.jnt_type, jnt_qposadr=m.jnt_qposadr,
      jnt_dofadr=m.jnt_dofadr, jnt_bodyid=m.jnt_bodyid,
      jnt_pos=f32(h(m.jnt_pos)), jnt_axis=f32(h(m.jnt_axis)),
      jnt_qpos0=f32(h(m.qpos0)[m.jnt_qposadr]),
      dof_bodyid=m.dof_bodyid, **chain_bits(m),
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
  nv, nb = m.nv, m.nbody
  check(qpos, (m.nq, W), 'qpos', dev)
  check(qvel, (nv, W), 'qvel', dev)
  col = run_col(m)
  sizes = _sizes(m, need_qLD)
  ng, nc = sizes[4:6]
  floats = world_floats(*sizes)
  if 4 * floats > solver.SMEM_BLOCK:
    raise ValueError(f'K1: one world takes {4 * floats} shared bytes, more '
                     f'than a block\'s {solver.SMEM_BLOCK}')
  lib = build.load()
  if lib.mwt_k1_params_size() != ctypes.sizeof(K1Params) or \
      lib.mwt_k1_world_floats(*sizes[:6], int(need_qLD)) != floats:
    raise RuntimeError('K1Params or the shared layout differs between C '
                       'and Python')
  tab = _TABLES.get(m, dev)
  new = lambda rows: torch.empty((rows, W), dtype=torch.float32, device=dev)
  qM = new(nv * nv)
  qLD = new(nv * nv) if need_qLD else None
  bias, cdof, stcom = new(nv), new(6 * nv), new(3 * nb)
  dist, cpos, cframe = (new(nc), new(3 * nc), new(9 * nc)) if col else \
      (None, None, None)
  p = K1Params(
      W=W, nq=m.nq, nv=nv, nbody=nb, njnt=m.njnt, ngeom=ng, ncand=nc,
      ngroup=len(m.pair_groups) if col else 0,
      nlevel=len(m.tree.body_levels), need_qld=int(need_qLD),
      no_gravity=int(bool(m.opt.disableflags & types.DisableBit.GRAVITY)),
      qpos=ptr(qpos), qvel=ptr(qvel), qM=ptr(qM), qLD=ptr(qLD),
      bias=ptr(bias), cdof=ptr(cdof), dist=ptr(dist), cpos=ptr(cpos),
      cframe=ptr(cframe), stcom=ptr(stcom),
      **{k: ptr(v) for k, v in tab.items()})
  stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.mwt_k1_launch(ctypes.byref(p), ctypes.c_void_p(stream))
  if rc != 0:
    raise RuntimeError(f'K1 launch failed: cudaError {rc}')
  launches += 1
  return (qM, qLD, bias, cdof, dist, cpos, cframe,
          stcom if col else None)


def kernel_info(m: types.Model, need_qLD: bool = False) -> dict:
  """The kernel on the card: registers per thread, worlds (warps) per
  block and shared bytes per block at ``m``'s sizes (by default without
  the factor, as the fused step calls it for a model with rows)."""
  nq, nv, nbody, njnt, ngeom, ncand, _ = _sizes(m, need_qLD)
  p = K1Params(nq=nq, nv=nv, nbody=nbody, njnt=njnt, ngeom=ngeom,
               ncand=ncand, need_qld=int(need_qLD))
  out = (ctypes.c_int * 3)()
  rc = build.load().mwt_k1_info(ctypes.byref(p), out)
  if rc != 0:
    raise RuntimeError(f'K1 kernel attributes: cudaError {rc}')
  return {'registers': out[0], 'worlds_per_block': out[1],
          'shared_bytes_per_block': out[2]}
