"""Standalone Newton solve wrapper of the general step.

CPU tensors run the plain version (``fused/solver_ref.py``
``solve_tiles``); CUDA tensors launch ``csrc/solve.cu``, which replaces
``mujoco_warp_tpu/pallas/solver.py`` ``_make_kernel`` (:1041, called by
``_solve_tiles`` :1126 from ``solve_batched`` :1145): ``solve_kernel``
for equality, friction-loss, limit and frictionless or pyramidal contact
rows, ``solve_ell_kernel`` for a model with elliptic contacts.  The
kernel gives each world one warp and holds the world's system in shared
memory: ``world_floats`` counts its floats, and ``fits`` says whether one
world fits in a block (``ops/forward.py`` sends a model that does not to
the torch Newton, as the JAX package bounds its kernel's VMEM).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import MAX_NV, solver_ref
from mujoco_warp_tpu_torch.kernels import TableCache, build, check, \
    device_tables, ptr

# launches of the CUDA kernel (not of the plain version)
launches = 0

# row kinds of the shared Newton (csrc/newton.cuh)
ROW_INEQ, ROW_EQ, ROW_FRI, ROW_ELL = 0, 1, 2, 3

# the elliptic form's per-contact terms (csrc/solve.cu CONE_N: the cone
# block's, which outnumber the linesearch's EC_N of csrc/newton.cuh)
CONE_N = 20
# shared memory one block may use on the card
SMEM_BLOCK = 232448

SolveParams = build.params_struct(
    'SolveParams',
    ints=('W', 'nv', 'nefc', 'ncon', 'iterations', 'ls_iterations',
          'tol_stride', 'ls_tol_stride'),
    floats=('meaninertia',),
    ptrs=('tol', 'ls_tol', 'J', 'D', 'aref', 'fl', 'M', 'qfs', 'qacc0',
          'qacc_out', 'force_out', 'qfrc_out', 'niter_out', 'kind', 's',
          'etab'))


def world_scalar(m: types.Model, name: str, W: int, dev):
  """A float32 Option field the kernel reads per world, on ``dev``, and
  its world stride: (W,) at stride 1 where it is batched, the Model's
  0-d tensor at stride 0 where it is not."""
  x = types.get_model_field(m, name).to(dev)  # no copy for a card Model
  if name in m.batch_fields:
    check(x, (W,), name, dev)
    return x, 1
  check(x, (), name, dev)
  return x, 0


def ell_ncon(m: types.Model) -> int:
  """The contacts the elliptic form walks (m.ncon), 0 without elliptic
  contacts."""
  return m.ncon if solver_ref.ell_groups(m) else 0


def world_floats(nefc: int, nv: int, ncon: int) -> int:
  """Shared floats of one world of the kernel (``csrc/solve.cu``
  ``SolveLayout``): J, M and L at row stride nv | 1, seven per-row slots,
  for elliptic contacts (ncon > 0) two more and the per-contact terms,
  six vectors of nv and 16-bit row lists."""
  ld, ne = nv | 1, (nefc if ncon else 0)
  return (nefc * ld + 2 * nv * ld + 7 * nefc + 2 * ne + CONE_N * ncon +
          6 * nv + 1 +
          (3 * nefc + 2 * ncon + 1) // 2)


def fits(m: types.Model) -> bool:
  """Does one world of ``m`` fit in the shared memory of a block?"""
  return 4 * world_floats(m.nefc, m.nv, ell_ncon(m)) <= SMEM_BLOCK


def row_kinds(m: types.Model) -> np.ndarray:
  """(nefc,) ROW_EQ for equality rows, ROW_FRI for friction-loss rows,
  ROW_ELL for the rows of elliptic contacts, ROW_INEQ for the rest
  (``pallas/solver.py`` ``_masks`` :133, ``_ell_perm`` :70)."""
  t = m.efc.efc_type
  _CT = types.ConstraintType
  kind = np.full(len(t), ROW_INEQ, np.int32)
  kind[t == _CT.EQUALITY] = ROW_EQ
  kind[(t == _CT.FRICTION_DOF) | (t == _CT.FRICTION_TENDON)] = ROW_FRI
  for _, _, rows in solver_ref.ell_groups(m):
    kind[rows.reshape(-1)] = ROW_ELL
  return kind


def ell_table(m: types.Model) -> np.ndarray:
  """(nefc, 3) int32 per row: its place in its elliptic contact, the
  contact's dim and the contact's index (zeros on the other rows)."""
  tab = np.zeros((m.nefc, 3), np.int32)
  for d0, ids, rows in solver_ref.ell_groups(m):
    tab[rows, 0] = np.arange(d0)
    tab[rows, 1] = d0
    tab[rows, 2] = ids[:, None]
  return tab


_TABLES = TableCache(lambda m, dev: device_tables(
    {'kind': row_kinds(m), 'etab': ell_table(m)}, dev))


def solve_tiles(m: types.Model, J, D, aref, fl, M, qfs, qacc0, s=None):
  """The Newton solve on lanes-last tensors: J (nefc, nv, W), D, aref, fl
  (nefc, W), M (nv, nv, W), qfs and qacc0 (nv, W), and for a model with
  elliptic contacts their row scales s (nefc, W)
  (``solver_ref.ell_scales``).  Each world stops on its own
  ``opt.tolerance`` and ``opt.ls_tolerance`` where they are batched
  (``world_scalar``).  Returns qacc (nv, W), efc_force (nefc, W),
  qfrc_constraint (nv, W) and niter (1, W) int32."""
  global launches
  if qfs.device.type == 'cpu':
    return solver_ref.solve_tiles(m, J, D, aref, fl, M, qfs, qacc0, s)
  if qfs.device.type != 'cuda':
    raise ValueError(f'solve runs on cpu or cuda tensors, not {qfs.device}')
  dev = qfs.device
  nefc, nv = m.nefc, m.nv
  W = qfs.shape[-1]
  if nv > MAX_NV:
    raise ValueError(f'solve caps nv at {MAX_NV}, got {nv}')
  check(J, (nefc, nv, W), 'J', dev)
  for t, name in ((D, 'D'), (aref, 'aref'), (fl, 'fl')):
    check(t, (nefc, W), name, dev)
  check(M, (nv, nv, W), 'M', dev)
  check(qfs, (nv, W), 'qfs', dev)
  check(qacc0, (nv, W), 'qacc0', dev)
  if not fits(m):
    raise ValueError(f'solve: one world (nefc {nefc}, nv {nv}) does not fit '
                     'in a block\'s shared memory')
  ncon = ell_ncon(m)
  if ncon:
    if s is None:
      raise ValueError('elliptic contacts need their row scales s')
    check(s, (nefc, W), 's', dev)
  lib = build.load()
  if lib.mwt_solve_params_size() != ctypes.sizeof(SolveParams) or \
      lib.mwt_solve_world_floats(nefc, nv, ncon) != world_floats(nefc, nv,
                                                                 ncon):
    raise RuntimeError('SolveParams or the shared layout differs between C '
                       'and Python')
  new = lambda rows, dt=torch.float32: torch.empty((rows, W), dtype=dt,
                                                   device=dev)
  qacc, force, qfrc, niter = new(nv), new(nefc), new(nv), new(1, torch.int32)
  tol, tol_stride = world_scalar(m, 'opt.tolerance', W, dev)
  ls_tol, ls_stride = world_scalar(m, 'opt.ls_tolerance', W, dev)
  mi = float(types.host(m.stat.meaninertia, np.float32))
  tab = _TABLES.get(m, dev)
  p = SolveParams(
      W=W, nv=nv, nefc=nefc, ncon=ncon, iterations=int(m.opt.iterations),
      ls_iterations=int(m.opt.ls_iterations), tol_stride=tol_stride,
      ls_tol_stride=ls_stride, meaninertia=mi, tol=ptr(tol),
      ls_tol=ptr(ls_tol), J=ptr(J), D=ptr(D), aref=ptr(aref), fl=ptr(fl),
      M=ptr(M), qfs=ptr(qfs), qacc0=ptr(qacc0), qacc_out=ptr(qacc),
      force_out=ptr(force), qfrc_out=ptr(qfrc), niter_out=ptr(niter),
      kind=ptr(tab['kind']), s=ptr(s if ncon else None),
      etab=ptr(tab['etab']))
  stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.mwt_solve_launch(ctypes.byref(p), ctypes.c_void_p(stream))
  if rc != 0:
    raise RuntimeError(f'solve launch failed: cudaError {rc}')
  launches += 1
  return qacc, force, qfrc, niter


def kernel_info(m: types.Model) -> dict:
  """The kernel of ``m``'s form on the card: registers per thread, worlds
  (warps) per block and shared bytes per block at ``m``'s sizes."""
  ncon = ell_ncon(m)
  # a non-null s selects the elliptic form; nothing is read through it
  p = SolveParams(nv=m.nv, nefc=m.nefc, ncon=ncon,
                  s=ctypes.c_void_p(1 if ncon else 0))
  out = (ctypes.c_int * 3)()
  rc = build.load().mwt_solve_info(ctypes.byref(p), out)
  if rc != 0:
    raise RuntimeError(f'solve kernel attributes: cudaError {rc}')
  return {'registers': out[0], 'worlds_per_block': out[1],
          'shared_bytes_per_block': out[2]}


def solve_batched(m: types.Model, d: types.Data) -> types.Data:
  """The batched Newton solve on world-major Data (``pallas/solver.py``
  ``solve_batched`` :1145) through ``solve_tiles``."""
  return solver_ref.solve_batched(m, d, solve=solve_tiles)
