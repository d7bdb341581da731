"""Batched Cholesky kernels of the general step: the factor of a batch of
SPD matrices (the large-tree mass factor and the large-system Newton H),
qacc_smooth from the mass factor, and Euler's implicit-damping solve.

Each function has its plain PyTorch version here (``*_plain``), built on
the lane Cholesky of ``fused/solver_ref.py`` (``_chol_tile`` and
``_chol_solve_tile`` of ``pallas/solver.py``, with their 1e-15 floors).
CPU tensors run the plain version; CUDA tensors launch ``csrc/linalg.cu``,
which replaces ``mujoco_warp_tpu/pallas/linalg.py`` ``chol_batched``
(:65), ``chol_solve_batched`` (:109) and ``damped_solve_batched`` (:145).

The world-major entries (``*_batched``) take each (W, n, n) matrix and
(W, n) vector world-major or as a ``world()`` view of a lanes-last
tensor: ``chol_solve`` and ``damped_solve`` read either in place at the
strides the tensor has, so no copy surrounds their launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused.solver_ref import chol_solve_tile, chol_tile
from mujoco_warp_tpu_torch.kernels import build, check, host_dtype, ptr

# launches of the CUDA kernels (not of the plain versions)
launches = {'chol_batched': 0, 'chol_solve': 0, 'damped_solve': 0}

# the kernels' size cap: one world's matrix lies in shared memory, n (n |
# 1) floats (66 KB at 128)
MAX_N = 128

CholBatchedParams = build.params_struct(
    'CholBatchedParams', ints=('W', 'n'), floats=('jitter',),
    ptrs=('A', 'L'))
CholSolveParams = build.params_struct(
    'CholSolveParams', ints=('W', 'n', 'L_ws', 'L_es', 'b_ws', 'b_es'),
    ptrs=('L', 'b', 'x'))
DampedSolveParams = build.params_struct(
    'DampedSolveParams',
    ints=('W', 'n', 'M_ws', 'M_es', 'a_ws', 'a_es', 'dmp_ws'),
    floats=('h',), ptrs=('M', 'a', 'damping', 'x'))


def world_damping(m: types.Model, dtype=torch.float32) -> torch.Tensor:
  """h * damping of ``m`` as the plain damped solve takes it: lanes-last
  (n, W) where ``dof_damping`` is batched, (n, 1) where it is not; each
  product rounded to ``dtype``, as the kernel rounds it."""
  h = torch.as_tensor(m.opt.timestep, dtype=dtype)
  damping = torch.as_tensor(types.world_field(m, 'dof_damping'), dtype=dtype)
  return (h.to(damping.device) * damping).T


def chol_batched_plain(A, jitter: float = 0.0):
  """L with L L^T = A + jitter I, world-major A (W, n, n) -> (W, n, n),
  zero above the diagonal."""
  n = A.shape[-1]
  if jitter:
    A = A + torch.eye(n, dtype=A.dtype, device=A.device) * jitter
  return chol_tile(A.permute(1, 2, 0), n).permute(2, 0, 1).contiguous()


def chol_solve_plain(L, b):
  """x = (L L^T)^-1 b, lanes-last: L (n n, W), b (n, W)."""
  n = b.shape[0]
  return chol_solve_tile(L.reshape(n, n, -1), b, n)


def damped_solve_plain(M, a, dmp):
  """(M + diag(dmp))^-1 (M a), lanes-last: M (n n, W), a (n, W), dmp (n,)
  for every world or (n, W) for each its own (``world_damping``)."""
  n = a.shape[0]
  M3 = M.reshape(n, n, -1)
  eye = torch.eye(n, dtype=M.dtype, device=M.device)
  A = M3 + eye[:, :, None] * dmp.reshape(n, 1, -1)
  return chol_solve_tile(chol_tile(A, n), torch.sum(M3 * a[None], dim=1), n)


def _launch(name, params_cls, **kw):
  lib = build.load()
  if getattr(lib, f'mwt_{name}_params_size')() != ctypes.sizeof(params_cls):
    raise RuntimeError(f'{params_cls.__name__} layout differs between C '
                       'and Python')
  p = params_cls(**kw)
  dev = torch.device('cuda')
  stream = torch.cuda.current_stream(dev).cuda_stream
  rc = getattr(lib, f'mwt_{name}_launch')(ctypes.byref(p),
                                          ctypes.c_void_p(stream))
  if rc != 0:
    raise RuntimeError(f'{name} launch failed: cudaError {rc}')
  launches[name] += 1


def _device(x, what):
  if x.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'{what} runs on cpu or cuda tensors, not {x.device}')
  return x.device.type == 'cuda'


def _cap(n, what):
  if n > MAX_N:
    raise ValueError(f'{what} caps n at {MAX_N}, got {n}')


def strides(t, shape, name, device, dtype=torch.float32):
  """(world stride, element stride) of a ``dtype`` tensor of ``shape``
  (W, n) or (W, n, n) on ``device`` whose elements (row-major within a
  world) lie one element stride apart: world-major, or a ``world()`` view
  of lanes-last.  Raises for any other layout; a float64 CUDA tensor
  raises a TypeError."""
  if not isinstance(t, torch.Tensor):
    raise TypeError(f'{name}: expected a tensor, got {type(t).__name__}')
  if t.device.type == 'cuda' and t.dtype != torch.float32:
    raise TypeError(f'{name}: {t.dtype} on {t.device}: the CUDA kernels '
                    'take float32 (the float64 path runs on the CPU)')
  if t.device != device or t.dtype != dtype or \
      tuple(t.shape) != tuple(shape):
    raise ValueError(f'{name}: {tuple(t.shape)} {t.dtype} on {t.device}, '
                     f'expected {tuple(shape)} {dtype} on {device}')
  es = t.stride(-1)
  if len(shape) == 3 and shape[1] > 1 and t.stride(1) != shape[2] * es:
    raise ValueError(f'{name}: strides {t.stride()} do not place a '
                     'world\'s elements one element stride apart')
  if max(t.stride(0), es) >= 2 ** 31:
    raise ValueError(f'{name}: strides {t.stride()} beyond int32')
  return t.stride(0), es


def read(t, rows: int, st):
  """The (rows, W) lanes-last operand as the kernels read ``t``: element
  e of world w at ``t``'s storage offset + w ws + e es, for ``st`` = (ws,
  es) from ``strides``.  A view of ``t``'s storage, not a copy."""
  return torch.as_strided(t, (rows, t.shape[0]), (st[1], st[0]))


def chol_batched(m: types.Model, A, jitter: float = 0.0):
  """L with L L^T = A + jitter I for world-major A (W, n, n)
  (``pallas/linalg.py`` ``chol_batched`` :65); the kernel reads and
  writes world-major.  A CPU tensor takes the plain version, after the
  same checks."""
  W, n = A.shape[0], A.shape[-1]
  _cap(n, 'chol_batched')
  check(A, (W, n, n), 'A', A.device, host_dtype(A))
  if not _device(A, 'chol_batched'):
    return chol_batched_plain(A, jitter)
  L = torch.empty_like(A)
  with torch.cuda.device(A.device):
    _launch('chol_batched', CholBatchedParams, W=W, n=n, jitter=jitter,
            A=ptr(A), L=ptr(L))
  return L


def chol_batched_info(n: int) -> dict:
  """``chol_batched``'s kernel on the card at size n: registers per
  thread, worlds (warps) per block and shared bytes per block."""
  out = (ctypes.c_int * 3)()
  rc = build.load().mwt_chol_batched_info(n, out)
  if rc != 0:
    raise RuntimeError(f'chol_batched kernel attributes: cudaError {rc}')
  return {'registers': out[0], 'worlds_per_block': out[1],
          'shared_bytes_per_block': out[2]}


def chol_solve_batched(m: types.Model, L, rhs):
  """x = (L L^T)^-1 rhs for L (W, n, n) and rhs (W, n), each world-major
  or a ``world()`` view of lanes-last (``pallas/linalg.py``
  ``chol_solve_batched`` :109); x (W, n) world-major.  The kernel reads
  only L's lower triangle.  A CPU tensor takes the plain version, after
  the same layout checks, on its operands read at the strides the kernel
  takes (``read``)."""
  W, n = rhs.shape
  on_card = _device(rhs, 'chol_solve')
  bs = strides(rhs, (W, n), 'rhs', rhs.device, host_dtype(rhs))
  ls = strides(L, (W, n, n), 'L', rhs.device, rhs.dtype)
  if not on_card:
    return chol_solve_plain(read(L, n * n, ls), read(rhs, n, bs)).T
  _cap(n, 'chol_solve')
  x = torch.empty((W, n), dtype=torch.float32, device=rhs.device)
  with torch.cuda.device(rhs.device):
    _launch('chol_solve', CholSolveParams, W=W, n=n, L_ws=ls[0], L_es=ls[1],
            b_ws=bs[0], b_es=bs[1], L=ptr(L), b=ptr(rhs), x=ptr(x))
  return x


def damped_solve_batched(m: types.Model, qM, qacc):
  """(M + h diag(damping))^-1 (M qacc) for qM (W, nv, nv) and qacc (W,
  nv), each world-major or a ``world()`` view of lanes-last, h and
  damping from ``m`` (``pallas/linalg.py`` ``damped_solve_batched``
  :145), a batched ``dof_damping`` per world; x (W, nv) world-major.
  The kernel reads the damping where the Model holds it and forms h
  damping itself.  A CPU tensor takes the plain version, after the same
  checks, on its operands read at the strides the kernel takes
  (``read``)."""
  W, n = qacc.shape
  on_card = _device(qacc, 'damped_solve')
  as_ = strides(qacc, (W, n), 'qacc', qacc.device, host_dtype(qacc))
  ms = strides(qM, (W, n, n), 'qM', qacc.device, qacc.dtype)
  if n != m.nv:
    raise ValueError(f'damped_solve: n {n}, model nv {m.nv}')
  # the Model's own tensor, no copy (a stand-in's array is copied)
  damping = torch.as_tensor(types.world_field(m, 'dof_damping'),
                            dtype=qacc.dtype, device=qacc.device)
  if damping.shape[0] not in (1, W):
    raise ValueError(f'damped_solve: dof_damping is batched over '
                     f'{damping.shape[0]} worlds, the state holds {W}')
  if not on_card:
    return damped_solve_plain(read(qM, n * n, ms), read(qacc, n, as_),
                              world_damping(m, qacc.dtype)).T
  _cap(n, 'damped_solve')
  check(damping, (damping.shape[0], n), 'dof_damping', qacc.device)
  x = torch.empty((W, n), dtype=torch.float32, device=qacc.device)
  with torch.cuda.device(qacc.device):
    _launch('damped_solve', DampedSolveParams, W=W, n=n, M_ws=ms[0],
            M_es=ms[1], a_ws=as_[0], a_es=as_[1],
            dmp_ws=n if damping.shape[0] > 1 else 0,
            h=float(types.host(m.opt.timestep, np.float32)), M=ptr(qM),
            a=ptr(qacc), damping=ptr(damping), x=ptr(x))
  return x
