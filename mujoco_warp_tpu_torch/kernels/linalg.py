"""Batched Cholesky kernels of the general step: the factor of a batch of
SPD matrices (the large-tree mass factor and the large-system Newton H),
qacc_smooth from the mass factor, and Euler's implicit-damping solve.

Each function has its plain PyTorch version here (``*_plain``), built on
the lane Cholesky of ``fused/solver_ref.py`` (``_chol_tile`` and
``_chol_solve_tile`` of ``pallas/solver.py``, with their 1e-15 floors).
CPU tensors run the plain version; CUDA tensors launch ``csrc/linalg.cu``,
which replaces ``mujoco_warp_tpu/pallas/linalg.py`` ``chol_batched``
(:65), ``chol_solve_batched`` (:109) and ``damped_solve_batched`` (:145).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused.solver_ref import chol_solve_tile, chol_tile
from mujoco_warp_tpu_torch.kernels import TableCache, build, check, \
    device_tables, lanes, ptr

# launches of the CUDA kernels (not of the plain versions)
launches = {'chol_batched': 0, 'chol_solve': 0, 'damped_solve': 0}

# the kernels' size cap (csrc/common.cuh MWT_LINALG_MAX_N): it sizes the
# per-thread arrays of chol_solve and damped_solve, and chol_batched's
# shared memory (n (n | 1) floats per world)
MAX_N = 128

CholBatchedParams = build.params_struct(
    'CholBatchedParams', ints=('W', 'n'), floats=('jitter',),
    ptrs=('A', 'L'))
CholSolveParams = build.params_struct('CholSolveParams', ints=('W', 'n'),
                                      ptrs=('L', 'b', 'x'))
DampedSolveParams = build.params_struct(
    'DampedSolveParams', ints=('W', 'n'), ptrs=('M', 'a', 'dmp', 'x', 'scr'))


def damping_terms(m: types.Model) -> np.ndarray:
  """h * damping per dof, the float32 product the JAX kernel takes."""
  return np.float32(types.host(m.opt.timestep, np.float32)) * \
      types.host(m.dof_damping, np.float32)


_DMP = TableCache(lambda m, dev: device_tables({'dmp': damping_terms(m)},
                                               dev)['dmp'])


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
  """(M + diag(dmp))^-1 (M a), lanes-last: M (n n, W), a (n, W), dmp (n,)."""
  n = a.shape[0]
  M3 = M.reshape(n, n, -1)
  eye = torch.eye(n, dtype=M.dtype, device=M.device)
  A = M3 + eye[:, :, None] * dmp[:, None, None]
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


def chol_batched(m: types.Model, A, jitter: float = 0.0):
  """L with L L^T = A + jitter I for world-major A (W, n, n)
  (``pallas/linalg.py`` ``chol_batched`` :65); the kernel reads and
  writes world-major.  A CPU tensor takes the plain version, after the
  same checks."""
  W, n = A.shape[0], A.shape[-1]
  _cap(n, 'chol_batched')
  check(A, (W, n, n), 'A', A.device)
  if not _device(A, 'chol_batched'):
    return chol_batched_plain(A, jitter)
  L = torch.empty_like(A)
  with torch.cuda.device(A.device):
    _launch('chol_batched', CholBatchedParams, W=W, n=n, jitter=jitter,
            A=ptr(A), L=ptr(L))
  return L


def chol_solve_lanes(L, b):
  """x = (L L^T)^-1 b on lanes-last tensors L (n n, W), b (n, W)."""
  if not _device(b, 'chol_solve'):
    return chol_solve_plain(L, b)
  n, W = b.shape
  _cap(n, 'chol_solve')
  check(L, (n * n, W), 'L', b.device)
  check(b, (n, W), 'b', b.device)
  x = torch.empty_like(b)
  with torch.cuda.device(b.device):
    _launch('chol_solve', CholSolveParams, W=W, n=n, L=ptr(L), b=ptr(b),
            x=ptr(x))
  return x


def damped_solve_lanes(m: types.Model, M, a):
  """(M + h diag(damping))^-1 (M a) on lanes-last tensors M (nv nv, W),
  a (nv, W), with h and damping of ``m``."""
  if not _device(a, 'damped_solve'):
    dmp = torch.as_tensor(damping_terms(m), device=a.device)
    return damped_solve_plain(M, a, dmp)
  n, W = a.shape
  if n != m.nv:
    raise ValueError(f'damped_solve: n {n}, model nv {m.nv}')
  _cap(n, 'damped_solve')
  check(M, (n * n, W), 'M', a.device)
  check(a, (n, W), 'a', a.device)
  x = torch.empty_like(a)
  scr = torch.empty((n * n, W), dtype=torch.float32, device=a.device)
  with torch.cuda.device(a.device):
    _launch('damped_solve', DampedSolveParams, W=W, n=n, M=ptr(M), a=ptr(a),
            dmp=ptr(_DMP.get(m, a.device)), x=ptr(x), scr=ptr(scr))
  return x


def chol_solve_batched(m: types.Model, qLD, rhs):
  """x = (L L^T)^-1 rhs for world-major qLD (W, n, n) and rhs (W, n)
  (``pallas/linalg.py`` ``chol_solve_batched`` :109)."""
  n = rhs.shape[1]
  return chol_solve_lanes(lanes(qLD, n * n), lanes(rhs)).T


def damped_solve_batched(m: types.Model, qM, qacc):
  """(M + h diag(damping))^-1 (M qacc) for world-major qM (W, nv, nv) and
  qacc (W, nv), h and damping from ``m`` (``pallas/linalg.py``
  ``damped_solve_batched`` :145)."""
  n = qacc.shape[1]
  return damped_solve_lanes(m, lanes(qM, n * n), lanes(qacc)).T
