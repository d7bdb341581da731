"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

The sources under ``kernels/csrc`` compile for Hopper (``sm_90a``), one
nvcc per source started together, into one shared library with a plain C
interface.  The library is built at
first use into ``build/mujoco_warp_tpu_torch/`` at the repository root,
under a name carrying the hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'mujoco_warp_tpu_torch')
# --fmad=false keeps a*b+c as a rounded product and a rounded sum, as the
# plain PyTorch versions compute it, so kernel and plain version agree to
# the order of summation
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


# the kernels of the library: each has mwt_<name>_launch(params, stream)
# and mwt_<name>_params_size()
KERNELS = ('k1', 'k4', 'mass_chain', 'solve', 'chol_batched', 'chol_solve',
           'damped_solve')
# other entry points: name -> argument types (each returns an int)
_P, _I = ctypes.c_void_p, ctypes.c_int
EXTRA = {'mwt_solve_world_floats': [_I, _I, _I],
         'mwt_solve_info': [_P, _P], 'mwt_chol_batched_info': [_I, _P],
         'mwt_k4_world_floats': [_I, _I, _I], 'mwt_k4_info': [_P, _P],
         'mwt_k1_world_floats': [_I] * 7, 'mwt_k1_info': [_P, _P],
         'mwt_mass_chain_world_floats': [_I, _I, _I],
         'mwt_mass_chain_info': [_P, _P]}


class BuildInfo:
  """What the last ``load`` did: library path, seconds spent in nvcc (0
  when the library was already built) and nvcc's output."""

  path = None
  seconds = 0.0
  log = ''


_LIB = None


def _sources():
  return sorted(glob.glob(os.path.join(CSRC, '*.cu')) +
                glob.glob(os.path.join(CSRC, '*.cuh')))


def nvcc_path() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  cand = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin',
                      'nvcc')
  if os.path.exists(cand):
    return cand
  raise RuntimeError('nvcc not found: the CUDA kernels build on a machine '
                     'with the CUDA toolkit')


def _compile_all(cus, stem):
  """One nvcc per source, all started together; returns the objects."""
  procs = []
  for cu in cus:
    obj = f'{stem}.{os.path.basename(cu)}.o'
    cmd = [nvcc_path()] + NVCC_FLAGS + ['-c', '-o', obj, cu]
    procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True)))
  log, failed = [], []
  for obj, proc in procs:
    out, _ = proc.communicate()
    log.append(out)
    if proc.returncode != 0:
      failed.append(obj)
  BuildInfo.log = ''.join(log)
  if failed:
    raise RuntimeError(f'nvcc failed for {failed}:\n{BuildInfo.log}')
  return [obj for obj, _ in procs]


def load() -> ctypes.CDLL:
  """The kernel library, built first if its sources changed."""
  global _LIB
  if _LIB is not None:
    return _LIB
  srcs = _sources()
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for src in srcs:
    with open(src, 'rb') as f:
      h.update(os.path.basename(src).encode() + f.read())
  path = os.path.join(BUILD_DIR, f'libmwt_kernels_{h.hexdigest()[:16]}.so')
  if not os.path.exists(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    t0 = time.perf_counter()
    objs = _compile_all([s for s in srcs if s.endswith('.cu')], tmp)
    res = subprocess.run([nvcc_path(), '-shared', '-o', tmp] + objs,
                         capture_output=True, text=True)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log += res.stdout + res.stderr
    for o in objs:
      os.remove(o)
    if res.returncode != 0:
      raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                         f'{BuildInfo.log}')
    os.replace(tmp, path)
  BuildInfo.path = path
  lib = ctypes.CDLL(path)
  for k in KERNELS:
    fn = getattr(lib, f'mwt_{k}_launch')
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    getattr(lib, f'mwt_{k}_params_size').restype = ctypes.c_int
  for name, args in EXTRA.items():
    fn = getattr(lib, name)
    fn.argtypes = args
    fn.restype = ctypes.c_int
  _LIB = lib
  return lib


def params_struct(name, ints=(), floats=(), ptrs=()):
  """A ctypes mirror of a C parameter struct: ints, then floats, then
  pointers, in declaration order."""
  fields = ([(n, ctypes.c_int) for n in ints] +
            [(n, ctypes.c_float) for n in floats] +
            [(n, ctypes.c_void_p) for n in ptrs])
  return type(name, (ctypes.Structure,), {'_fields_': fields})
