"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

The sources under ``kernels/csrc`` compile for Hopper (``sm_90a``) into
one shared library with a plain C interface.  The library is built at
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
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']


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
    cmd = [nvcc_path()] + NVCC_FLAGS + ['-o', tmp] + \
        [s for s in srcs if s.endswith('.cu')]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = res.stdout + res.stderr
    if res.returncode != 0:
      raise RuntimeError(f'nvcc failed ({res.returncode}):\n{BuildInfo.log}')
    os.replace(tmp, path)
  BuildInfo.path = path
  lib = ctypes.CDLL(path)
  for name in ('mwt_k1_launch', 'mwt_k4_launch'):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  lib.mwt_k1_params_size.restype = ctypes.c_int
  lib.mwt_k4_params_size.restype = ctypes.c_int
  lib.mwt_k1_scratch_rows.argtypes = [ctypes.c_int] * 4
  lib.mwt_k1_scratch_rows.restype = ctypes.c_int
  lib.mwt_k4_scratch_rows.argtypes = [ctypes.c_int] * 4
  lib.mwt_k4_scratch_rows.restype = ctypes.c_int
  _LIB = lib
  return lib


def params_struct(name, ints=(), floats=(), ptrs=()):
  """A ctypes mirror of a C parameter struct: ints, then floats, then
  pointers, in declaration order."""
  fields = ([(n, ctypes.c_int) for n in ints] +
            [(n, ctypes.c_float) for n in floats] +
            [(n, ctypes.c_void_p) for n in ptrs])
  return type(name, (ctypes.Structure,), {'_fields_': fields})
