"""Where K4's time goes: the kernel cut after each of its phases, and
each world's phases on the SM clock.

  python3 -m mujoco_warp_tpu_torch.k4phases [--nworld 8192]

Builds copies of ``kernels/csrc/k4.cu`` with nvcc (the library's flags,
one nvcc per copy, started together).  Four copies each end after one
more phase of the kernel:

- ``loads``: the block's cp.async loads and its stores;
- ``rows``: + the row build by the lanes and the live-row lists;
- ``newton``: + the Newton solve;
- ``full``: the kernel as it is (+ the integrator).

A fifth, ``clocked``, is the whole kernel with ``clock64()`` read by
each warp at the ends of its loads, rows, Newton and integrator and
after the block's closing barrier, and inside the Newton
(``newton_warp.cuh``) around each of its steps, kept per world.

Each copy is launched through ``kernels.k4.k4`` on the seeded states of
``parity.k4_case`` for the humanoid ('rest': no contact; 'contact': the
feet in the floor) at NWORLD worlds, fed the plain K1 and glue.  The cut
copies are timed with CUDA events over CALLS back-to-back launches,
BLOCKS times, in turns; a cut copy's outputs are not K4's, and cutting a
phase also changes how long a block's warps wait for its slowest world,
so only the time each phase adds counts, as an upper bound.  The
clocked copy gives each phase's mean SM cycles per world ('wait': at
the block's closing barrier, for the block's slowest world), the
Newton's mean cycles at each Newton count, and the Newton's cycles per
world in each of its steps ('factor': H and its factor; 'gradient': the
forces, J^T f, the substitution and the stop test; 'linesearch';
'step': qacc, Jaref and the masks; the rest of the Newton is its setup)
with its factors and linesearch evaluations per world.  Prints one JSON
line: the card (nvidia-smi name and power limit), each state's mean
Newton count (plain K4), each cut's ms per launch in every block, and
the clocked split.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import tempfile
from unittest import mock

import numpy as np

NWORLD, CALLS, BLOCKS = 8192, 50, 3

# text of k4.cu that the copies replace
_KERNEL = ('__global__ void k4_kernel(const K4Params p) {\n'
           '  extern __shared__ float smem[];\n')
_WARPS = '  copies_done();\n  if (warp < nw) {'
_INIT = '      R.init();\n'
_NEWTON = '''      niter = newton_solve_warp<MWT_MAX_NV>(
          R, R.M, x, nv, p.iterations, p.ls_iterations, p.tol, p.ls_tol,
          p.meaninertia, lane);
'''
_INTEGRATE = '    k4_integrate(p, lay, b, x, lane);\n'
_STORES = '  __syncthreads();\n  // qpos, qvel, warmstart, qacc and niter'
_EXTERN = 'extern "C" {\n'
CUTS = {
    'loads': ((_WARPS, '  copies_done();\n  if (warp < nw && p.W < 0) {'),),
    'rows': ((_NEWTON, '      niter = 0.0f;\n'), (_INTEGRATE, '')),
    'newton': ((_INTEGRATE, ''),),
    'full': (),
}
PHASES = ('load', 'rows', 'newton', 'integrate', 'wait')
# the clocked copy's Newton: its steps, then its factors and linesearch
# evaluations
STEPS = ('factor', 'gradient', 'linesearch', 'step')
COUNTS = ('factors', 'evaluations')
_N_START = '  bool refactor = true, first = true;\n'
_N_FACTOR = '    if (refactor) rows.factor();\n'
_N_DONE = '    __syncwarp();\n    if (done) break;\n'
_N_STEP = '    // -- step and constraint state\n'
_N_EVAL = '      rows.eval3_lane(a, v, v + 3, v + 6);\n'
_N_END = """    refactor = rows.update_quad() || R::ELL;
  }
  return niter;
"""


def _lap(k: int) -> str:
  return (f'    {{ const long long t = clock64(); k4c[{k}] += t - k4t; '
          'k4t = t; }\n')


def _clocked(nworld: int):
  """The edits of the clocked copy: per world, the clock at the kernel's
  start and at the end of each phase, the world's Newton count."""
  return (
      (_KERNEL, f'__device__ long long k4_clocks[{nworld} * 7];\n' + _KERNEL +
       '  const long long t0 = clock64();\n'),
      (_WARPS, '  copies_done();\n  const long long t1 = clock64();\n'
       '  long long t2 = t1, t3 = t1, t4 = t1;\n  if (warp < nw) {'),
      (_INIT, _INIT + '      t2 = clock64();\n'),
      (_NEWTON, _NEWTON + '      t3 = clock64();\n'),
      (_INTEGRATE, _INTEGRATE + '    t4 = clock64();\n'),
      (_STORES, '  __syncthreads();\n  if (warp < nw && lane == 0) {\n'
       '    long long* c = k4_clocks + 7 * (w0 + warp);\n'
       '    c[0] = t0; c[1] = t1; c[2] = t2; c[3] = t3; c[4] = t4;\n'
       '    c[5] = clock64();\n'
       '    c[6] = (long long)smem[warp * wf + lay.s.vec + 6 * nv];\n  }\n'
       '  // qpos, qvel, warmstart, qacc and niter'),
      (_EXTERN, _EXTERN + 'int mwt_k4_clocks(long long* dst, '
       'long long* newton) {\n'
       '  cudaError_t e = cudaMemcpyFromSymbol(dst, k4_clocks, '
       'sizeof(k4_clocks));\n'
       '  if (e != cudaSuccess) return (int)e;\n'
       '  return (int)cudaMemcpyFromSymbol(newton, k4_newton_clocks, '
       'sizeof(k4_newton_clocks));\n}\n'),
  )


def _clocked_newton(nworld: int):
  """The edits of the clocked copy's newton_warp.cuh: per world, the
  cycles of each step and the counts of STEPS and COUNTS."""
  n = len(STEPS) + len(COUNTS)
  return (
      (_N_START,
       _N_START + f'  long long k4c[{n}] = {{}}, k4t = clock64();\n'),
      (_N_FACTOR, '    k4t = clock64();\n    k4c[4] += refactor;\n' +
       _N_FACTOR + _lap(0)),
      (_N_DONE, _lap(1) + _N_DONE),
      (_N_EVAL, '      ++k4c[5];\n' + _N_EVAL),
      (_N_STEP, _lap(2) + _N_STEP),
      (_N_END, '    refactor = rows.update_quad() || R::ELL;\n' + _lap(3) +
       '  }\n  if (lane == 0)\n'
       f'    for (int k = 0; k < {n}; ++k)\n'
       f'      k4_newton_clocks[{n} * ((blockIdx.x * blockDim.x + '
       'threadIdx.x) >> 5) + k] = k4c[k];\n  return niter;\n'),
      ('#include "warp.cuh"\n', '#include "warp.cuh"\n\n'
       f'__device__ long long k4_newton_clocks[{nworld} * {n}];\n'),
  )


def _edit(path: str, edits):
  """Each (old, new) of edits in the file at path; old must be there
  once."""
  with open(path) as f:
    text = f.read()
  for old, new in edits:
    if text.count(old) != 1:
      raise RuntimeError(f'k4phases: {os.path.basename(path)} does not '
                         f'hold {old!r} once')
    text = text.replace(old, new)
  with open(path, 'w') as f:
    f.write(text)


def build_copies(tmp: str, nworld: int) -> dict:
  """Each copy of k4.cu built into its own library under tmp."""
  from mujoco_warp_tpu_torch.kernels import build
  procs = {}
  for name, edits in list(CUTS.items()) + [('clocked', _clocked(nworld))]:
    d = os.path.join(tmp, name)
    shutil.copytree(build.CSRC, d)
    _edit(os.path.join(d, 'k4.cu'), edits)
    if name == 'clocked':
      _edit(os.path.join(d, 'newton_warp.cuh'), _clocked_newton(nworld))
    lib = os.path.join(tmp, f'lib_{name}.so')
    cmd = [build.nvcc_path()] + build.NVCC_FLAGS + [
        '-shared', '-o', lib, os.path.join(d, 'k4.cu')]
    procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True))
  libs = {}
  for name, (path, proc) in procs.items():
    out, _ = proc.communicate()
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc failed for the {name} copy:\n{out}')
    lib = ctypes.CDLL(path)
    for fn, args in (('mwt_k4_launch', [ctypes.c_void_p] * 2),
                     ('mwt_k4_world_floats', [ctypes.c_int] * 3)):
      getattr(lib, fn).argtypes = args
      getattr(lib, fn).restype = ctypes.c_int
    lib.mwt_k4_params_size.restype = ctypes.c_int
    libs[name] = lib
  libs['clocked'].mwt_k4_clocks.argtypes = [ctypes.c_void_p] * 2
  return libs


def split(clocks: np.ndarray, newton: np.ndarray) -> dict:
  """Mean cycles per world of each phase, of the Newton at each Newton
  count and of each Newton step, and the Newton's mean counts, from the
  clocked copy's (nworld, 7) stamps and (nworld, 6) Newton sums."""
  spans = np.diff(clocks[:, :6], axis=1)
  niter = clocks[:, 6]
  return {
      'cycles': {p: float(spans[:, i].mean()) for i, p in enumerate(PHASES)},
      'newton_cycles_at_niter': {
          int(n): [int((niter == n).sum()),
                   float(spans[niter == n, 2].mean())]
          for n in np.unique(niter)},
      'newton_steps': {k: float(newton[:, i].mean())
                       for i, k in enumerate(STEPS + COUNTS)},
  }


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--nworld', type=int, default=NWORLD)
  args = ap.parse_args()

  import torch
  from mujoco_warp_tpu_torch import parity
  from mujoco_warp_tpu_torch.fused import k4_ref
  from mujoco_warp_tpu_torch.kernels import build
  from mujoco_warp_tpu_torch.kernels import k4 as kk4
  from mujoco_warp_tpu_torch.kerneltime import events_ms

  if not torch.cuda.is_available():
    raise SystemExit('k4phases: no CUDA device')
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
  dev = torch.device('cuda')
  cases = {s: parity.k4_case('humanoid', s, args.nworld, 7, dev)[1]
           for s in ('rest', 'contact')}
  niter = {s: float(k4_ref.k4(*a)[4].float().mean())
           for s, a in cases.items()}
  with tempfile.TemporaryDirectory() as tmp:
    libs = build_copies(tmp, args.nworld)
    times = {s: {c: [] for c in CUTS} for s in cases}
    clocked = {}
    for _ in range(BLOCKS):
      for s, a in cases.items():
        for c in CUTS:
          with mock.patch.object(build, 'load', lambda lib=libs[c]: lib):
            times[s][c].append(events_ms(torch, lambda: kk4.k4(*a), CALLS))
    lib = libs['clocked']
    for s, a in cases.items():
      with mock.patch.object(build, 'load', lambda: lib):
        kk4.k4(*a)
      torch.cuda.synchronize()
      buf = np.zeros((args.nworld, 7), np.int64)
      nbuf = np.zeros((args.nworld, len(STEPS) + len(COUNTS)), np.int64)
      rc = lib.mwt_k4_clocks(buf.ctypes.data, nbuf.ctypes.data)
      if rc != 0:
        raise RuntimeError(f'k4phases: reading the clocks: cudaError {rc}')
      clocked[s] = split(buf, nbuf)
  print(json.dumps({'card': smi.stdout.strip(), 'nworld': args.nworld,
                    'calls': CALLS, 'niter_mean': niter, 'ms': times,
                    'clocked': clocked}), flush=True)


if __name__ == '__main__':
  main()
