"""Whether ``torch.profiler`` holds every launch of a kernel in each of
several traces taken one after another in a fresh process: the solve
kernel on the seeded spheres state (``parity.spheres_state``, 1000
worlds, seed 3), WINDOWS traces of CALLS calls each
(``kerneltime.profiled_launches``), read at the pad ``kerneltime.PAD_S``
and at 0.1 s and 0 s, on the card:

  python tests/measure_profiler_windows.py

Prints, for each way of reading, the launches each trace held and the
seconds the traces took.  (Late in a long run, chip_smoke.py's phase
19 reads the same kernel's traces one by one: ``profile_windows``.)"""

import os
import sys
import time

import torch

# the checkout's package, ahead of any installed one
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mujoco_warp_tpu_torch import io, kerneltime, parity
from mujoco_warp_tpu_torch.kernels import solver as ksolver

W, SEED, WINDOWS, CALLS = 1000, 3, 8, 20


def main():
  dev = torch.device('cuda')
  m = io.load_model_npz(io.SPHERES_SNAPSHOT, device=dev)
  qpos, qvel, ctrl = [torch.as_tensor(x, device=dev)
                      for x in parity.spheres_state(m, W, SEED)]
  d = io.make_data(m, W, device=dev).replace(qpos=qpos, qvel=qvel,
                                             ctrl=ctrl)
  args = parity.solve_args(m, d)[0]
  fn = lambda: ksolver.solve_tiles(*args)
  pad = kerneltime.PAD_S
  # the first reading takes the kernel's build and the profiler's start
  for label, p in (('first', pad), ('again', pad), ('shorter', 0.1),
                   ('none', 0.0), ('again', pad)):
    kerneltime.PAD_S = p
    t = time.perf_counter()
    seen = [len(kerneltime.profiled_launches(torch, fn, CALLS,
                                             'solve_kernel')[0])
            for _ in range(WINDOWS)]
    print(f'{label} (pad {p} s): launches held {seen} of {CALLS} each, '
          f'{time.perf_counter() - t:.2f} s', flush=True)
  kerneltime.PAD_S = pad


if __name__ == '__main__':
  main()
