"""Where the card's time goes in the benchmark rollout.

  python -m mujoco_warp_tpu_torch.devprofile [--scene constraints]

Runs ``benchmarks.rollout`` on a committed scene at 8192 worlds for 300
steps (the humanoid, by default, then rests its feet on the floor; the
``constraints`` scene runs the general step), traces 40 more with
``torch.profiler`` (CPU and CUDA activities) and prints one JSON line:

- ``window_ms``: host time of the traced steps (a ``rollout`` annotation
  that closes after a device synchronize);
- ``busy_share`` / ``idle_share``: the union of device intervals (kernels,
  copies, memsets) inside the window, over the window;
- ``kernels_per_step`` and ``h2d_copies_per_step``;
- ``device_ms_per_step``: each of the port's kernels and all other device
  work.

The profiler itself slows the host, so the idle share it reads is an upper
bound.  The chrome trace is kept under ``build/mujoco_warp_tpu_torch/``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from mujoco_warp_tpu_torch import benchmarks, io
from mujoco_warp_tpu_torch.kernels import build

_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_KERNELS = {'k1': 'k1_kernel', 'k4': 'k4_kernel',
            'mass_chain': 'mass_chain_kernel', 'solve': 'solve_kernel',
            'chol_solve': 'chol_solve_kernel',
            'damped_solve': 'damped_solve_kernel'}
SCENES = {'humanoid': io.SNAPSHOT, 'constraints': io.CONSTRAINTS_SNAPSHOT}
NWORLD, SKIP, STEPS = 8192, 300, 40


def summarize(events: list, nsteps: int) -> dict:
  """The summary of a chrome trace's event list (see the module doc)."""
  win = [e for e in events
         if e.get('cat') == 'user_annotation' and e.get('name') == 'rollout']
  if len(win) != 1:
    raise ValueError(f'expected one rollout annotation, found {len(win)}')
  t0 = float(win[0]['ts'])
  t1 = t0 + float(win[0]['dur'])
  dev = []
  for e in events:
    if e.get('ph') == 'X' and e.get('cat') in _DEVICE_CATS:
      a, b = float(e['ts']), float(e['ts']) + float(e['dur'])
      if b > t0 and a < t1:
        dev.append((max(a, t0), min(b, t1), e))
  if not dev:
    raise ValueError('the trace holds no device work: the profiler saw no '
                     'CUDA activity')
  busy, end = 0.0, t0
  for a, b, _ in sorted(dev, key=lambda x: x[0]):
    if b > end:
      busy += b - max(a, end)
      end = b
  per_kernel = {k: 0.0 for k in _KERNELS}
  other = 0.0
  by_name = {name: k for k, name in _KERNELS.items()}
  for a, b, e in dev:
    k = by_name.get(e['name'].split('(')[0].strip())
    if k is None:
      other += b - a
    else:
      per_kernel[k] += b - a
  window = t1 - t0
  return {
      'steps': nsteps,
      'window_ms': window / 1e3,
      'busy_share': busy / window,
      'idle_share': 1.0 - busy / window,
      'kernels_per_step': sum(e['cat'] == 'kernel' for _, _, e in dev) /
                          nsteps,
      'h2d_copies_per_step': sum(
          e['cat'] == 'gpu_memcpy' and 'HtoD' in e['name']
          for _, _, e in dev) / nsteps,
      'device_ms_per_step': {**{k: v / 1e3 / nsteps
                                for k, v in per_kernel.items()},
                             'other': other / 1e3 / nsteps},
  }


def profile(scene: str = 'humanoid') -> dict:
  if not torch.cuda.is_available():
    raise RuntimeError('devprofile needs a CUDA device')
  m = io.load_model_npz(SCENES[scene])
  steps_of = benchmarks.rollout(m, NWORLD, device='cuda')
  for _ in range(SKIP):
    next(steps_of)
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    with torch.profiler.record_function('rollout'):
      for _ in range(STEPS):
        next(steps_of)
      torch.cuda.synchronize()
  trace = os.path.join(build.BUILD_DIR, f'rollout_trace_{scene}.json')
  os.makedirs(os.path.dirname(trace), exist_ok=True)
  prof.export_chrome_trace(trace)
  with open(trace) as f:
    events = json.load(f)['traceEvents']
  return {'scene': scene, 'nworld': NWORLD, 'skip': SKIP, 'trace': trace,
          **summarize(events, STEPS)}


if __name__ == '__main__':
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--scene', choices=sorted(SCENES), default='humanoid')
  print(json.dumps(profile(p.parse_args().scene)))
