"""Where the card's time goes in the benchmark rollout.

  python -m mujoco_warp_tpu_torch.devprofile \
      [--scene constraints|clutter_arm_nosleep|spheres|spheres_elliptic|
               walker|cheetah|hopper|humanoid_dmc|clutter_arm|spheres_cg|
               humanoid_implicitfast|ball_in_cup|point_mass|sensors2|
               tendon_wrap|tendon_mix|pendulum|reacher|finger|cartpole|
               acrobot|humanoid_CMU|constraints_implicitfast|
               cheetah_implicit|manipulator_insert_peg|stack_2|stack_4|
               finger_cg|humanoid_dmc_dr|quadruped|dog] [--general]
  python -m mujoco_warp_tpu_torch.devprofile --skip [--worlds 256]

Runs ``benchmarks.rollout`` on a committed scene for a number of steps
(the humanoid, by default, 8192 worlds x 300, then rests its feet on the
floor; the ``constraints`` scene, 8192 x 300, runs the general step;
``clutter_arm_nosleep``, 4096 x 80, the general step with collision, the
large-tree mass chain and the torch Newton, by then past its first
contacts; ``spheres`` at 8192 and ``spheres_elliptic`` at 4096 worlds,
150 steps, the general step with collision and contacts through the
solve kernel, pyramidal and elliptic, by then with every body on the
floor; the dm_control scenes at 8192 worlds x 200, fused, or with
``--general`` on the general step with their sensors; ``clutter_arm``,
4096 x 20 from its settled state (``benchmarks.START``), the general
step with sleep and islands; ``spheres_cg``, 8192 x 20, the CG solver;
``humanoid_implicitfast``, 8192 x 300, fused; the tendon scenes,
8192 x 100, the general step with their tendons; dm_control's classic
tasks and the two integrator scenes, 8192 x 100 (humanoid_CMU x 20), the
general step; the elliptic-cone tasks from their committed seeded
contact states (``benchmarks.START``), 8192 x 20 (stack_4 x 10, finger_cg x 2),
the general step; ``humanoid_dmc_dr``, 8192 x 100, each world with its
own parameters, the general step; ``quadruped``, 8192 x 30, landed on
its feet by then, and ``dog``, 8192 x 2, standing from qpos0, the
general step with activations), traces a few more with
``torch.profiler`` (CPU and CUDA activities; 40 steps, 4 for the clutter
scenes and humanoid_CMU, whose step launches tens of thousands of
kernels, 3 for spheres_cg and stack_4, 1 for finger_cg, 5 for
manipulator_insert_peg and stack_2, 1 for dog, 10 for quadruped, the
spheres scenes, the
tendon scenes,
the classic tasks, the integrator scenes, humanoid_dmc_dr and the
general step of a dm_control scene) and prints one JSON line:

- ``window_ms``: host time of the traced steps (a ``rollout`` annotation
  that closes after a device synchronize);
- ``busy_share`` / ``idle_share``: the union of device intervals (kernels,
  copies, memsets) inside the window, over the window;
- ``kernels_per_step`` and ``h2d_copies_per_step``;
- ``device_ms_per_step``: each of the port's kernels and all other device
  work;
- ``other_top``: the other kernels with the most device time, by name
  (cut to 100 characters), each with its ms and launches per step;
- ``stage_host_ms_per_step``: the host time of each stage of the general
  step (its ``stage:<name>`` annotations, ``ops/forward.py``; empty on
  the fused path).

With ``--skip``, the same for the skip step instead: ``forward.step`` on
``parity.pushed_clutter`` (the settled clutter.xml state, 256 worlds by
default, 5 in 64 pushed awake: 20 of 256), which packs the awake
worlds, and the full step ``forward._step_batched`` from the same state,
each warmed up by one step and traced for ``SKIP_STEPS``; one JSON line
with both summaries.

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
            'solve_elliptic': 'solve_ell_kernel',
            'chol_batched': 'chol_batched_kernel',
            'chol_solve': 'chol_solve_kernel',
            'damped_solve': 'damped_solve_kernel'}
# scene: (steps before the window, steps traced); the snapshot and worlds
# are benchmarks.SCENES'
WINDOWS = {'humanoid': (300, 40), 'constraints': (300, 40),
           'clutter_arm_nosleep': (80, 4), 'spheres': (150, 10),
           'spheres_elliptic': (150, 10),
           **{k: (200, 40) for k in io.DMC_NCONMAX},
           'clutter_arm': (20, 4), 'spheres_cg': (20, 3),
           'humanoid_implicitfast': (300, 40),
           **{k: (100, 10) for k in io.TENDON_SNAPSHOTS},
           **{k: (100, 10) for k in io.CLASSIC_DMC},
           'humanoid_CMU': (20, 4), 'constraints_implicitfast': (100, 10),
           'cheetah_implicit': (100, 10),
           'manipulator_insert_peg': (20, 5), 'stack_2': (20, 5),
           'stack_4': (10, 3), 'finger_cg': (2, 1),
           'humanoid_dmc_dr': (100, 10), 'quadruped': (30, 10),
           'dog': (2, 1)}
# the general step's window, for --general
GENERAL_WINDOW = (200, 10)
# steps traced of each path with --skip
SKIP_STEPS = 4
# other kernels listed by name
TOP = 8


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
  others = {}  # name -> [us, launches] of the other kernels
  for a, b, e in dev:
    k = by_name.get(e['name'].split('(')[0].strip())
    if k is None:
      other += b - a
      if e['cat'] == 'kernel':
        o = others.setdefault(e['name'][:100], [0.0, 0])
        o[0] += b - a
        o[1] += 1
    else:
      per_kernel[k] += b - a
  top = sorted(others.items(), key=lambda x: -x[1][0])[:TOP]
  stages = {}
  for e in events:
    name = e.get('name', '')
    if e.get('cat') == 'user_annotation' and name.startswith('stage:') and \
        t0 <= float(e['ts']) < t1:
      key = name[len('stage:'):]
      stages[key] = stages.get(key, 0.0) + float(e['dur'])
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
      'other_top': [{'name': name, 'ms_per_step': us / 1e3 / nsteps,
                     'launches_per_step': n / nsteps}
                    for name, (us, n) in top],
      'stage_host_ms_per_step': {k: v / 1e3 / nsteps
                                 for k, v in stages.items()},
  }


def _traced(step, steps: int, name: str) -> dict:
  """``step()`` called ``steps`` times under the profiler: the trace's
  path and its summary."""
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    with torch.profiler.record_function('rollout'):
      for _ in range(steps):
        step()
      torch.cuda.synchronize()
  trace = os.path.join(build.BUILD_DIR, f'rollout_trace_{name}.json')
  os.makedirs(os.path.dirname(trace), exist_ok=True)
  prof.export_chrome_trace(trace)
  with open(trace) as f:
    events = json.load(f)['traceEvents']
  return {'trace': trace, **summarize(events, steps)}


def profile(scene: str = 'humanoid', general: bool = False) -> dict:
  if not torch.cuda.is_available():
    raise RuntimeError('devprofile needs a CUDA device')
  m, nworld = benchmarks.load_scene(scene)
  skip, steps = GENERAL_WINDOW if general else WINDOWS[scene]
  steps_of = benchmarks.rollout(m, nworld, device='cuda', general=general,
                                init_state=benchmarks.start_state(scene))
  for _ in range(skip):
    next(steps_of)
  name = scene + ('_general' if general else '')
  return {'scene': scene, 'general': general, 'nworld': nworld,
          'skip': skip, **_traced(lambda: next(steps_of), steps, name)}


def profile_skip(nworld: int = 256) -> dict:
  """The skip step and the full step from the same pushed clutter state
  (see the module doc)."""
  from mujoco_warp_tpu_torch import parity
  from mujoco_warp_tpu_torch.ops import forward
  if not torch.cuda.is_available():
    raise RuntimeError('devprofile needs a CUDA device')
  nwake = nworld * 5 // 64
  m, d0 = parity.pushed_clutter(nworld, nwake)
  out = {'nworld': nworld, 'nwake': nwake}
  for name, fn in (('packed', forward.step), ('full', forward._step_batched)):
    state = [fn(m, d0)]
    n0 = forward.packed_steps

    def one():
      state[0] = fn(m, state[0])
    out[name] = _traced(one, SKIP_STEPS, f'skip_{name}_{nworld}')
    out[name]['packed_steps'] = forward.packed_steps - n0
  return out


if __name__ == '__main__':
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--scene', choices=sorted(WINDOWS), default='humanoid')
  p.add_argument('--general', action='store_true',
                 help='the general step, also for a fused-gate scene')
  p.add_argument('--skip', action='store_true',
                 help='the skip step against the full step instead')
  p.add_argument('--worlds', type=int, default=256,
                 help='worlds of --skip')
  args = p.parse_args()
  print(json.dumps(profile_skip(args.worlds) if args.skip else
                   profile(args.scene, args.general)))
