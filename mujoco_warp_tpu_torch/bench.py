"""Batched-step throughput of the port on one CUDA device.

Twin of the repository's ``bench.py``: the same humanoid (loaded from the
committed snapshot, so neither ``mujoco`` nor ``dm_control`` is needed),
or another scene of ``benchmarks.SCENES`` (``BENCH_SCENE``: walker,
cheetah, hopper, humanoid_dmc, constraints, ...), at the scene's
registered width x 1000 steps by default (``BENCH_NWORLD``,
``BENCH_NSTEP``), one JSON line on stdout (``vs_baseline`` against
MJWarp's humanoid for the humanoid, null for the other scenes) and the
metrics on stderr; exit 1 when any world overflowed a contact buffer,
since degraded physics is not a result::

  python -m mujoco_warp_tpu_torch.bench
  BENCH_SCENE=hopper python -m mujoco_warp_tpu_torch.bench
"""

import json
import os
import sys

from mujoco_warp_tpu_torch import benchmarks

# reference MJWarp humanoid, 8192 worlds, on an unspecified NVIDIA GPU
# (MJWarp benchmarks/README.md): the humanoid's yardstick only; the other
# scenes have none, and print vs_baseline null
BASELINE_STEPS_PER_SEC = {'humanoid': 2_729_192.0}


def main():
  scene = os.environ.get('BENCH_SCENE', 'humanoid')
  m, width = benchmarks.load_scene(scene)
  nworld = int(os.environ.get('BENCH_NWORLD', width))
  nstep = int(os.environ.get('BENCH_NSTEP', 1000))
  metrics = benchmarks.run(m, nworld=nworld, nstep=nstep, device='cuda',
                           init_state=benchmarks.start_state(scene))
  for k in ('state', 'model', 'world_ids'):
    metrics.pop(k)
  base = BASELINE_STEPS_PER_SEC.get(scene)
  if metrics['overflow_worlds'] > 0:
    print(json.dumps({'error': 'contact overflow in '
                      f"{metrics['overflow_worlds']} worlds: steps_per_sec "
                      'measured on degraded physics', **metrics}),
          file=sys.stderr)
    sys.exit(1)
  print(json.dumps({
      'metric': f'{scene}_steps_per_sec',
      'value': metrics['steps_per_sec'],
      'unit': 'steps/s',
      'vs_baseline': (None if base is None else
                      metrics['steps_per_sec'] / base),
  }))
  print(json.dumps(metrics), file=sys.stderr)


if __name__ == '__main__':
  main()
