"""Humanoid batched-step throughput of the port on one CUDA device.

Twin of the repository's ``bench.py``: the same humanoid (loaded from the
committed snapshot, so neither ``mujoco`` nor ``dm_control`` is needed),
8192 worlds x 1000 steps by default (``BENCH_NWORLD``, ``BENCH_NSTEP``),
one JSON line on stdout and the metrics on stderr; exit 1 when any world
overflowed a contact buffer, since degraded physics is not a result::

  python -m mujoco_warp_tpu_torch.bench
"""

import json
import os
import sys

from mujoco_warp_tpu_torch import benchmarks, io

# reference MJWarp humanoid, 8192 worlds, on an unspecified NVIDIA GPU
# (MJWarp benchmarks/README.md)
BASELINE_STEPS_PER_SEC = 2_729_192.0


def main():
  nworld = int(os.environ.get('BENCH_NWORLD', 8192))
  nstep = int(os.environ.get('BENCH_NSTEP', 1000))
  m = io.load_model_npz()
  metrics = benchmarks.run(m, nworld=nworld, nstep=nstep, device='cuda')
  metrics.pop('state')
  if metrics['overflow_worlds'] > 0:
    print(json.dumps({'error': 'contact overflow in '
                      f"{metrics['overflow_worlds']} worlds: steps_per_sec "
                      'measured on degraded physics', **metrics}),
          file=sys.stderr)
    sys.exit(1)
  print(json.dumps({
      'metric': 'humanoid_steps_per_sec',
      'value': metrics['steps_per_sec'],
      'unit': 'steps/s',
      'vs_baseline': metrics['steps_per_sec'] / BASELINE_STEPS_PER_SEC,
  }))
  print(json.dumps(metrics), file=sys.stderr)


if __name__ == '__main__':
  main()
