"""Per-launch times of the two kernels that share ``csrc/newton.cuh``: K4
on the humanoid and the solve kernel on the constraints scene.

  python3 mujoco_warp_tpu_torch/kerneltime.py [--root DIR]

Imports ``mujoco_warp_tpu_torch`` from ``--root`` (by default the checkout
this file lies in), so that the same script times another commit's
kernels: unpack that commit with ``git archive`` into a directory and
alternate the two roots, one process each, on one card.  Each kernel gets
the seeded state of ``parity`` at NWORLD worlds (K4: the humanoid
lowered into the floor, ``parity.DROP['contact']``; the solve:
``parity.general_state``), its upstream inputs from the plain versions,
and is timed with CUDA events over CALLS back-to-back launches, BLOCKS
times.  Both kernels run far longer than their wrappers' host
work, so the card stays busy and the time per call is the kernel's device
time.  Prints one JSON line: the root and the package directory imported
from it, the card (nvidia-smi name and power limit) and each kernel's ms
per launch in every block.
"""

import argparse
import json
import os
import subprocess
import sys

# the registered width of both scenes; launches per timing, timings
NWORLD, CALLS, BLOCKS = 8192, 50, 3


def events_ms(torch, fn, calls):
  """Device time per call of ``calls`` back-to-back calls of ``fn``."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(calls):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / calls


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--root', default=os.path.dirname(
      os.path.dirname(os.path.abspath(__file__))))
  args = ap.parse_args()
  root = os.path.abspath(args.root)
  # the package from root, and not this file's directory, whose io.py and
  # types.py would stand in for the standard library's
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path = [root] + [p for p in sys.path
                       if os.path.abspath(p or '.') != here]

  import numpy as np
  import torch
  from mujoco_warp_tpu_torch import io, parity
  from mujoco_warp_tpu_torch.fused import glue, k1_ref, k4_ref
  from mujoco_warp_tpu_torch.kernels import build, lanes, world
  from mujoco_warp_tpu_torch.kernels import k4 as kk4
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.kernels import solver as ksolver
  from mujoco_warp_tpu_torch.ops import forward

  if not torch.cuda.is_available():
    sys.exit('kerneltime: no CUDA device')
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
  build.load()
  dev, W = torch.device('cuda'), NWORLD

  # K4 on the humanoid in contact, fed the plain K1 and glue
  m = io.load_model_npz()
  qpos, qvel, ctrl, ws = [torch.as_tensor(x, device=dev) for x in
                          parity.lane_state(m, W, 7, parity.DROP['contact'])]
  qM, qLD, bias, cdof, dist, cpos, cframe, stcom = k1_ref.k1(
      m, qpos, qvel, need_qLD=True)
  con, _ = glue.compact(m, dist, cpos, cframe, stcom)
  qfs = glue.middle(m, bias, qpos, qvel, ctrl)
  a4 = (m, qM, qLD if not k4_ref.has_rows(m) else None, qfs, ws, qvel, qpos,
        cdof, con)

  # the solve kernel on the constraints scene, fed the plain upstream
  mc = io.load_model_npz(io.CONSTRAINTS_SNAPSHOT)
  nv, nb = mc.nv, mc.nbody
  qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                      parity.general_state(mc, W, 7)]
  d = io.make_data(mc, W).replace(
      qpos=qpos, qvel=qvel, ctrl=ctrl,
      qacc_warmstart=0.1 * torch.as_tensor(
          np.random.default_rng(8).standard_normal((W, nv)),
          dtype=torch.float32, device=dev))
  d = forward.pre(mc, d)
  qM, qLD, cvel, cdd, bias = kmass.mass_chain_plain(
      mc, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  d = forward.mid(mc, d.replace(
      qM=world(qM, nv, nv), qLD=world(qLD, nv, nv), cvel=world(cvel, nb, 6),
      cdof_dot=world(cdd, nv, 6), qfrc_bias=bias.T))
  asv = (mc, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
         lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
         lanes(d.qacc_warmstart))

  calls = {'k4': lambda: kk4.k4(*a4), 'solve': lambda: ksolver.solve_tiles(
      *asv)}
  times = {k: [] for k in calls}
  for _ in range(BLOCKS):
    for k, fn in calls.items():
      times[k].append(events_ms(torch, fn, CALLS))
  print(json.dumps({'root': root, 'package': os.path.dirname(io.__file__),
                    'card': smi.stdout.strip(), 'nworld': W,
                    'calls': CALLS, 'ms': times}), flush=True)


if __name__ == '__main__':
  main()
