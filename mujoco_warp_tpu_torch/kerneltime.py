"""Per-launch times of K4 (humanoid) and of the solve kernel (constraints,
spheres and spheres_elliptic), which share the one-warp Newton
(``csrc/newton_warp.cuh`` over ``csrc/solve_rows.cuh``), of
``chol_batched`` and the two Cholesky solves at n 75 on
``clutter_arm_nosleep`` (beside ``torch.linalg.cholesky`` of the same
matrices) and of ``chol_solve`` at n 36 on ``spheres``.

  python3 mujoco_warp_tpu_torch/kerneltime.py [--root DIR] [--k4-only]

Imports ``mujoco_warp_tpu_torch`` from ``--root`` (by default the checkout
this file lies in), so that the same script times another commit's
kernels: unpack that commit with ``git archive`` into a directory and
alternate the two roots, one process each, on one card.  Each kernel gets
the seeded state of ``parity`` at NWORLD worlds (K4: the humanoid
lowered into the floor, ``parity.DROP['contact']``; the solve:
``parity.general_state`` on constraints, ``parity.spheres_state`` on the
spheres scenes at their
registered widths, 8192 and 4096 worlds), its upstream inputs from the
plain versions,
and is timed with CUDA events over CALLS back-to-back launches, BLOCKS
times.  Both kernels run far longer than their wrappers' host
work, so the card stays busy and the time per call is the kernel's device
time.  ``chol_solve`` and ``damped_solve`` get ``parity.clutter_state``
at CL_NWORLD worlds through the plain mass chain (qM a ``world()`` view
of its lanes-last output, as on the main path), the factor of qM from
the plain ``chol_batched`` (world-major) and seeded right-hand sides,
and are called through ``chol_solve_batched`` and
``damped_solve_batched``; ``chol_batched`` factors that qM (world-major)
with the mass factor's jitter, beside ``torch.linalg.cholesky`` of qM +
jitter I; ``chol_solve`` at n 36 gets the factor of
``parity.spheres_state`` at NWORLD worlds from the plain mass chain (a
``world()`` view of its lanes-last qLD, as on the main path) and a
seeded right-hand side.  For these four, CUDA events time each call's
whole device work (with any copies the wrapper makes) and
``torch.profiler`` the kernel's own launches (``kernel_ms``): the n 36
kernel is shorter than its wrapper's host work, so only the profiler
sees its time.  Prints one JSON line: the root
and the package directory imported from it, the card (nvidia-smi name
and power limit) and each kernel's ms per launch in every block.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# the registered widths of the scenes; launches per timing, timings
NWORLD, CL_NWORLD, CALLS, BLOCKS = 8192, 4096, 50, 3
# idle seconds on each side of the profiled calls, inside the trace's
# window
PAD_S = 1.0


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


def profiled_ms(torch, fn, calls, kernel):
  """Mean device time (ms) of the launches of ``kernel`` (its function
  name) over ``calls`` calls of ``fn``, read from ``torch.profiler``'s
  chrome trace with PAD_S of idle time on each side of the calls, and the
  number of launches the trace held (the mean is None when it held
  none).  chip_smoke.py reads its kernel times here too."""
  fn()
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    time.sleep(PAD_S)
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
    time.sleep(PAD_S)
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)['traceEvents']
  durs = [float(e['dur']) for e in events
          if e.get('cat') == 'kernel' and
          e.get('name', '').split('(')[0].strip() == kernel]
  return (sum(durs) / 1e3 / len(durs) if durs else None), len(durs)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--root', default=os.path.dirname(
      os.path.dirname(os.path.abspath(__file__))))
  ap.add_argument('--k4-only', action='store_true',
                  help='time K4 alone (no other inputs are built)')
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
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
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

  def other_calls():
    """The other kernels' calls on their seeded inputs, and the
    profiled kernel of each call that has one."""
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

    # the Cholesky solves at n 75 on the clutter state
    mcl = io.load_model_npz(io.CLUTTER_SNAPSHOT)
    nv, nb, Wc = mcl.nv, mcl.nbody, CL_NWORLD
    qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                        parity.clutter_state(mcl, Wc, 7)]
    d = forward.pre(mcl, io.make_data(mcl, Wc).replace(qpos=qpos, qvel=qvel,
                                                       ctrl=ctrl))
    qM = kmass.mass_chain_plain(mcl, lanes(d.cinert, 36 * nb),
                                lanes(d.cdof, 6 * nv), lanes(d.qvel))[0]
    qM = world(qM, nv, nv)
    L = klinalg.chol_batched_plain(qM.contiguous(), kmass.BIG_JITTER)
    rhs, qacc = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in
                 np.random.default_rng(9).standard_normal((2, Wc, nv))]

    qMc = qM.contiguous()
    A_j = (qMc + kmass.BIG_JITTER * torch.eye(nv, device=dev)).contiguous()

    # the solve kernel on the spheres scenes' seeded contact states
    def spheres_solve(path, nworld):
      ms = io.load_model_npz(path)
      qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                          parity.spheres_state(ms, nworld, 7)]
      ws = 0.1 * torch.as_tensor(np.random.default_rng(8).standard_normal(
          (nworld, ms.nv)), dtype=torch.float32, device=dev)
      return parity.solve_args(ms, io.make_data(ms, nworld).replace(
          qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=ws))[0]

    asp = spheres_solve(io.SPHERES_SNAPSHOT, W)
    ase = spheres_solve(io.SPHERES_ELLIPTIC_SNAPSHOT, CL_NWORLD)

    # chol_solve at n 36 on the spheres state, its factor lanes-last
    msp = io.load_model_npz(io.SPHERES_SNAPSHOT)
    nvs, nbs = msp.nv, msp.nbody
    qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                        parity.spheres_state(msp, W, 7)]
    d = forward.pre(msp, io.make_data(msp, W).replace(qpos=qpos, qvel=qvel,
                                                      ctrl=ctrl))
    Ls = kmass.mass_chain_plain(msp, lanes(d.cinert, 36 * nbs),
                                lanes(d.cdof, 6 * nvs), lanes(d.qvel))[1]
    Ls = world(Ls, nvs, nvs)
    rhs_s = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (W, nvs)), dtype=torch.float32, device=dev)

    calls = {
        'solve': lambda: ksolver.solve_tiles(*asv),
        'solve_spheres': lambda: ksolver.solve_tiles(*asp),
        'solve_elliptic': lambda: ksolver.solve_tiles(*ase),
        'chol_batched_n75': lambda: klinalg.chol_batched(mcl, qMc,
                                                         kmass.BIG_JITTER),
        'cholesky_n75': lambda: torch.linalg.cholesky(A_j),
        'chol_solve_n75': lambda: klinalg.chol_solve_batched(mcl, L, rhs),
        'damped_solve_n75': lambda: klinalg.damped_solve_batched(mcl, qM, qacc),
        'chol_solve_n36': lambda: klinalg.chol_solve_batched(msp, Ls, rhs_s),
    }
    kernels = {'chol_batched_n75': 'chol_batched_kernel',
               'chol_solve_n75': 'chol_solve_kernel',
               'damped_solve_n75': 'damped_solve_kernel',
               'chol_solve_n36': 'chol_solve_kernel'}
    return calls, kernels

  calls, kernels = {'k4': lambda: kk4.k4(*a4)}, {}
  if not args.k4_only:
    more, kernels = other_calls()
    calls.update(more)
  times = {k: [] for k in calls}
  kernel_ms = {k: [] for k in kernels}
  for _ in range(BLOCKS):
    for k, fn in calls.items():
      times[k].append(events_ms(torch, fn, CALLS))
    for k, name in kernels.items():
      kernel_ms[k].append(profiled_ms(torch, calls[k], CALLS, name))
  print(json.dumps({'root': root, 'package': os.path.dirname(io.__file__),
                    'card': smi.stdout.strip(), 'nworld': W,
                    'clutter_nworld': CL_NWORLD, 'calls': CALLS, 'ms': times,
                    'kernel_ms': kernel_ms}), flush=True)


if __name__ == '__main__':
  main()
