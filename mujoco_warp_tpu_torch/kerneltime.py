"""Per-launch times of K1 and K4 (humanoid), of the mass chain in its
three forms (constraints nv 13 and spheres nv 36 with the factor,
clutter_arm_nosleep nv 75 without), of the solve kernel (constraints,
spheres and spheres_elliptic), which shares the one-warp Newton with K4
(``csrc/newton_warp.cuh`` over ``csrc/solve_rows.cuh``), of
``chol_batched`` and the two Cholesky solves at n 75 on
``clutter_arm_nosleep`` (beside ``torch.linalg.cholesky`` of the same
matrices) and of ``chol_solve`` at n 36 on ``spheres``.

  python3 mujoco_warp_tpu_torch/kerneltime.py [--root DIR] [--only GROUPS]

Imports ``mujoco_warp_tpu_torch`` from ``--root`` (by default the checkout
this file lies in), so that the same script times another commit's
kernels: unpack that commit with ``git archive`` into a directory and
alternate the two roots, one process each, on one card.  ``--only``
takes a comma list of the groups to time (``k4``, ``k1``,
``mass_chain``, ``solve``, ``linalg``; by default all), and builds the
inputs of those alone, for design variants.  Each kernel gets
the seeded state of ``parity`` at NWORLD worlds (K1 and K4: the humanoid
lowered into the floor, ``parity.DROP['contact']``, K1 without the
factor as the fused step calls it; the mass chain and the solve:
``parity.general_state`` on constraints, ``parity.spheres_state`` on the
spheres scenes at their registered widths, 8192 and 4096 worlds, and
``parity.clutter_state`` at CL_NWORLD worlds), its upstream inputs from
the plain versions,
and is timed with CUDA events over CALLS back-to-back launches, BLOCKS
times.  K4 and the solve kernel run far longer than their wrappers' host
work, so the card stays busy and the time per call is the kernel's device
time.  ``chol_solve`` and ``damped_solve`` get ``parity.clutter_state``
at CL_NWORLD worlds through the plain mass chain (qM world-major, as on
the main path), the factor of qM from
the plain ``chol_batched`` (world-major) and seeded right-hand sides,
and are called through ``chol_solve_batched`` and
``damped_solve_batched``; ``chol_batched`` factors that qM (world-major)
with the mass factor's jitter, beside ``torch.linalg.cholesky`` of qM +
jitter I; ``chol_solve`` at n 36 gets the factor of
``parity.spheres_state`` at NWORLD worlds from the plain mass chain (a
``world()`` view of its lanes-last qLD, as on the main path) and a
seeded right-hand side.  For these four, K1 and the mass chain, CUDA
events time each call's whole device work (with any copies the wrapper
makes) and ``torch.profiler`` the kernel's own launches (``kernel_ms``):
the short kernels run shorter than their wrappers' host work, so only
the profiler sees their time.  Prints one JSON line: the root
and the package directory imported from it, the card (nvidia-smi name
and power limit), each kernel's ms per launch in every block, and the
first profiled kernel's ms at a 1 s pad and at PAD_S (``pad_check``).
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
# window (chip_smoke.py reads some 330 traces, about half of them empty
# late in its run; ``pad_check`` reads one kernel at this pad beside the
# 1 s that earlier readings took, as chip_smoke.py's phase 4 does)
PAD_S = 0.1


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


def profiled_launches(torch, fn, calls, kernel):
  """The launches of ``kernel`` (its function name) over ``calls`` calls
  of ``fn``, read from ``torch.profiler``'s chrome trace with PAD_S
  seconds of idle time on each side of the calls: each launch's device
  ms in the order it ran, and how many kernel events of other names the
  trace held, by name."""
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
  ms, others = [], {}
  for e in sorted((e for e in events if e.get('cat') == 'kernel'),
                  key=lambda e: float(e.get('ts', 0.0))):
    name = e.get('name', '').split('(')[0].strip()
    if name == kernel:
      ms.append(float(e['dur']) / 1e3)
    else:
      others[name] = others.get(name, 0) + 1
  return ms, others


def profiled_ms(torch, fn, calls, kernel):
  """Mean device time (ms) of the launches of ``kernel`` over ``calls``
  calls of ``fn`` (``profiled_launches``), and the number of launches the
  trace held (the mean is None when it held none).  chip_smoke.py reads
  its kernel times here too."""
  ms, _ = profiled_launches(torch, fn, calls, kernel)
  return (sum(ms) / len(ms) if ms else None), len(ms)


def pad_check(torch, fn, calls, kernel):
  """The kernel's profiled ms at a 1 s pad and at PAD_S, in the order
  1 s, PAD_S, PAD_S, 1 s: whether PAD_S reads the kernel times that the
  1 s pad read."""
  global PAD_S
  now, out = PAD_S, []
  try:
    for pad in (1.0, now, now, 1.0):
      PAD_S = pad
      out.append([pad, profiled_ms(torch, fn, calls, kernel)[0]])
  finally:
    PAD_S = now
  return out


GROUPS = ('k4', 'k1', 'mass_chain', 'solve', 'linalg')


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--root', default=os.path.dirname(
      os.path.dirname(os.path.abspath(__file__))))
  ap.add_argument('--only', default=','.join(GROUPS),
                  help='comma list of the groups to time: ' +
                  ', '.join(GROUPS))
  args = ap.parse_args()
  only = args.only.split(',')
  if not set(only) <= set(GROUPS):
    sys.exit(f'kerneltime: --only takes {GROUPS}, not {only}')
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
  from mujoco_warp_tpu_torch.kernels import k1 as kk1
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
  f32 = dict(dtype=torch.float32, device=dev)

  def pre(path, statefn, nworld, warm=False):
    """A scene's model and its seeded state through the position stages
    (world-major Data), with a seeded warmstart when asked."""
    ms = io.load_model_npz(path)
    qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                        statefn(ms, nworld, 7)]
    d = io.make_data(ms, nworld).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)
    if warm:
      d = d.replace(qacc_warmstart=0.1 * torch.as_tensor(
          np.random.default_rng(8).standard_normal((nworld, ms.nv)), **f32))
    return ms, forward.pre(ms, d)

  def chain_args(ms, d):
    return (ms, lanes(d.cinert, 36 * ms.nbody), lanes(d.cdof, 6 * ms.nv),
            lanes(d.qvel))

  def world_major(qM, nv):
    """The large-tree qM world-major (a lanes-last parent's transposed)."""
    return qM.contiguous() if qM.dim() == 3 else \
        world(qM, nv, nv).contiguous()

  calls, kernels = {}, {}
  if {'k4', 'k1'} & set(only):
    # K1 and K4 on the humanoid in contact, K4 fed the plain K1 and glue
    m = io.load_model_npz()
    qpos, qvel, ctrl, ws = [torch.as_tensor(x, device=dev) for x in
                            parity.lane_state(m, W, 7, parity.DROP['contact'])]
    if 'k4' in only:
      qM, qLD, bias, cdof, dist, cpos, cframe, stcom = k1_ref.k1(
          m, qpos, qvel, need_qLD=True)
      con, _ = glue.compact(m, dist, cpos, cframe, stcom)
      qfs = glue.middle(m, bias, qpos, qvel, ctrl)
      a4 = (m, qM, qLD if not k4_ref.has_rows(m) else None, qfs, ws, qvel,
            qpos, cdof, con)
      calls['k4'] = lambda: kk4.k4(*a4)
    if 'k1' in only:
      calls['k1'] = lambda: kk1.k1(m, qpos, qvel, need_qLD=False)
      kernels['k1'] = 'k1_kernel'
  if 'mass_chain' in only:
    for key, path, statefn, nworld in (
        ('mass_chain_n13', io.CONSTRAINTS_SNAPSHOT, parity.general_state, W),
        ('mass_chain_n36', io.SPHERES_SNAPSHOT, parity.spheres_state, W),
        ('mass_chain_n75', io.CLUTTER_SNAPSHOT, parity.clutter_state,
         CL_NWORLD)):
      am = chain_args(*pre(path, statefn, nworld))
      calls[key] = (lambda am: lambda: kmass.mass_chain_lanes(*am))(am)
      kernels[key] = 'mass_chain_kernel'
  if 'solve' in only:
    # the solve kernel on the constraints scene, fed the plain upstream
    mc, d = pre(io.CONSTRAINTS_SNAPSHOT, parity.general_state, W, warm=True)
    nv, nb = mc.nv, mc.nbody
    qM, qLD, cvel, cdd, bias = kmass.mass_chain_plain(*chain_args(mc, d))
    d = forward.mid(mc, d.replace(
        qM=world(qM, nv, nv), qLD=world(qLD, nv, nv), cvel=world(cvel, nb, 6),
        cdof_dot=world(cdd, nv, 6), qfrc_bias=bias.T))
    asv = (mc, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
           lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
           lanes(d.qacc_warmstart))

    # the solve kernel on the spheres scenes' seeded contact states
    def spheres_solve(path, nworld):
      ms = io.load_model_npz(path)
      qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                          parity.spheres_state(ms, nworld, 7)]
      ws = 0.1 * torch.as_tensor(np.random.default_rng(8).standard_normal(
          (nworld, ms.nv)), **f32)
      return parity.solve_args(ms, io.make_data(ms, nworld).replace(
          qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=ws))[0]

    asp = spheres_solve(io.SPHERES_SNAPSHOT, W)
    ase = spheres_solve(io.SPHERES_ELLIPTIC_SNAPSHOT, CL_NWORLD)
    calls.update({
        'solve': lambda: ksolver.solve_tiles(*asv),
        'solve_spheres': lambda: ksolver.solve_tiles(*asp),
        'solve_elliptic': lambda: ksolver.solve_tiles(*ase),
    })
  if 'linalg' in only:
    # the Cholesky kernels at n 75 on the clutter state
    mcl, d = pre(io.CLUTTER_SNAPSHOT, parity.clutter_state, CL_NWORLD)
    nv = mcl.nv
    qM = world_major(kmass.mass_chain_plain(*chain_args(mcl, d))[0], nv)
    L = klinalg.chol_batched_plain(qM, kmass.BIG_JITTER)
    rhs, qacc = [torch.as_tensor(x, **f32) for x in
                 np.random.default_rng(9).standard_normal((2, CL_NWORLD, nv))]
    A_j = (qM + kmass.BIG_JITTER * torch.eye(nv, device=dev)).contiguous()
    # chol_solve at n 36 on the spheres state, its factor lanes-last
    msp, d = pre(io.SPHERES_SNAPSHOT, parity.spheres_state, W)
    nvs = msp.nv
    Ls = world(kmass.mass_chain_plain(*chain_args(msp, d))[1], nvs, nvs)
    rhs_s = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (W, nvs)), **f32)
    calls.update({
        'chol_batched_n75': lambda: klinalg.chol_batched(mcl, qM,
                                                         kmass.BIG_JITTER),
        'cholesky_n75': lambda: torch.linalg.cholesky(A_j),
        'chol_solve_n75': lambda: klinalg.chol_solve_batched(mcl, L, rhs),
        'damped_solve_n75': lambda: klinalg.damped_solve_batched(mcl, qM,
                                                                 qacc),
        'chol_solve_n36': lambda: klinalg.chol_solve_batched(msp, Ls, rhs_s),
    })
    kernels.update({'chol_batched_n75': 'chol_batched_kernel',
                    'chol_solve_n75': 'chol_solve_kernel',
                    'damped_solve_n75': 'damped_solve_kernel',
                    'chol_solve_n36': 'chol_solve_kernel'})

  times = {k: [] for k in calls}
  kernel_ms = {k: [] for k in kernels}
  for _ in range(BLOCKS):
    for k, fn in calls.items():
      times[k].append(events_ms(torch, fn, CALLS))
    for k, name in kernels.items():
      kernel_ms[k].append(profiled_ms(torch, calls[k], CALLS, name))
  # the first profiled kernel at both pads ([pad s, ms] in turn)
  pads = {k: pad_check(torch, calls[k], CALLS, name)
          for k, name in list(kernels.items())[:1]}
  print(json.dumps({'root': root, 'package': os.path.dirname(io.__file__),
                    'card': smi.stdout.strip(), 'nworld': W,
                    'clutter_nworld': CL_NWORLD, 'calls': CALLS, 'ms': times,
                    'kernel_ms': kernel_ms, 'pad_check': pads}), flush=True)


if __name__ == '__main__':
  main()
