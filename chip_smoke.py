"""Smoke run of the PyTorch + CUDA port on one CUDA device.

  python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
 1. device: needs CUDA; prints the card's name and power limit.
 2. build: compiles kernels/csrc with nvcc for sm_90a.
 3. kernels against their plain PyTorch versions on the card, on the
    snapshot humanoid at 1024 worlds, for a seeded state at rest
    (qpos0 + 0.01 N, qvel 0.2 N) and the same state lowered into the
    floor (contacts active).
 4. the main path: mujoco_warp_tpu_torch.benchmarks.run at 8192 worlds
    with world sorting every 4 steps and OU ctrl noise; the launch counts
    of both kernels must equal the steps run, no world may overflow and
    every world must stay finite.  Then each kernel against its plain
    version again at the main path's width, on the rollout's last state,
    and both timed per launch.
The tolerances are those of mujoco_warp_tpu_torch.parity.  The last two
lines are the kernel JSON and the device JSON.
"""

import json
import subprocess
import sys
import time

import torch

NWORLD = 8192
NSTEP = 300
WARMUP = 10
NCMP = 1024


def fail(msg):
  print(f'FAIL: {msg}', flush=True)
  sys.exit(1)


def say(msg):
  print(msg, flush=True)


def time_ms(fn, reps):
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def main():
  # ---- 1. device
  if not torch.cuda.is_available():
    print('FAIL: no CUDA device', flush=True)
    sys.exit(2)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ''
  if smi.returncode != 0 or not card.rstrip().endswith('W'):
    fail(f'nvidia-smi gave no name and power limit (rc {smi.returncode}): '
         f'{smi.stdout.strip()} {smi.stderr.strip()}')
  kind = torch.cuda.get_device_name(0)
  say(f'[device] {kind}; nvidia-smi: {card}; torch {torch.__version__} '
      f'cuda {torch.version.cuda}')

  from mujoco_warp_tpu_torch import benchmarks, io, parity
  from mujoco_warp_tpu_torch.fused import glue, k1_ref, k4_ref
  from mujoco_warp_tpu_torch.kernels import build
  from mujoco_warp_tpu_torch.kernels import k1 as kk1
  from mujoco_warp_tpu_torch.kernels import k4 as kk4

  # ---- 2. build
  t0 = time.perf_counter()
  build.load()
  say(f'[build] {build.BuildInfo.path} in {time.perf_counter() - t0:.1f} s '
      f'(nvcc {build.BuildInfo.seconds:.1f} s)')
  for line in build.BuildInfo.log.splitlines():
    if 'registers' in line or 'spill' in line or 'error' in line:
      say(f'[build] ptxas: {line.strip()}')

  # ---- 3. kernels against plain versions
  dev = torch.device('cuda')
  m = io.load_model_npz()
  h = float(k4_ref.scalars(m)[3])
  err = {'k1': 0.0, 'k4': 0.0}

  def compare(label, qpos, qvel, ctrl, ws, state, need_qLD):
    """Both kernels against their plain versions on one state; K4 gets
    the plain K1's outputs on both sides.  Returns those and K4's
    arguments."""
    got1 = kk1.k1(m, qpos, qvel, need_qLD=need_qLD)
    want1 = k1_ref.k1(m, qpos, qvel, need_qLD=need_qLD)
    try:
      e1, rel1 = parity.check_k1(got1, want1)
    except AssertionError as e:
      fail(f'{label}: {e}')
    qM, qLD, bias, cdof, dist, cpos, cframe, stcom = want1
    con, _ = glue.compact(m, dist, cpos, cframe, stcom)
    qfs = glue.middle(m, bias, qpos, qvel, ctrl)
    args = (m, qM, qLD if not k4_ref.has_rows(m) else None, qfs, ws, qvel,
            qpos, cdof, con)
    got4, want4 = kk4.k4(*args), k4_ref.k4(*args)
    try:
      r4 = parity.check_k4(got4, want4, qvel, h, state)
    except AssertionError as e:
      fail(f'{label} K4: {e}')
    err['k1'] = max(err['k1'], e1)
    err['k4'] = max(err['k4'], r4['qacc_max_abs_err'])
    act = int((con['dist'] < con['im']).sum())
    say(f'[compare] {label}: K1 max abs err {e1:.3e}, worst relative '
        f'{rel1:.2e} (tol {parity.K1_TOL}); K4 qacc max abs err '
        f'{r4["qacc_max_abs_err"]:.3e} within atol {parity.QACC_ATOL} + '
        f'rtol {parity.QACC_RTOL} of world scale; niter equal in '
        f'{r4["niter_share"]:.4f} of worlds (bar '
        f'{parity.NITER_SHARE[state]}), max diff {r4["niter_max_diff"]} '
        f'(bar {parity.NITER_MAX_DIFF}); niter mean {r4["niter_mean"]:.3f}; '
        f'active contacts {act}')
    return want1, args

  for state, drop in parity.DROP.items():
    qpos, qvel, ctrl, ws = [torch.as_tensor(x, device=dev) for x in
                            parity.lane_state(m, NCMP, 7, drop)]
    compare(f'{state} W={NCMP}', qpos, qvel, ctrl, ws, state, True)

  # ---- 4. the main path
  kk1.launches = kk4.launches = 0
  res = benchmarks.run(m, nworld=NWORLD, nstep=NSTEP, warmup_steps=WARMUP,
                       device='cuda')
  launches = {'k1': kk1.launches, 'k4': kk4.launches}
  steps = NSTEP + WARMUP
  st = res.pop('state')
  if launches != {'k1': steps, 'k4': steps}:
    fail(f'launch counts {launches} != {steps} steps')
  if res['overflow_worlds'] != 0:
    fail(f"overflow in {res['overflow_worlds']} worlds")
  if res['converged_worlds'] != NWORLD:
    fail(f"{res['converged_worlds']} of {NWORLD} worlds finite")
  say(f"[main path] {NWORLD} worlds x {NSTEP} steps (+{WARMUP} warmup): "
      f"{res['steps_per_sec']:.1f} steps/s, first step "
      f"{res['jit_duration']:.3f} s, solver_niter_mean "
      f"{res['solver_niter_mean']:.4f}, solver_cap_worlds "
      f"{res['solver_cap_worlds']}, overflow_worlds 0, "
      f"{res['converged_worlds']}/{NWORLD} finite, launches {launches}")
  say('[main path] metrics ' + json.dumps(res))

  # both kernels against their plain versions at the main path's width,
  # on its last state (feet on the floor), then timed per launch
  k1_out, a4 = compare(f'rollout W={NWORLD}', st.qpos, st.qvel, st.ctrl,
                       st.warmstart, 'contact', False)
  _, _, bias, _, dist, cpos, cframe, stcom = k1_out
  glue_ms = time_ms(lambda: (glue.compact(m, dist, cpos, cframe, stcom),
                             glue.middle(m, bias, st.qpos, st.qvel, st.ctrl)),
                    20)
  ms = {
      'k1': time_ms(lambda: kk1.k1(m, st.qpos, st.qvel, need_qLD=False), 20),
      'k4': time_ms(lambda: kk4.k4(*a4), 20),
  }
  plain_ms = {
      'k1': time_ms(lambda: k1_ref.k1(m, st.qpos, st.qvel, need_qLD=False),
                    3),
      'k4': time_ms(lambda: k4_ref.k4(*a4), 3),
  }
  say(f"[timing] W={NWORLD} per launch: K1 cuda {ms['k1']:.3f} ms, plain "
      f"{plain_ms['k1']:.3f} ms; K4 cuda {ms['k4']:.3f} ms, plain "
      f"{plain_ms['k4']:.3f} ms; glue (compaction + smooth forces) "
      f"{glue_ms:.3f} ms; step {1e3 * NWORLD / res['steps_per_sec']:.3f} ms")

  src = 'mujoco_warp_tpu_torch/kernels/csrc/'
  print(json.dumps({'kernels': [
      {'name': 'k1', 'route': 'cuda', 'source': src + 'k1.cu',
       'replaces': 'mujoco_warp_tpu/pallas/fused.py:986',
       'launches': launches['k1'], 'max_abs_err': err['k1'],
       'ms': ms['k1'], 'plain_ms': plain_ms['k1']},
      {'name': 'k4', 'route': 'cuda', 'source': src + 'k4.cu',
       'replaces': 'mujoco_warp_tpu/pallas/fused.py:1247',
       'launches': launches['k4'], 'max_abs_err': err['k4'],
       'ms': ms['k4'], 'plain_ms': plain_ms['k4']},
  ]}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
