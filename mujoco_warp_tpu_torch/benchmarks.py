"""Benchmark harness: batched rollout throughput of the fused step.

Counterpart of ``mujoco_warp_tpu/benchmarks.py`` ``build`` (:83) and
``run`` (:146) on the fused branch: worlds start at qpos0 plus noise, the
state goes lanes-last once, every ``sort_every`` steps worlds are sorted
by their last Newton count (the OU noise rides the same permutation), OU
noise drives ctrl every step, and steps/s is timed after a warmup.  A
number counts only when no world overflowed a contact buffer.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from mujoco_warp_tpu_torch import fused, io, types

# the fused step is float32 throughout; no product may drop to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')


def build(m: types.Model, nworld: int, seed: int = 0, device='cpu',
          init_qpos=None, init_qvel=None,
          qpos_noise: float = 0.01) -> io.Data:
  """A batch of worlds at qpos0 (or ``init_qpos``) plus Gaussian qpos
  noise, drawn with numpy from ``seed``."""
  d = io.make_data(m, nworld, device=device)
  rng = np.random.default_rng(seed)
  qpos = d.qpos.cpu().numpy()
  if init_qpos is not None:
    qpos = np.broadcast_to(np.asarray(init_qpos, np.float32),
                           qpos.shape).copy()
  if qpos_noise:
    qpos = qpos + qpos_noise * rng.standard_normal(qpos.shape).astype(
        np.float32)
  d = d.replace(qpos=torch.as_tensor(qpos, device=device))
  if init_qvel is not None:
    qvel = np.broadcast_to(np.asarray(init_qvel, np.float32), d.qvel.shape)
    d = d.replace(qvel=torch.as_tensor(qvel.copy(), device=device))
  return d


def ou_noise(m: types.Model, replay: bool, device='cpu'):
  """The OU ctrl-noise update of ``benchmarks.run``: around a replayed
  ctrl (rate 0.1 s, std 0.01 of the actuator half-range, clamped to the
  ctrl range) or, without replay, the free form (tau 0.2 s, scale 0.2).
  Its constants go to ``device`` once, not every step."""
  dt = float(types.host(m.opt.timestep))
  if replay:
    lim = m.actuator_ctrllimited.astype(bool)
    crange = types.host(m.actuator_ctrlrange, np.float32)
    col = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                    device=device)[:, None]
    half = col(np.where(lim, 0.5 * (crange[:, 1] - crange[:, 0]), 1.0))
    decay = float(np.exp(-dt / 0.1))
    scale = 0.01 * float(np.sqrt(1.0 - decay * decay))
    lo = col(np.where(lim, crange[:, 0], -np.inf))
    hi = col(np.where(lim, crange[:, 1], np.inf))
  else:
    decay = float(np.exp(-dt / 0.2))
    scale = 0.2 * float(np.sqrt(dt))

  def step(noise, gen, base=None):
    eta = torch.randn(noise.shape, generator=gen, device=noise.device,
                      dtype=noise.dtype)
    if replay:
      noise = noise * decay + scale * half * eta
      ctrl = noise if base is None else base[:, None] + noise
      ctrl = torch.minimum(torch.maximum(ctrl, lo), hi)
    else:
      noise = noise * decay + scale * eta
      ctrl = noise if base is None else base[:, None] + noise
    return noise, ctrl

  return step


def _sync(device):
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def rollout(m: types.Model, nworld: int, seed: int = 0, device='cuda',
            sort_every: int = 4, replay: Optional[dict] = None):
  """The benchmark's rollout: sets the worlds up, then returns an endless
  generator of lane states, one per fused step.  Every ``sort_every`` steps worlds are sorted by their
  last Newton count (the OU noise rides the same permutation), then the OU
  noise sets ctrl and the fused step runs.

  ``replay``: {'ctrl': (T, nu) array, 'qpos': (nq,), 'qvel': (nv,)} —
  worlds start from the recorded state exactly and the OU noise runs
  around the replayed ctrl.
  """
  if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('rollout(device="cuda") needs a CUDA device')
  fused.supported_features(m)
  kw = dict(qpos_noise=0.01)
  traj = None
  if replay is not None:
    kw = dict(init_qpos=replay['qpos'], init_qvel=replay['qvel'],
              qpos_noise=0.0)
    traj = torch.as_tensor(np.asarray(replay['ctrl'], np.float32),
                           device=device)
  st = fused.to_lane(m, build(m, nworld, seed, device=device, **kw))
  ou = ou_noise(m, replay is not None, device)
  gen = torch.Generator(device=device)
  gen.manual_seed(seed)

  def steps(st, noise):
    i = 0
    while True:
      if sort_every > 0 and i % sort_every == 0:
        perm = fused.sort_perm(st)
        st = st.map(lambda x: x[:, perm])
        noise = noise[:, perm]
      if m.nu:
        noise, ctrl = ou(noise, gen,
                         None if traj is None else traj[i % traj.shape[0]])
        st = st.replace(ctrl=ctrl)
      st = fused.step_lane(m, st)
      i += 1
      yield st

  return steps(st, torch.zeros_like(st.ctrl))


def run(m: types.Model, nworld: int = 8192, nstep: int = 100, seed: int = 0,
        warmup_steps: int = 10, device='cuda', sort_every: int = 4,
        replay: Optional[dict] = None) -> dict:
  """Steps/s of the fused rollout (``rollout``) on ``device``.  Returns
  the metrics dict with the keys of ``mujoco_warp_tpu.benchmarks.run``."""
  steps_of = rollout(m, nworld, seed, device, sort_every, replay)
  t0 = time.perf_counter()
  st = next(steps_of)
  _sync(device)
  first_step = time.perf_counter() - t0
  for _ in range(max(warmup_steps - 1, 0)):
    st = next(steps_of)
  _sync(device)
  t0 = time.perf_counter()
  for _ in range(nstep):
    st = next(steps_of)
  _sync(device)
  run_time = time.perf_counter() - t0

  dt = float(types.host(m.opt.timestep))
  steps = nworld * nstep
  sps = steps / run_time
  qpos = st.qpos.cpu().numpy()
  overflow = st.overflow[0].cpu().numpy()
  cap_bits = int(types.OverflowType.CONTACT | types.OverflowType.CONSTRAINT)
  return {
      # the first step, kernel build at first use included
      'jit_duration': first_step,
      'run_time': run_time,
      'steps_per_sec': sps,
      'realtime_factor': sps * dt,
      'ns_per_step': 1e9 * run_time / steps,
      'converged_worlds': int(np.sum(np.all(np.isfinite(qpos), axis=0))),
      'overflow_worlds': int(np.sum((overflow & cap_bits) != 0)),
      'solver_cap_worlds': int(np.sum(
          (overflow & int(types.OverflowType.SOLVER)) != 0)),
      'nworld': nworld,
      'nstep': nstep,
      'solver_niter_mean': float(st.solver_niter.float().mean()),
      'state': st,
  }
