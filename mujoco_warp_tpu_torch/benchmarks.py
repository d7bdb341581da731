"""Benchmark harness: batched rollout throughput.

Counterpart of ``mujoco_warp_tpu/benchmarks.py`` ``build`` (:83) and
``run`` (:146).  ``run`` picks the path as the JAX harness does
(:188-271): the fused lanes-last step when the model is inside the fused
gate (``fused.supported``), the general stage-split step
(``ops/forward.py`` ``step``) otherwise.  Worlds start at qpos0 plus
noise, or from a given state; every ``sort_every`` steps worlds are
sorted by their last Newton count with a stable argsort (the OU noise
rides the same permutation) on the fused path, and on the general path
only where the solve kernel runs (``forward.solve_kernel_runs``, as the
JAX harness sorts only where ``psolver.supported``, :250-259); OU noise
drives ctrl every step, and steps/s is timed after a warmup.  A number
counts only when no world overflowed a contact or constraint buffer.
Tensors go to the CUDA device unless ``device='cpu'``.

The scenes are the committed snapshots of ``io``: the humanoid (fused
step, 8192 worlds), ``constraints`` (general step, 8192 worlds),
``clutter_arm_nosleep`` (general step with collision, the large-tree mass
chain and the torch Newton; the JAX registry runs it at 4096 worlds), and
``spheres`` (8192 worlds) and ``spheres_elliptic`` (4096 worlds): the
general step with collision and its contacts, pyramidal and elliptic,
through the solve kernel; dm_control's walker, cheetah, hopper and
humanoid (``humanoid_dmc``) with their sensors, which the fused gate
admits as the JAX gate does (8192 worlds each); ``clutter_arm`` (4096
worlds; the general step with tree sleeping and constraint islands),
``spheres_cg`` (8192; the CG solver) and ``humanoid_implicitfast``
(8192; the humanoid snapshot with ``opt.integrator=implicitfast``, the
registry's stand-in for an implicitfast robot, on the fused step), and
the tendon scenes (8192 worlds each, general step): dm_control's
``ball_in_cup`` and ``point_mass``, ``sensors2`` (the repo's
``sensors2.xml``), ``tendon_wrap`` (spatial tendons over a sphere and a
cylinder) and ``tendon_mix`` (every ported tendon feature); dm_control's
classic tasks (8192 worlds each, general step): ``pendulum``,
``reacher`` and ``finger`` (Euler; cylinders, finger's elliptic cones),
``cartpole`` and ``acrobot`` (RK4) and ``humanoid_CMU`` (nv 62, ellipsoids,
1157 candidates in 48 slots), and two integrator scenes,
``constraints_implicitfast`` (the constraints snapshot under
IMPLICITFAST) and ``cheetah_implicit`` (the cheetah snapshot under
IMPLICIT, which the fused gate refuses); and the elliptic-cone tasks
(8192 worlds each, general step): ``manipulator_insert_peg`` and
``stack_2`` (the elliptic solve kernel at nefc 920 and 725), ``stack_4``
(nefc 1025 x nv 20: the torch elliptic Newton) and ``finger_cg`` (the
finger snapshot under CG, elliptic); and ``humanoid_dmc_dr`` (8192
worlds, general step): dm_control's humanoid with per-world physical
parameters (``io.batch_model``, ``io.set_const``; the draws of
``randomize``), which the fused gate refuses.
``SCENES`` names each with its snapshot and registered width,
``OVERRIDES`` the options set on a snapshot, ``RANDOMIZED`` the scenes
whose worlds draw their own parameters, and ``load_scene`` loads one.
On the general path a sort permutes a batched Model's worlds with the
Data's, so that each world keeps its parameters.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from mujoco_warp_tpu_torch import fused, io, types
from mujoco_warp_tpu_torch.ops import forward

# the fused step is float32 throughout; no product may drop to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')


# scene: (snapshot, registered worlds) of ``benchmarks/__init__.py``
SCENES = {
    'humanoid': (io.SNAPSHOT, 8192),
    'constraints': (io.CONSTRAINTS_SNAPSHOT, 8192),
    'clutter_arm_nosleep': (io.CLUTTER_SNAPSHOT, 4096),
    'spheres': (io.SPHERES_SNAPSHOT, 8192),
    'spheres_elliptic': (io.SPHERES_ELLIPTIC_SNAPSHOT, 4096),
    # dm_control scenes with their sensors, cameras and lights (fused
    # step; humanoid_dmc's contacts compacted into {1: 16, 3: 32} slots)
    **{name: (io.DMC_SNAPSHOTS[name], 8192) for name in io.DMC_NCONMAX},
    'clutter_arm': (io.CLUTTER_ARM_SNAPSHOT, 4096),
    'spheres_cg': (io.SPHERES_CG_SNAPSHOT, 8192),
    'humanoid_implicitfast': (io.SNAPSHOT, 8192),
    # the tendon scenes (general step): dm_control's ball_in_cup and
    # point_mass, sensors2.xml, tendon_wrap and tendon_mix
    **{name: (io.TENDON_SNAPSHOTS[name], 8192) for name in io.TENDON_SNAPSHOTS},
    # dm_control's classic tasks and two integrator scenes (general step)
    **{name: (io.CLASSIC_SNAPSHOTS[name], 8192) for name in io.CLASSIC_DMC},
    'constraints_implicitfast': (io.CONSTRAINTS_SNAPSHOT, 8192),
    'cheetah_implicit': (io.DMC_SNAPSHOTS['cheetah'], 8192),
    # the elliptic-cone tasks (general step): manipulator insert_peg and
    # stacker stack_2 through the elliptic solve kernel, stack_4 through
    # the torch elliptic Newton, and finger under CG
    **{name: (io.TASK_SNAPSHOTS[name], 8192) for name in io.TASK_DMC},
    'finger_cg': (io.CLASSIC_SNAPSHOTS['finger'], 8192),
    # domain randomization (general step): the humanoid, each world with
    # its own physical parameters (``randomize``)
    'humanoid_dmc_dr': (io.DMC_SNAPSHOTS['humanoid_dmc'], 8192),
    # actuation (general step): dm_control's quadruped (walk, run) and
    # dog (stand, walk, trot, run), FILTER activations
    **{name: (io.ACT_SNAPSHOTS[name], 8192) for name in io.ACT_DMC},
}
# scene: Option fields set on its snapshot (``benchmarks/__init__.py:47-49``)
OVERRIDES = {
    'humanoid_implicitfast': {
        'integrator': int(types.IntegratorType.IMPLICITFAST)},
    # the AFFINE actuators' biasprm[2] (-0.4, -2.0) give qDeriv a term
    # beside the joint damping
    'constraints_implicitfast': {
        'integrator': int(types.IntegratorType.IMPLICITFAST)},
    # IMPLICIT's RNE derivative on a planar floating base
    'cheetah_implicit': {'integrator': int(types.IntegratorType.IMPLICIT)},
    # CG with elliptic cones (finger's condim-3 contacts)
    'finger_cg': {'solver': int(types.SolverType.CG)},
}


# scene: the committed state its chip runs start from (``io.load_state``;
# clutter_arm's clutter asleep, as its first hundred steps leave it; the
# elliptic-cone tasks' seeded contact states, ``io.make_task_start``)
START = {'clutter_arm': io.CLUTTER_ARM_SETTLED, **io.TASK_STARTS}


def randomize(m: types.Model, nworld: int, seed: int = 0) -> types.Model:
  """``m`` with per-world physical parameters drawn with numpy from
  ``seed``, the kind RL users of MJX and MJWarp randomize locomotion
  models by: the sliding friction of every geom x U(0.6, 1.4); each
  body's mass and inertia x one factor U(0.8, 1.2), then ``io.set_const``
  (subtree masses, invweights, actuator_acc0 per world); each dof's
  damping x U(0.8, 1.2) and armature x U(1.0, 1.1); each actuator's gain
  x U(0.9, 1.1); gravity (0, 0, -9.81 x U(0.95, 1.05))."""
  rng = np.random.default_rng(seed)
  h = lambda x: types.host(x, np.float32)
  u = lambda lo, hi, *shape: rng.uniform(lo, hi, (nworld,) + shape)
  fric = np.repeat(h(m.geom_friction)[None], nworld, 0)
  fric[..., 0] *= u(0.6, 1.4, m.ngeom)
  body = u(0.8, 1.2, m.nbody)
  gain = np.repeat(h(m.actuator_gainprm)[None], nworld, 0)
  gain[..., 0] *= u(0.9, 1.1, m.nu)
  grav = np.zeros((nworld, 3))
  grav[:, 2] = -9.81 * u(0.95, 1.05)
  mb = io.batch_model(m, nworld, {
      'geom_friction': fric,
      'body_mass': h(m.body_mass) * body,
      'body_inertia': h(m.body_inertia) * body[..., None],
      'dof_damping': h(m.dof_damping) * u(0.8, 1.2, m.nv),
      'dof_armature': h(m.dof_armature) * u(1.0, 1.1, m.nv),
      'actuator_gainprm': gain,
      'opt.gravity': grav})
  return io.set_const(mb)


# scene: the draws of its worlds' parameters
RANDOMIZED = {'humanoid_dmc_dr': randomize}


def start_state(name: str):
  """The state a scene's runs start from (``START``: arrays of n worlds,
  which ``build`` tiles to the width), or None: worlds at qpos0 plus
  noise."""
  return io.load_state(START[name]) if name in START else None


def load_scene(name: str, device=None, nworld: Optional[int] = None):
  """(model, width) of a scene of ``SCENES``: its registered width, or
  ``nworld``; a scene of ``RANDOMIZED`` draws its worlds' parameters at
  that width (seed 0)."""
  path, width = SCENES[name]
  width = width if nworld is None else nworld
  m = io.load_model_npz(path, device=device)
  if name in OVERRIDES:
    m = m.replace(opt=m.opt.replace(**OVERRIDES[name]))
  if name in RANDOMIZED:
    m = RANDOMIZED[name](m, width)
  return m, width


def build(m: types.Model, nworld: int, seed: int = 0, device=None,
          init_state: Optional[dict] = None) -> types.Data:
  """A batch of worlds at qpos0 plus Gaussian qpos noise of std 0.01,
  drawn with numpy from ``seed``; or, given ``init_state`` ({'qpos',
  'qvel', 'tree_asleep', ...} arrays of n worlds, as ``io.load_state``
  gives them), those worlds repeated to ``nworld``, without noise."""
  device = io.resolve_device(device)
  d = io.make_data(m, nworld, device=device)
  if init_state is not None:
    kw = {}
    for k, v in init_state.items():
      v = np.asarray(v)
      reps = -(-nworld // v.shape[0])
      kw[k] = torch.as_tensor(np.tile(v, (reps,) + (1,) * (v.ndim - 1))[
          :nworld], device=device)
    return d.replace(**kw)
  rng = np.random.default_rng(seed)
  qpos = d.qpos.cpu().numpy()
  qpos = qpos + 0.01 * rng.standard_normal(qpos.shape).astype(np.float32)
  return d.replace(qpos=torch.as_tensor(qpos, device=device))


def ou_noise(m: types.Model, replay: bool, device=None, lanes: bool = True):
  """The OU ctrl-noise update of ``benchmarks.run``: around a replayed
  ctrl (rate 0.1 s, std 0.01 of the actuator half-range, clamped to the
  ctrl range) or, without replay, the free form (tau 0.2 s, scale 0.2).
  Its constants go to ``device`` once, not every step.  ``lanes``: noise
  and ctrl are (nu, W), else world-major (W, nu)."""
  device = io.resolve_device(device)
  dt = float(types.host(m.opt.timestep))
  per_act = (lambda x: x[:, None]) if lanes else (lambda x: x[None, :])
  if replay:
    lim = m.actuator_ctrllimited.astype(bool)
    # (1 or W, nu, 2): each world's range where it is batched (the fused
    # path takes no batched Model)
    crange = types.host(types.world_field(m, 'actuator_ctrlrange'),
                        np.float32)
    col = lambda x: torch.as_tensor(np.asarray(
        x[0][:, None] if lanes else x, np.float32), device=device)
    half = col(np.where(lim, 0.5 * (crange[..., 1] - crange[..., 0]), 1.0))
    decay = float(np.exp(-dt / 0.1))
    scale = 0.01 * float(np.sqrt(1.0 - decay * decay))
    lo = col(np.where(lim, crange[..., 0], -np.inf))
    hi = col(np.where(lim, crange[..., 1], np.inf))
  else:
    decay = float(np.exp(-dt / 0.2))
    scale = 0.2 * float(np.sqrt(dt))

  def step(noise, gen, base=None):
    eta = torch.randn(noise.shape, generator=gen, device=noise.device,
                      dtype=noise.dtype)
    if replay:
      noise = noise * decay + scale * half * eta
      ctrl = noise if base is None else per_act(base) + noise
      ctrl = torch.minimum(torch.maximum(ctrl, lo), hi)
    else:
      noise = noise * decay + scale * eta
      ctrl = noise if base is None else per_act(base) + noise
    return noise, ctrl

  return step


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def sorts(m: types.Model, use_fused: bool) -> bool:
  """Does the rollout sort worlds by Newton count?  On the fused path,
  and on the general path where the solve kernel runs (worlds of a block
  wait for its slowest); the torch solver is one loop over every world,
  where order buys nothing (``mujoco_warp_tpu/benchmarks.py:250-251``)."""
  return use_fused or forward.solve_kernel_runs(m)


def rollout(m: types.Model, nworld: int, seed: int = 0, device=None,
            sort_every: int = 4, replay: Optional[dict] = None,
            general: bool = False, init_state: Optional[dict] = None):
  """The benchmark's rollout: sets the worlds up, then returns an endless
  generator of states, one per step: lane states (``fused.FusedState``)
  on the fused path, world-major ``types.Data`` on the general path.
  Every ``sort_every`` steps worlds are sorted by their last Newton count
  where ``sorts`` says so (the OU noise rides the same permutation, and
  on the general path every per-world field of Data and of a batched
  Model, ``types.map_model_worlds``), then the OU noise sets ctrl and
  the step runs.

  ``replay``: {'ctrl': (T, nu) array, 'qpos': (nq,), 'qvel': (nv,)} —
  worlds start from the recorded state exactly and the OU noise runs
  around the replayed ctrl.  ``general``: the general step even for a
  model inside the fused gate (it computes sensordata, the fused step
  does not).  ``init_state``: worlds start from this state, tiled
  (``build``); with ``replay``, which sets the start, it raises.
  """
  return _rollout(m, nworld, seed, device, sort_every, replay, general,
                  init_state)[0]


def _rollout(m, nworld, seed, device, sort_every, replay, general,
             init_state):
  """``rollout``'s generator, and a dict that holds, after each step, the
  Model that step took ('model') and the world each slot holds
  ('world_ids', (W,) int64), as the sorts left them."""
  device = io.resolve_device(device)
  use_fused = fused.supported(m) and not general
  if not use_fused:
    why = forward.unsupported(m)
    if why is not None:
      raise NotImplementedError(
          f'model outside the fused gate ({fused.reason(m)}) and the '
          f'general step ({why})')
  traj = None
  if replay is not None:
    if init_state is not None:
      raise ValueError('replay sets the start state: pass no init_state')
    init_state = {'qpos': np.asarray(replay['qpos'], np.float32)[None],
                  'qvel': np.asarray(replay['qvel'], np.float32)[None]}
    traj = torch.as_tensor(np.asarray(replay['ctrl'], np.float32),
                           device=device)
  d = build(m, nworld, seed, device=device, init_state=init_state)
  if not sorts(m, use_fused):
    sort_every = 0
  ou = ou_noise(m, replay is not None, device, lanes=use_fused)
  gen = torch.Generator(device=device)
  gen.manual_seed(seed)
  now = {'model': m, 'world_ids': torch.arange(nworld, device=device)}

  def fused_steps(st, noise):
    i = 0
    while True:
      if sort_every > 0 and i % sort_every == 0:
        perm = fused.sort_perm(st)
        st = st.map(lambda x: x[:, perm])
        noise = noise[:, perm]
        now['world_ids'] = now['world_ids'][perm]
      if m.nu:
        noise, ctrl = ou(noise, gen,
                         None if traj is None else traj[i % traj.shape[0]])
        st = st.replace(ctrl=ctrl)
      st = fused.step_lane(m, st)
      i += 1
      yield st

  def general_steps(d, noise):
    i = 0
    while True:
      if sort_every > 0 and i % sort_every == 0:
        perm = torch.argsort(d.solver_niter, stable=True)
        d = types.map_worlds(d, lambda x: x[perm], nworld)
        now.update(model=types.map_model_worlds(now['model'],
                                                lambda x: x[perm]),
                   world_ids=now['world_ids'][perm])
        noise = noise[perm]
      if m.nu:
        noise, ctrl = ou(noise, gen,
                         None if traj is None else traj[i % traj.shape[0]])
        d = d.replace(ctrl=ctrl)
      d = forward.step(now['model'], d)
      i += 1
      yield d

  if use_fused:
    st = fused.to_lane(m, d)
    return fused_steps(st, torch.zeros_like(st.ctrl)), now
  return general_steps(d, torch.zeros_like(d.ctrl)), now


def run(m: types.Model, nworld: int = 8192, nstep: int = 100, seed: int = 0,
        warmup_steps: int = 10, device=None, sort_every: int = 4,
        replay: Optional[dict] = None, general: bool = False,
        init_state: Optional[dict] = None) -> dict:
  """Steps/s of the rollout (``rollout``) on ``device``, from
  ``init_state`` where given.  Returns the metrics dict with the keys of
  ``mujoco_warp_tpu.benchmarks.run``, plus the last state under
  'state', the Model it stepped under 'model' (a batched Model's worlds
  sorted with the state's) and the world each slot of the state holds
  under 'world_ids'."""
  device = io.resolve_device(device)
  steps_of, now = _rollout(m, nworld, seed, device, sort_every, replay,
                           general, init_state)
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
  if isinstance(st, fused.FusedState):  # lanes-last
    qpos = st.qpos.T.cpu().numpy()
    overflow = st.overflow[0].cpu().numpy()
  else:
    qpos = st.qpos.cpu().numpy()
    overflow = st.overflow.cpu().numpy()
  cap_bits = int(types.OverflowType.CONTACT | types.OverflowType.CONSTRAINT)
  return {
      # the first step, kernel build at first use included
      'jit_duration': first_step,
      'run_time': run_time,
      'steps_per_sec': sps,
      'realtime_factor': sps * dt,
      'ns_per_step': 1e9 * run_time / steps,
      'converged_worlds': int(np.sum(np.all(np.isfinite(qpos), axis=1))),
      'overflow_worlds': int(np.sum((overflow & cap_bits) != 0)),
      'solver_cap_worlds': int(np.sum(
          (overflow & int(types.OverflowType.SOLVER)) != 0)),
      'nworld': nworld,
      'nstep': nstep,
      'solver_niter_mean': float(st.solver_niter.float().mean()),
      'state': st,
      **now,
  }
