"""The general stage-split step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/forward.py``: ``fwd_actuation``
(:333), ``fwd_smooth_force`` (:479), ``_next_position`` (:497),
``_advance`` (:523), ``euler`` (:540), ``rungekutta4`` (:573),
``_step_batched`` (:696) and
``step`` (:649), ``_island_lazy`` (:679) and ``_step_sleep_skip`` (:814)
for batched Data.  The stage order of ``_step_batched`` is kept: the wake
pass, the position stages with the camera, light and site frames
and the tendons (``pre``), the mass chain (kernel; in the large-tree form,
for a large tree or tendon armature, the factor from the ``chol_batched``
kernel after the armature term) and the tendon armature's bias,
collision (with contact compaction) and the
collision wake, the constraint rows, the equality wake and the masking of
sleeping rows, the position sensors, passive forces, the velocity sensors
and actuator forces (``mid``), the lazy island labeler, qacc_smooth
(Cholesky-solve kernel), the solve (the Newton solve kernel; for a large
system or the CG solver the torch solver of ``ops/solver.py`` around the
``chol_batched`` and ``chol_solve`` kernels), qacc zeroed on sleeping
dofs, the acceleration sensors, the integrator and the sleep pass.  On
CUDA tensors the kernels launch; on CPU tensors their plain versions run.

The integrators: Euler with its damped solve (kernel), RK4 (three more
forwards through the same stages and kernels, ``rungekutta4``), and
IMPLICIT / IMPLICITFAST (``ops/derivative.py``).

``unsupported`` is this slice's gate: the models the general step runs
are those it returns None for.  Contact rows go through either solver,
frictionless, pyramidal or elliptic: the solve kernel (Newton, nefc x nv
up to 12,000) or the torch Newton and CG of ``ops/solver.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import k4_ref
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.kernels import solver as ksolver
from mujoco_warp_tpu_torch.ops import collision_driver, constraint, \
    derivative, island, math, passive, sensor, smooth, support
from mujoco_warp_tpu_torch.ops import sleep as osleep
from mujoco_warp_tpu_torch.ops import solver as osolver
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, host_item, ix

_JT = types.JointType
_GT = types.GainType
_BT = types.BiasType
_IT = types.IntegratorType
_INTEGRATORS = (_IT.EULER, _IT.RK4, _IT.IMPLICIT, _IT.IMPLICITFAST)
# RK4's stage fractions and weights (``forward.py:576-577``)
_RK4_A = (0.5, 0.5, 1.0)
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)

# beyond this nefc * nv the JAX package leaves the Pallas solver for the
# jnp Newton (pallas/solver.py _use_big :65), ops/solver.py here
MAX_NEFC_NV = 12_000

# steps so far on which the island labeler ran, and steps that packed the
# awake worlds (``_step_sleep_skip``)
island_runs = 0
packed_steps = 0


def large_system(m: types.Model) -> bool:
  """Does ``m`` take the torch Newton of ``ops/solver.py``?  Beyond
  nefc * nv 12,000, or where one world's system does not fit in the solve
  kernel's shared memory (as the JAX package bounds its kernel's VMEM,
  ``pallas/solver.py`` ``supported`` :128)."""
  return m.nefc * m.nv > MAX_NEFC_NV or not ksolver.fits(m)


def solve_kernel_runs(m: types.Model) -> bool:
  """Does the solve kernel run ``m``'s solve (``pallas/solver.py``
  ``supported`` :110)?  Newton only, with rows, within its size."""
  return (m.opt.solver == types.SolverType.NEWTON and m.nefc > 0 and
          not (m.opt.disableflags & types.DisableBit.CONSTRAINT) and
          not large_system(m))


def unsupported(m: types.Model):
  """Why the general step cannot run ``m`` yet, or None."""
  o = m.opt
  for n, what in ((m.nflex, 'flex'), (m.nmocap, 'mocap'),
                  (m.na, 'actuator activation'), (m.nhistory, 'history')):
    if n:
      return what
  later = sensor.deferred(m)
  if later:
    return 'sensor types ' + ', '.join(f'{t} (waits for {why})'
                                      for t, why in later)
  if o.solver not in (types.SolverType.NEWTON, types.SolverType.CG):
    return 'solver (PGS)'
  if o.integrator not in _INTEGRATORS:
    return f'integrator {o.integrator}'
  if o.integrator == types.IntegratorType.RK4 and osleep.enabled(m):
    return 'sleep under RK4 (its stage forwards run no wake pass)'
  if m.nu:
    if not np.all(np.isin(m.actuator_trntype, (types.TrnType.JOINT,
                                               types.TrnType.TENDON))):
      return 'actuator transmission (slider-crank, site or body)'
    if not np.all(m.actuator_dyntype == types.DynType.NONE):
      return 'actuator dynamics'
    if not (np.all(np.isin(m.actuator_gaintype, (_GT.FIXED, _GT.AFFINE))) and
            np.all(np.isin(m.actuator_biastype, (_BT.NONE, _BT.AFFINE)))):
      return 'muscle, dcmotor or user actuators'
  if np.any(m.jnt_actgravcomp) or np.any(m.jnt_actfrclimited):
    return 'actuator gravcomp or force limits'
  if m.neq:
    if len(m.efc.flex_id):
      return 'flex equality'
    if np.any(m.eq_objtype == 6):  # mjOBJ_SITE
      return 'site-anchored equality'
  if float(types.host(m.opt.density)) or float(types.host(m.opt.viscosity)):
    return 'fluid forces'
  if np.any(types.host(m.body_gravcomp) != 0):
    return 'gravcomp'
  if m.nv > klinalg.MAX_N:
    return f'nv {m.nv} above the Cholesky kernels\' cap {klinalg.MAX_N}'
  if not kmass.fits(m):
    return (f'size (mass-chain world: nv {m.nv}, nbody {m.nbody}, '
            f'{kmass.world_bytes(m)} shared bytes, more than a block holds)')
  return None


def fwd_actuation(m: types.Model, d: types.Data) -> types.Data:
  """Actuator forces: FIXED or AFFINE gain and bias, no activation, ctrl
  clamped to its range (``forward.py:333``); gainprm and biasprm per
  world where they are batched."""
  zero_v = torch.zeros_like(d.qvel)
  if not m.nu or (m.opt.disableflags & types.DisableBit.ACTUATION):
    return d.replace(actuator_force=d.ctrl[:, :0].expand(-1, m.nu) * 0.0,
                     qfrc_actuator=zero_v)
  ctrl = d.ctrl
  if not (m.opt.disableflags & types.DisableBit.CLAMPCTRL):
    lim = bmask(m.actuator_ctrllimited, ctrl.device)
    cr = m.actuator_ctrlrange
    ctrl = torch.where(lim, torch.minimum(torch.maximum(ctrl, cr[:, 0]),
                                          cr[:, 1]), ctrl)
  length, velocity = d.actuator_length, d.actuator_velocity
  gt, gp = m.actuator_gaintype, types.world_field(m, 'actuator_gainprm')
  gain = torch.zeros_like(ctrl)
  gain = torch.where(bmask(gt == _GT.FIXED, ctrl.device),
                     gp[..., 0], gain)
  if np.any(gt == _GT.AFFINE):
    gain = torch.where(bmask(gt == _GT.AFFINE, ctrl.device),
                       gp[..., 0] + gp[..., 1] * length +
                       gp[..., 2] * velocity, gain)
  bias = torch.zeros_like(ctrl)
  bt, bp = m.actuator_biastype, types.world_field(m, 'actuator_biasprm')
  if np.any(bt == _BT.AFFINE):
    bias = torch.where(bmask(bt == _BT.AFFINE, ctrl.device),
                       bp[..., 0] + bp[..., 1] * length +
                       bp[..., 2] * velocity, bias)
  force = gain * ctrl + bias
  if np.any(m.actuator_forcelimited):
    lim = bmask(m.actuator_forcelimited, ctrl.device)
    fr = m.actuator_forcerange
    force = torch.where(lim, torch.minimum(torch.maximum(force, fr[:, 0]),
                                           fr[:, 1]), force)
  if m.ntendon and np.any(m.tendon_actfrclimited):
    force = _tendon_force_clamp(m, force)
  qfrc = torch.einsum('wuv,wu->wv', d.actuator_moment, force)
  return d.replace(actuator_force=force, qfrc_actuator=qfrc)


def _tendon_force_clamp(m: types.Model, force):
  """Each limited tendon's total actuator force held to its
  actfrcrange, by scaling the forces of its actuators
  (``forward.py:427-445``)."""
  dev = force.device
  is_ten = m.actuator_trntype == types.TrnType.TENDON
  tid = np.where(is_ten, m.actuator_trnid[:, 0], 0)
  # actuator -> tendon, a static (nu, ntendon) one-hot sum
  S = np.zeros((m.nu, m.ntendon), np.float32)
  S[np.nonzero(is_ten)[0], tid[is_ten]] = 1.0
  ten_frc = force @ fmask(S, force)
  rng = m.tendon_actfrcrange
  lim = bmask(m.tendon_actfrclimited, dev)
  safe = torch.where(ten_frc != 0, ten_frc, 1.0)
  scale_lo = torch.where((ten_frc < rng[:, 0]) & lim, rng[:, 0] / safe, 1.0)
  scale_hi = torch.where((ten_frc > rng[:, 1]) & lim, rng[:, 1] / safe, 1.0)
  scale = (scale_lo * scale_hi)[:, ix(tid, dev)]
  return torch.where(bmask(is_ten, dev), force * scale, force)


def fwd_smooth_force(m: types.Model, d: types.Data) -> types.Data:
  """qfrc_smooth = passive - bias + actuator + applied (``forward.py:479``)."""
  qfrc_applied = d.qfrc_applied + support.xfrc_accumulate(m, d)
  return d.replace(qfrc_smooth=d.qfrc_passive - d.qfrc_bias +
                   d.qfrc_actuator + qfrc_applied)


def _next_position(m: types.Model, qpos, qvel, dt):
  """qpos advanced by dt qvel per joint type (``forward.py:497``)."""
  dev = qpos.device
  out = qpos.clone()
  for jt in np.unique(m.jnt_type):
    jids = np.nonzero(m.jnt_type == jt)[0]
    qadr, dadr = m.jnt_qposadr[jids], m.jnt_dofadr[jids]
    span = lambda adr, a, b: ix(adr[:, None] + np.arange(a, b), dev)
    if jt == _JT.FREE:
      q3, d3 = span(qadr, 0, 3), span(dadr, 0, 3)
      out[:, q3] = qpos[:, q3] + dt * qvel[:, d3]
      q4 = span(qadr, 3, 7)
      quat = math.normalize_quat(qpos[:, q4])
      out[:, q4] = math.quat_integrate(quat, qvel[:, span(dadr, 3, 6)], dt)
    elif jt == _JT.BALL:
      q4 = span(qadr, 0, 4)
      quat = math.normalize_quat(qpos[:, q4])
      out[:, q4] = math.quat_integrate(quat, qvel[:, span(dadr, 0, 3)], dt)
    else:
      qa = ix(qadr, dev)
      out[:, qa] = qpos[:, qa] + dt * qvel[:, ix(dadr, dev)]
  return out


def _advance(m: types.Model, d: types.Data, qacc, qvel=None
             ) -> types.Data:
  """Integrate by one timestep (``forward.py:523``): qvel += dt qacc,
  and qpos integrates with the new qvel, or with ``qvel`` where given
  (RK4's weighted velocity)."""
  dt = m.opt.timestep
  qvel_new = d.qvel + dt * qacc
  qpos = _next_position(m, d.qpos, qvel_new if qvel is None else qvel, dt)
  return d.replace(qvel=qvel_new, qpos=qpos, time=d.time + dt,
                   qacc_warmstart=d.qacc)


def euler(m: types.Model, d: types.Data) -> types.Data:
  """Semi-implicit Euler with implicit joint damping (``forward.py:540``),
  the damped system solved whole by the damped-solve kernel."""
  if k4_ref.damped(m):
    return _advance(m, d, klinalg.damped_solve_batched(m, d.qM, d.qacc))
  return _advance(m, d, d.qacc)


def _forward(m: types.Model, d: types.Data) -> types.Data:
  """One forward of an RK4 stage (JAX's ``_forward``, :607): the step's
  stages up to the solve, with its kernels; the sensors are left out,
  since the stage's sensordata is dropped."""
  with stage('pre'):
    d = pre(m, d)
  with stage('mass_chain'):
    d = mass_chain(m, d)
  d = mid(m, d, sensors=False)
  with stage('qacc_smooth'):
    d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m, d.qLD,
                                                         d.qfrc_smooth))
  with stage('solve'):
    return solve(m, d)


def rungekutta4(m: types.Model, d: types.Data) -> types.Data:
  """Explicit RK4 (``forward.py:573``) from the step's forward at t0:
  three more forwards at the stage states, then the t0 state advanced by
  the weighted accelerations, qpos by the weighted velocities.  Each
  stage's solve warmstarts from the qacc_warmstart the stage before left
  (the t0 solve's for the first); the final qacc is the last stage's.  All
  else of d (sensordata, energy, solver_niter, overflow) stays the t0
  forward's."""
  dt = m.opt.timestep
  qvel_rk = _RK4_B[0] * d.qvel
  qacc_rk = _RK4_B[0] * d.qacc
  dd = d
  for a, b in zip(_RK4_A, _RK4_B[1:]):
    with stage('integrate'):
      dd = dd.replace(qpos=_next_position(m, d.qpos, dd.qvel, a * dt),
                      qvel=d.qvel + (a * dt) * dd.qacc)
    dd = _forward(m, dd)
    with stage('integrate'):
      qvel_rk = qvel_rk + b * dd.qvel
      qacc_rk = qacc_rk + b * dd.qacc
  with stage('integrate'):
    return _advance(m, d.replace(qacc=dd.qacc), qacc_rk, qvel=qvel_rk)


def integrate(m: types.Model, d: types.Data) -> types.Data:
  """The model's integrator (``_step_batched`` ``post``, :759)."""
  integ = m.opt.integrator
  if integ == _IT.RK4:
    return rungekutta4(m, d)
  with stage('integrate'):
    if integ == _IT.EULER:
      return euler(m, d)
    return derivative.implicit(m, d)


def solve(m: types.Model, d: types.Data) -> types.Data:
  """qacc from qacc_smooth and the constraint rows (``ops/solver.py``
  ``solve_batched`` :704): the Newton kernel, the torch solver for a
  Newton system beyond nefc * nv 12,000 and for CG at every size
  (``pallas/solver.py`` ``supported`` :110-120), or qacc_smooth when the
  model has no rows."""
  if m.nefc == 0 or (m.opt.disableflags & types.DisableBit.CONSTRAINT):
    W = d.qpos.shape[0]
    return d.replace(
        qacc=d.qacc_smooth, qacc_warmstart=d.qacc_smooth,
        qfrc_constraint=torch.zeros_like(d.qvel),
        solver_niter=torch.zeros(W, dtype=torch.int32, device=d.qpos.device))
  if solve_kernel_runs(m):
    return ksolver.solve_batched(m, d)
  return osolver.solve(m, d)


def pre(m: types.Model, d: types.Data) -> types.Data:
  """The position stages before the mass chain (``_step_batched`` pre):
  kinematics, com_pos, camlight and the tendons."""
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.camlight(m, d)
  return smooth.tendon(m, d)


def mass_chain(m: types.Model, d: types.Data) -> types.Data:
  """The mass chain (kernel; in the large-tree form the tendon armature
  term and the ``chol_batched`` factor follow), then the tendon
  armature's bias (``fwd_velocity``'s ``tendon_bias``: qfrc_bias from the
  chain plus the armature's term)."""
  return smooth.tendon_bias(m, kmass.mass_chain(m, d))


def stage(name: str):
  """A ``torch.profiler`` annotation ``stage:<name>`` around one stage of
  the step (``devprofile`` sums their host time; a no-op otherwise)."""
  return torch.profiler.record_function(f'stage:{name}')


def mid(m: types.Model, d: types.Data, sensors: bool = True
        ) -> types.Data:
  """The stages after the mass chain: collision, constraint rows,
  transmission, the position sensors and energy, passive forces, the
  velocity sensors and energy, actuator forces, qfrc_smooth
  (``_step_batched`` mid); without ``sensors``, no sensor and no
  energy."""
  sleeping = osleep.enabled(m)
  if m.ntendon:
    # ten_J qvel (JAX sets it after the rows, :746-748): the tendon
    # friction rows read it, this step's as in MuJoCo C, where the JAX
    # rows read the value the Data carries in (``constraint.py:607-616``)
    with stage('forces'):
      d = d.replace(ten_velocity=torch.einsum('wtv,wv->wt', d.ten_J,
                                              d.qvel))
  if m.opt.run_collision_detection:
    with stage('collision'):
      d = collision_driver.collision(m, d)
    if sleeping:
      with stage('sleep'):
        d = osleep.wake_collision(m, d)
  with stage('rows'):
    d = constraint.make_constraint(m, d)
  if sleeping:
    with stage('sleep'):
      d = osleep.mask_sleeping(m, osleep.wake_equality(m, d))
  with stage('forces'):
    d = smooth.transmission(m, d)
  if sensors:
    with stage('sensors'):
      d = sensor.energy_pos(m, sensor.sensor_pos(m, d))
  with stage('forces'):
    if m.nu:
      d = d.replace(actuator_velocity=torch.einsum(
          'wuv,wv->wu', d.actuator_moment, d.qvel))
    d = passive.passive(m, d)
  if sensors:
    with stage('sensors'):
      d = sensor.energy_vel(m, sensor.sensor_vel(m, d))
  with stage('forces'):
    d = fwd_actuation(m, d)
    return fwd_smooth_force(m, d)


def _island_lazy(m: types.Model, d: types.Data) -> types.Data:
  """The island labeler, on steps where some world has a sleep candidate
  (``forward.py:679``): islands feed only ``sleep``'s island test, which
  can change an outcome only for an awake tree whose counter reaches
  ready this step; a sleeping tree's stale labels are exact (see
  ``sleep.sleep_candidate``).  One host read of a device bool decides."""
  global island_runs
  if host_item(osleep.sleep_candidate(m, d).any(), 'island'):
    island_runs += 1
    with stage('island'):
      return island.island(m, d)
  return d


def _step_batched(m: types.Model, d: types.Data,
                  run_wake: bool = True) -> types.Data:
  """One stage-split step of batched Data (``forward.py:696``)."""
  sleeping = osleep.enabled(m)
  if run_wake and sleeping:
    with stage('sleep'):
      d = osleep.wake(m, d)
  with stage('pre'):
    d = pre(m, d)
  # crb, qM, qLD, com_vel, cdof_dot and rne in one kernel (a large tree's
  # qLD from the chol_batched kernel)
  with stage('mass_chain'):
    d = mass_chain(m, d)
  d = mid(m, d)
  if sleeping:
    d = _island_lazy(m, d)
  # qacc_smooth through the mass factor
  with stage('qacc_smooth'):
    d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m, d.qLD,
                                                         d.qfrc_smooth))
  with stage('solve'):
    d = solve(m, d)
  if sleeping:
    with stage('sleep'):
      d = d.replace(qacc=torch.where(osleep.dof_awake_mask(m, d), d.qacc,
                                     0.0))
  # the accelerometer reads the undamped qacc
  with stage('sensors'):
    d = sensor.sensor_acc(m, d)
  d = integrate(m, d)
  if sleeping:
    with stage('sleep'):
      d = osleep.sleep(m, d)
  return d


def _step_sleep_skip(m: types.Model, d: types.Data) -> types.Data:
  """A step that skips the fully asleep worlds (``forward.py:814``): after
  the wake pass, the worlds with an awake tree are packed into ``W // 4``
  slots (awake worlds first, in world order, by a stable sort; the rest of
  the pack is asleep worlds whose result is dropped) and only the pack
  steps; every world's clock advances.  The pack gathers only the state
  the step carries (``types.CARRY``: the step recomputes the rest) and
  scatters every field the step computed back to its awake worlds.  A
  fully asleep world has no wake source but a user force, which the wake
  pass reads.  With more than ``W // 4`` worlds awake the whole batch
  steps.  One host read of the awake count decides."""
  global packed_steps
  W = d.qpos.shape[0]
  cap = W // 4
  with stage('sleep'):
    d = osleep.wake(m, d)
    awake_w = torch.any(d.tree_asleep < 0, dim=1)
  nawake = host_item(awake_w.sum(), 'pack')
  if nawake > cap:
    d2 = _step_batched(m, d, run_wake=False)
  else:
    packed_steps += 1
    with stage('sleep'):
      ids = torch.argsort((~awake_w).to(torch.int8), stable=True)[:cap]
      sub = types.carried(d, lambda x: x[ids])
    sub = _step_batched(m, sub, run_wake=False)
    with stage('sleep'):
      d2 = types.scatter_worlds(d, sub, ids[:nawake], W)
  return d2.replace(time=d.time + m.opt.timestep)


def step(m: types.Model, d: types.Data) -> types.Data:
  """One physics step of batched Data (``forward.py:649``): with sleep on
  and at least 256 worlds, the step that skips asleep worlds
  (``forward.py:674-675``).  A Model with per-world fields
  (``io.batch_model``) takes Data of its batch's width and runs
  ``_step_batched``, each stage reading world w's values, as the JAX
  step vmaps its per-world step over them (:657-671)."""
  if d.qpos.dim() != 2:
    raise ValueError('the general step takes batched (W, nq) Data')
  why = unsupported(m)
  if why is not None:
    raise NotImplementedError(f'general step: {why} is not ported yet')
  nb = types.model_nworld(m)
  if nb is not None:
    if nb != d.qpos.shape[0]:
      raise ValueError(f'the Model\'s fields are batched over {nb} worlds, '
                       f'the Data holds {d.qpos.shape[0]}')
    return _step_batched(m, d)
  if osleep.enabled(m) and d.qpos.shape[0] >= 256:
    return _step_sleep_skip(m, d)
  return _step_batched(m, d)
