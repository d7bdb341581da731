"""The general stage-split step, world-major.

Counterpart of ``mujoco_warp_tpu/ops/forward.py``: ``_next_act`` (:97),
``_dcmotor_force`` (:194), ``fwd_actuation`` (:333), ``fwd_smooth_force``
(:479), ``_next_position`` (:497),
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
and actuator dynamics and forces (``mid``), the lazy island labeler, qacc_smooth
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
from mujoco_warp_tpu_torch.ops import actuation, collision_driver, \
    constraint, derivative, island, math, passive, sensor, smooth, support
from mujoco_warp_tpu_torch.ops import sleep as osleep
from mujoco_warp_tpu_torch.ops import solver as osolver
from mujoco_warp_tpu_torch.ops.util import bmask, fmask, host_item, ix

_JT = types.JointType
_DT = types.DynType
_GT = types.GainType
_BT = types.BiasType
_IT = types.IntegratorType
_INTEGRATORS = (_IT.EULER, _IT.RK4, _IT.IMPLICIT, _IT.IMPLICITFAST)
_TT = types.TrnType
# the transmissions ``smooth.transmission`` ports
_TRANSMISSIONS = (_TT.JOINT, _TT.TENDON, _TT.SITE, _TT.SLIDERCRANK, _TT.BODY)
_MINVAL = 1e-15
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
                  (m.nhistory, 'history')):
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
    if not np.all(np.isin(m.actuator_trntype, _TRANSMISSIONS)):
      return 'actuator transmission (joint in parent)'
    if np.any(m.actuator_dyntype == _DT.USER) or \
        np.any(m.actuator_gaintype == _GT.USER) or \
        np.any(m.actuator_biastype == _BT.USER):
      return 'user actuator dynamics, gain or bias'
  if np.any(m.jnt_actgravcomp):
    return 'actuator gravcomp (its force is passive.gravcomp\'s)'
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


def _act_last(m: types.Model):
  """(has_act, act_last): which actuators carry activation, and each
  one's last act slot (0 where it has none) (``forward.py:355-357``)."""
  has_act = np.asarray(m.actuator_actadr) >= 0
  act_last = np.where(has_act, np.asarray(m.actuator_actadr) +
                      np.asarray(m.actuator_actnum) - 1, 0)
  return has_act, act_last


def _clamp_rows(x, rng, where):
  """x (W, n) held to rng (1 or W, n, 2) where the (n,) host mask is
  set."""
  lim = bmask(where, x.device)
  return torch.where(lim, torch.minimum(torch.maximum(x, rng[..., 0]),
                                        rng[..., 1]), x)


def fwd_actuation(m: types.Model, d: types.Data) -> types.Data:
  """Actuator dynamics and forces (``forward.py:333``): act_dot of each
  dyntype (INTEGRATOR, FILTER, FILTEREXACT, MUSCLE; the DC motor's slots
  in ``_dcmotor_force``), the input (act, or ctrl clamped to its range;
  with actearly the next step's act, held to its actrange), FIXED, AFFINE
  and MUSCLE gains and biases, the force range, the DC motors, the
  tendons' actuator-force ranges, and qfrc_actuator held to each limited
  joint's actfrcrange.  Every physical parameter per world where it is
  batched (``types.world_field``)."""
  W = d.qpos.shape[0]
  zero_v = torch.zeros_like(d.qvel)
  if not m.nu or (m.opt.disableflags & types.DisableBit.ACTUATION):
    return d.replace(act_dot=d.qvel.new_zeros((W, m.na)),
                     actuator_force=d.qvel.new_zeros((W, m.nu)),
                     qfrc_actuator=zero_v)
  wf = lambda name: types.world_field(m, name)
  dev = d.qvel.device
  ctrl = d.ctrl
  if not (m.opt.disableflags & types.DisableBit.CLAMPCTRL):
    ctrl = _clamp_rows(ctrl, wf('actuator_ctrlrange'),
                       m.actuator_ctrllimited)
  has_act, act_last = _act_last(m)
  dyn = m.actuator_dyntype
  act_dot = d.qvel.new_zeros((W, m.na))
  input_u = ctrl
  if m.na:
    dynprm = wf('actuator_dynprm')
    act_u = d.act[:, ix(act_last, dev)]
    ad = torch.zeros_like(ctrl)
    ad = torch.where(bmask(dyn == _DT.INTEGRATOR, dev), ctrl, ad)
    filt = (dyn == _DT.FILTER) | (dyn == _DT.FILTEREXACT)
    if np.any(filt):
      ad = torch.where(bmask(filt, dev), (ctrl - act_u) / torch.clamp(
          dynprm[..., 0], min=_MINVAL), ad)
    if np.any(dyn == _DT.MUSCLE):
      ad = torch.where(bmask(dyn == _DT.MUSCLE, dev),
                       actuation.muscle_dynamics(ctrl, act_u, dynprm), ad)
    u_act = np.nonzero(has_act)[0]
    act_dot[:, ix(act_last[u_act], dev)] = ad[:, ix(u_act, dev)]
    input_u = torch.where(bmask(has_act, dev), act_u, ctrl)
    if np.any(m.actuator_actearly):
      # the next step's activation, Euler (``forward.py:370-381``)
      early = act_u + ad * m.opt.timestep
      if np.any(m.actuator_actlimited):
        early = _clamp_rows(early, wf('actuator_actrange'),
                            m.actuator_actlimited)
      input_u = torch.where(bmask(m.actuator_actearly, dev), early, input_u)
  length, velocity = d.actuator_length, d.actuator_velocity
  gt, gp = m.actuator_gaintype, wf('actuator_gainprm')
  gain = torch.zeros_like(ctrl)
  gain = torch.where(bmask(gt == _GT.FIXED, dev), gp[..., 0], gain)
  if np.any(gt == _GT.AFFINE):
    gain = torch.where(bmask(gt == _GT.AFFINE, dev),
                       gp[..., 0] + gp[..., 1] * length +
                       gp[..., 2] * velocity, gain)
  if np.any(gt == _GT.MUSCLE):
    gain = torch.where(bmask(gt == _GT.MUSCLE, dev), actuation.muscle_gain(
        length, velocity, wf('actuator_lengthrange'), wf('actuator_acc0'),
        gp), gain)
  bias = torch.zeros_like(ctrl)
  bt, bp = m.actuator_biastype, wf('actuator_biasprm')
  if np.any(bt == _BT.AFFINE):
    bias = torch.where(bmask(bt == _BT.AFFINE, dev),
                       bp[..., 0] + bp[..., 1] * length +
                       bp[..., 2] * velocity, bias)
  if np.any(bt == _BT.MUSCLE):
    bias = torch.where(bmask(bt == _BT.MUSCLE, dev), actuation.muscle_bias(
        length, wf('actuator_lengthrange'), wf('actuator_acc0'), bp), bias)
  force = gain * input_u + bias
  if np.any(m.actuator_forcelimited):
    force = _clamp_rows(force, wf('actuator_forcerange'),
                        m.actuator_forcelimited)
  dc = np.nonzero(dyn == _DT.DCMOTOR)[0]
  if len(dc):
    # each motor patched on its own, its slot layout read on the host
    # (``forward.py:415-424``)
    force = force.clone()
    for u in dc:
      f_u, act_dot = _dcmotor_force(m, d, int(u), ctrl[:, u], act_dot,
                                    length[:, u], velocity[:, u])
      force[:, u] = f_u
  if m.ntendon and np.any(m.tendon_actfrclimited):
    force = _tendon_force_clamp(m, force)
  qfrc = torch.einsum('wuv,wu->wv', d.actuator_moment, force)
  if np.any(m.jnt_actfrclimited):
    # each limited joint's dofs held to its actfrcrange (:455-458)
    jid = np.asarray(m.dof_jntid)
    qfrc = _clamp_rows(qfrc, wf('jnt_actfrcrange')[:, ix(jid, dev)],
                       np.asarray(m.jnt_actfrclimited, bool)[jid])
  return d.replace(act_dot=act_dot, actuator_force=force,
                   qfrc_actuator=qfrc)


def _dc_slots(m: types.Model, u: int) -> dict:
  """A DC motor's act slots, by name, as offsets from its actadr (-1
  where absent), and their count: slew, integral, temperature, bristle
  and current, in that order, each present where its parameter is set
  (``forward.py:213-228``); read from the host tables."""
  dynp = types.host(m.actuator_dynprm)[u]
  gp = types.host(m.actuator_gainprm)[u]
  slots, n = {}, 0
  for name, on in (('slew', dynp[7] > 0), ('int', gp[5] > 0),
                   ('temp', dynp[2] > 0), ('brist', dynp[5] > 0),
                   ('cur', dynp[0] > 0)):
    slots[name] = n if on else -1
    n += int(on)
  return slots, n


def _lugre_stribeck(vel, F_C, F_S, v_S):
  """The Stribeck curve of the LuGre friction (``forward.py:172``)."""
  ratio = vel / torch.clamp(v_S, min=_MINVAL)
  return F_C + (F_S - F_C) * torch.exp(-ratio * ratio)


def _bristle_step(z, vel, dynp, bp, h):
  """The bristle state after h, exact for its linear ODE at fixed
  velocity (``forward.py:134-140``)."""
  g = _lugre_stribeck(vel, bp[:, 3], bp[:, 4], bp[:, 5])
  a = -dynp[:, 5] * torch.abs(vel) / torch.clamp(g, min=_MINVAL)
  exp_ah = torch.exp(a * h)
  int_h = torch.where(torch.abs(a) > _MINVAL,
                      (exp_ah - 1.0) / torch.where(torch.abs(a) > _MINVAL,
                                                   a, 1.0), h)
  return exp_ah * z + int_h * vel


def _dc_slot_next(name, a0, adot, dt, dynp, dynp_h, bp, vel):
  """One DC motor's act slot ``name`` advanced by dt at rate adot
  (``forward.py:128-150``): current exact, bristle exact at fixed
  velocity ``vel``, integral Euler held to its anti-windup bound, slew
  and temperature Euler."""
  if name == 'cur':
    te = torch.clamp(dynp[:, 0], min=_MINVAL)
    return a0 + adot * te * (1.0 - torch.exp(-dt / te))
  if name == 'brist':
    return _bristle_step(a0, vel, dynp, bp, dt)
  val = a0 + adot * dt
  if name == 'int' and dynp_h[8] > 0:
    val = torch.minimum(torch.maximum(val, -dynp[:, 8]), dynp[:, 8])
  return val


def _dcmotor_voltage(u_ctrl, length, velocity, x_I, gp, gp_h):
  """The motor's input voltage: direct, or a PID on position or velocity
  (``forward.py:177``), clamped where gainprm[7] sets a limit."""
  mode = int(gp_h[8])
  if mode == 1:  # position
    v = gp[:, 4] * (u_ctrl - length) + gp[:, 5] * x_I - gp[:, 6] * velocity
  elif mode > 1:  # velocity
    v = gp[:, 4] * (u_ctrl - velocity) + gp[:, 5] * (x_I - length)
  else:
    v = u_ctrl
  if gp_h[7] > 0.0:
    v = torch.minimum(torch.maximum(v, -gp[:, 7]), gp[:, 7])
  return v


def _dcmotor_force(m: types.Model, d: types.Data, u: int, u_ctrl, act_dot,
                   length, velocity):
  """One DC motor's force (W,) and act_dot with its slots' rates
  (``forward.py:194``): slew limit, integral with anti-windup, winding
  temperature, LuGre bristle and current states; gain and input
  (actearly: the last slot advanced one step); back-EMF, cogging and
  LuGre friction."""
  dynp_h = types.host(m.actuator_dynprm)[u]
  gp_h = types.host(m.actuator_gainprm)[u]
  dynp = types.world_field(m, 'actuator_dynprm')[:, u]  # (1 or W, 10)
  gp = types.world_field(m, 'actuator_gainprm')[:, u]
  bp = types.world_field(m, 'actuator_biasprm')[:, u]
  sl, n = _dc_slots(m, u)
  adr0 = int(m.actuator_actadr[u])
  lasta = adr0 + n - 1
  h = m.opt.timestep
  R, K = gp[:, 0], gp[:, 1]
  mode = int(gp_h[8])
  act = d.act
  act_dot = act_dot.clone()
  if sl['slew'] >= 0:
    u_prev = act[:, adr0 + sl['slew']]
    slew = dynp[:, 7] * h
    u_eff = torch.minimum(torch.maximum(u_ctrl, u_prev - slew),
                          u_prev + slew)
    act_dot[:, adr0 + sl['slew']] = (u_eff - u_prev) / h
    u_ctrl = u_eff
  x_I = torch.zeros_like(u_ctrl)
  if sl['int'] >= 0:
    x_I = act[:, adr0 + sl['int']]
    adot = u_ctrl - length if mode == 1 else u_ctrl
    if dynp_h[8] > 0:
      adot = torch.where(x_I >= dynp[:, 8], torch.clamp(adot, max=0.0), adot)
      adot = torch.where(x_I <= -dynp[:, 8], torch.clamp(adot, min=0.0),
                         adot)
    act_dot[:, adr0 + sl['int']] = adot
  V = _dcmotor_voltage(u_ctrl, length, velocity, x_I, gp, gp_h)
  if sl['temp'] >= 0:
    T = act[:, adr0 + sl['temp']]
    R_eff = R * (1.0 + gp[:, 2] * (T + dynp[:, 4] - gp[:, 3]))
    cur = act[:, lasta] if sl['cur'] >= 0 else (V - K * velocity) / R_eff
    act_dot[:, adr0 + sl['temp']] = (R_eff * cur * cur - T / dynp[:, 2]) / \
        dynp[:, 3]
    R = R_eff
  z_dot = None
  if sl['brist'] >= 0:
    z = act[:, adr0 + sl['brist']]
    g = _lugre_stribeck(velocity, bp[:, 3], bp[:, 4], bp[:, 5])
    a = -dynp[:, 5] * torch.abs(velocity) / torch.clamp(g, min=_MINVAL)
    z_dot = a * z + velocity
    act_dot[:, adr0 + sl['brist']] = z_dot
  if sl['cur'] >= 0:
    te = torch.clamp(dynp[:, 0], min=_MINVAL)
    adot = (V / R - (K / R) * velocity - act[:, lasta]) / te
    if dynp_h[1] > 0:
      adot = torch.minimum(torch.maximum(adot, -dynp[:, 1]), dynp[:, 1])
    act_dot[:, lasta] = adot
  te_pos = dynp_h[0] > 0.0
  if te_pos:
    gain = K
    last = next(k for k, j in sl.items() if j == n - 1)
    ctrl_act = _dc_slot_next(last, act[:, lasta], act_dot[:, lasta], h,
                             dynp, dynp_h, bp, velocity)
    if m.actuator_actlimited[u]:
      rng = types.world_field(m, 'actuator_actrange')[:, u]
      ctrl_act = torch.minimum(torch.maximum(ctrl_act, rng[:, 0]),
                               rng[:, 1])
  else:
    gain = K / torch.clamp(R, min=_MINVAL)
    ctrl_act = _dcmotor_voltage(u_ctrl, length, velocity, x_I, gp, gp_h) \
        if mode > 0 else u_ctrl
  dc_bias = int(m.actuator_biastype[u]) == _BT.DCMOTOR
  f = gain * ctrl_act
  if dc_bias and not te_pos:
    f = f - gain * K * velocity  # back-EMF
  if m.actuator_forcelimited[u]:
    rng = types.world_field(m, 'actuator_forcerange')[:, u]
    f = torch.minimum(torch.maximum(f, rng[:, 0]), rng[:, 1])
  if dc_bias:
    if types.host(m.actuator_biasprm)[u, 0] != 0.0:  # cogging torque
      f = f + bp[:, 0] * torch.sin(bp[:, 1] * length + bp[:, 2])
    if sl['brist'] >= 0:  # LuGre friction
      f = f - dynp[:, 5] * act[:, adr0 + sl['brist']] - dynp[:, 6] * z_dot
  return f, act_dot


def _next_act(m: types.Model, act, act_dot, dt, scale: float, limit: bool,
              velocity=None):
  """act advanced by dt (``forward.py:97``): FILTEREXACT slots by the
  exact exponential, the others by Euler, ``act_dot`` scaled by
  ``scale`` (RK4's stage fractions); with ``limit`` held to actrange.  A
  DC motor's slots: current exact, bristle exact at fixed ``velocity``
  (W, nu), integral Euler held to its anti-windup bound, slew and
  temperature Euler, none held to actrange."""
  if not m.na:
    return act
  dev = act.device
  slot_u = np.full(m.na, -1, np.int64)
  for u in range(m.nu):
    adr, num = int(m.actuator_actadr[u]), int(m.actuator_actnum[u])
    if adr >= 0:
      slot_u[adr:adr + num] = u
  valid = slot_u >= 0
  uc = np.maximum(slot_u, 0)
  dynprm = types.world_field(m, 'actuator_dynprm')[:, ix(uc, dev)]
  tau = torch.clamp(dynprm[..., 0], min=_MINVAL)
  exact = bmask(m.actuator_dyntype[uc] == _DT.FILTEREXACT, dev)
  new = act + torch.where(exact,
                          act_dot * scale * tau * (1.0 - torch.exp(-dt / tau)),
                          act_dot * scale * dt)
  if limit and np.any(m.actuator_actlimited):
    new = _clamp_rows(new, types.world_field(m, 'actuator_actrange')[
        :, ix(uc, dev)], np.asarray(m.actuator_actlimited, bool)[uc] & valid)
  dc = np.nonzero(m.actuator_dyntype == _DT.DCMOTOR)[0]
  if len(dc):
    new = new.clone()
  for u in dc:
    u = int(u)
    dynp_h = types.host(m.actuator_dynprm)[u]
    dynp = types.world_field(m, 'actuator_dynprm')[:, u]
    bp = types.world_field(m, 'actuator_biasprm')[:, u]
    adr0 = int(m.actuator_actadr[u])
    vel = velocity[:, u] if velocity is not None else \
        torch.zeros_like(act[:, adr0])
    for name, j in _dc_slots(m, u)[0].items():
      if j >= 0:
        new[:, adr0 + j] = _dc_slot_next(name, act[:, adr0 + j],
                                         act_dot[:, adr0 + j] * scale, dt,
                                         dynp, dynp_h, bp, vel)
  return new


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
  """Integrate by one timestep (``forward.py:523``): act by
  ``_next_act`` with its limits, qvel += dt qacc, and qpos integrates
  with the new qvel, or with ``qvel`` where given (RK4's weighted
  velocity)."""
  dt = m.opt.timestep
  act = _next_act(m, d.act, d.act_dot, dt, 1.0, True,
                  velocity=d.actuator_velocity)
  qvel_new = d.qvel + dt * qacc
  qpos = _next_position(m, d.qpos, qvel_new if qvel is None else qvel, dt)
  return d.replace(act=act, qvel=qvel_new, qpos=qpos, time=d.time + dt,
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
  three more forwards at the stage states (act of each stage by
  ``_next_act`` at the stage's fraction, without limits), then the t0
  state advanced by the weighted accelerations, qpos by the weighted
  velocities, act by the weighted act_dot.  Each stage's solve
  warmstarts from the qacc_warmstart the stage before left (the t0
  solve's for the first); the final qacc is the last stage's.  All else
  of d (sensordata, energy, solver_niter, overflow, the actuator forces)
  stays the t0 forward's."""
  dt = m.opt.timestep
  qvel_rk = _RK4_B[0] * d.qvel
  qacc_rk = _RK4_B[0] * d.qacc
  act_dot_rk = _RK4_B[0] * d.act_dot if m.na else d.act_dot
  dd = d
  for a, b in zip(_RK4_A, _RK4_B[1:]):
    with stage('integrate'):
      dd = dd.replace(qpos=_next_position(m, d.qpos, dd.qvel, a * dt),
                      qvel=d.qvel + (a * dt) * dd.qacc,
                      act=_next_act(m, d.act, dd.act_dot, dt, a, False,
                                    velocity=dd.actuator_velocity))
    dd = _forward(m, dd)
    with stage('integrate'):
      qvel_rk = qvel_rk + b * dd.qvel
      qacc_rk = qacc_rk + b * dd.qacc
      if m.na:
        act_dot_rk = act_dot_rk + b * dd.act_dot
  with stage('integrate'):
    return _advance(m, d.replace(qacc=dd.qacc, act_dot=act_dot_rk),
                    qacc_rk, qvel=qvel_rk)


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
