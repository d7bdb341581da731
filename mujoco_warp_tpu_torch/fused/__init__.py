"""The fused lanes-last step: K1 -> glue -> K4.

Counterpart of the host side of ``mujoco_warp_tpu/pallas/fused.py``:
``supported_features`` (:236), ``FusedState`` (:1565), ``to_lane``,
``from_lane``, ``sort_worlds`` (:1611), ``step_lane`` (:1630) and
``step`` (:1680).  K1 and K4 go through ``kernels.k1`` and ``kernels.k4``:
the hand-written CUDA kernels for CUDA tensors, their plain versions for
CPU tensors.  The glue stays torch ops.  The step evaluates no sensor:
``step`` leaves ``sensordata`` as it found it, as the JAX ``step`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.fused import glue
from mujoco_warp_tpu_torch.fused import k4_ref

_JT = types.JointType
_GT = types.GeomType

# scale gate of the whole-step kernels (fused.py:249); the CUDA kernels
# size their per-world loops and local arrays by the same caps
MAX_NV, MAX_NBODY, MAX_NCAND = 64, 32, 512

_COLLIDERS = {
    (_GT.PLANE, _GT.SPHERE), (_GT.PLANE, _GT.CAPSULE), (_GT.PLANE, _GT.BOX),
    (_GT.SPHERE, _GT.SPHERE), (_GT.SPHERE, _GT.CAPSULE),
    (_GT.SPHERE, _GT.BOX), (_GT.CAPSULE, _GT.CAPSULE), (_GT.CAPSULE, _GT.BOX),
}


# the sensor types the JAX gate admits (fused.py:69-77).  The fused step
# evaluates none of them and writes no sensordata, as the JAX rollout
# (step_lane :1630, step :1680); the general step computes them
_ST = types.SensorType
SENSOR_TYPES = frozenset(int(t) for t in (
    _ST.TOUCH, _ST.ACCELEROMETER, _ST.VELOCIMETER, _ST.GYRO, _ST.FORCE,
    _ST.TORQUE, _ST.MAGNETOMETER, _ST.JOINTPOS, _ST.JOINTVEL, _ST.FRAMEPOS,
    _ST.FRAMEQUAT, _ST.FRAMEXAXIS, _ST.FRAMEYAXIS, _ST.FRAMEZAXIS,
    _ST.FRAMELINVEL, _ST.FRAMEANGVEL, _ST.FRAMELINACC, _ST.FRAMEANGACC,
    _ST.SUBTREECOM, _ST.SUBTREELINVEL, _ST.SUBTREEANGMOM, _ST.CLOCK))


def _sensors_ok(m: types.Model) -> bool:
  """The JAX gate's sensor test (``fused.py:80``): every type in
  ``SENSOR_TYPES`` and no camera operand."""
  if not m.nsensor:
    return True
  if not set(int(t) for t in m.sensor_type) <= SENSOR_TYPES:
    return False
  ot = np.concatenate([m.sensor_objtype, m.sensor_reftype])
  return not np.any(ot == int(types.ObjType.CAMERA))


def reason(m: types.Model):
  """Why a model is outside the fused gate, or None."""
  o = m.opt
  if types.dtype_of(m) != torch.float32:
    return 'float64 (K1 and K4 take float32; the float64 path is the ' \
        'general step on the CPU)'
  if o.enableflags & types.EnableBit.SLEEP:
    return 'sleep'
  if m.nflex:
    return 'flex'
  if m.nv > MAX_NV or m.ncand > MAX_NCAND or m.nbody > MAX_NBODY:
    return f'size (nv {m.nv}, ncand {m.ncand}, nbody {m.nbody})'
  if o.integrator not in (types.IntegratorType.EULER,
                          types.IntegratorType.IMPLICITFAST):
    return 'integrator'
  if o.solver != types.SolverType.NEWTON:
    return 'solver'
  if o.cone != types.ConeType.PYRAMIDAL:
    return 'cone'
  D = types.DisableBit
  if o.disableflags & (D.CONSTRAINT | D.CONTACT | D.LIMIT | D.ACTUATION |
                       D.SPRING | D.DAMPER | D.GRAVITY | D.WARMSTART |
                       D.CLAMPCTRL):
    return 'disableflags'
  if m.ntendon or m.na or m.nhistory or m.nmocap:
    return 'tendon/activation/history/mocap'
  if m.neq:
    lay = m.efc
    if len(lay.connect_id) or len(lay.weld_id) or len(lay.tendon_id) or \
        len(lay.flex_id):
      return 'equality type'
    for eqid in lay.joint_id:
      for j in (int(m.eq_obj1id[eqid]), int(m.eq_obj2id[eqid])):
        if j >= 0 and int(m.jnt_type[j]) not in (_JT.HINGE, _JT.SLIDE):
          return 'joint equality on a multi-dof joint'
  if not _sensors_ok(m):
    return 'sensor type or camera operand'
  if m.nf:
    return 'friction loss'
  if not set(int(t) for t in m.jnt_type) <= {int(_JT.FREE), int(_JT.HINGE),
                                             int(_JT.SLIDE)}:
    return 'ball joints'
  if len(m.efc.lim_ten_id):
    return 'tendon limits'
  if m.nu:
    if not (np.all(m.actuator_trntype == types.TrnType.JOINT) and
            np.all(m.actuator_gaintype == types.GainType.FIXED) and
            np.all(m.actuator_biastype == types.BiasType.NONE) and
            np.all(m.actuator_dyntype == types.DynType.NONE)):
      return 'actuator type'
    if np.any(m.jnt_actgravcomp) or np.any(m.jnt_actfrclimited):
      return 'actuator gravcomp/force limits'
    for u in range(m.nu):
      if int(m.jnt_type[int(m.actuator_trnid[u, 0])]) not in (_JT.HINGE,
                                                              _JT.SLIDE):
        return 'actuator on a multi-dof joint'
  stiff = types.host(m.jnt_stiffness)
  for j in np.nonzero(stiff > 0)[0]:
    if int(m.jnt_type[j]) not in (_JT.HINGE, _JT.SLIDE):
      return 'spring on a multi-dof joint'
  if float(types.host(m.opt.density)) != 0.0 or \
      float(types.host(m.opt.viscosity)) != 0.0:
    return 'fluid forces'
  if np.any(types.host(m.body_gravcomp) != 0):
    return 'gravcomp'
  if m.opt.run_collision_detection:
    for (t1, t2, _, _) in m.pair_groups:
      if (int(t1), int(t2)) not in _COLLIDERS:
        return 'collider'
    if m.ncand and not set(int(x) for x in m.con_dim) <= {1, 3, 4, 6}:
      return 'condim'
  # K1 holds a world's frames, contacts and mass chain, K4 its rows, M
  # and factor, in one block's shared memory
  from mujoco_warp_tpu_torch.kernels import k1 as kk1
  from mujoco_warp_tpu_torch.kernels import k4 as kk4
  if not kk1.fits(m):
    return (f'size (K1 world: nv {m.nv}, nbody {m.nbody}, ngeom {m.ngeom}, '
            f'ncand {m.ncand}, {kk1.world_bytes(m)} shared bytes, more than '
            f'a block holds)')
  if not kk4.fits(m):
    return (f'size (K4 world: nrow {kk4.nrow(m)}, nv {m.nv}, '
            f'{kk4.world_bytes(m)} shared bytes, more than a block holds)')
  return None


def supported(m: types.Model) -> bool:
  """Is ``m`` inside the fused gate?  (``fused.py:236``; the benchmark
  sends every other model to the general step.)"""
  return reason(m) is None


def supported_features(m: types.Model) -> bool:
  """True for a model inside the fused gate; raises otherwise."""
  why = reason(m)
  if why is not None:
    raise NotImplementedError(f'model outside the fused gate ({why})')
  return True


@dataclasses.dataclass
class FusedState:
  """Lanes-last rollout state: every tensor is (rows, nworld)."""

  qpos: torch.Tensor  # (nq, W)
  qvel: torch.Tensor  # (nv, W)
  ctrl: torch.Tensor  # (nu, W)
  warmstart: torch.Tensor  # (nv, W)
  qacc: torch.Tensor  # (nv, W)
  time: torch.Tensor  # (1, W)
  solver_niter: torch.Tensor  # (1, W) int32
  overflow: torch.Tensor  # (1, W) int32
  world_id: torch.Tensor  # (1, W) int32

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)

  def map(self, fn):
    return FusedState(**{f.name: fn(getattr(self, f.name))
                         for f in dataclasses.fields(self)})


def to_lane(m: types.Model, d) -> FusedState:
  W = d.qpos.shape[0]
  dev = d.qpos.device
  t = lambda x: x.T.contiguous()
  return FusedState(
      qpos=t(d.qpos), qvel=t(d.qvel), ctrl=t(d.ctrl), warmstart=t(d.qacc_warmstart),
      qacc=t(d.qacc), time=d.time.reshape(1, W).clone(),
      solver_niter=torch.zeros((1, W), dtype=torch.int32, device=dev),
      overflow=d.overflow.reshape(1, W).to(torch.int32),
      world_id=torch.arange(W, dtype=torch.int32, device=dev).reshape(1, W))


def from_lane(m: types.Model, st: FusedState, d):
  """Back to world-major Data, in the caller's world order."""
  inv = torch.argsort(st.world_id[0], stable=True)
  g = lambda x: x.T[inv].contiguous()
  return d.replace(qpos=g(st.qpos), qvel=g(st.qvel), ctrl=g(st.ctrl),
                   qacc_warmstart=g(st.warmstart), qacc=g(st.qacc),
                   time=st.time[0, inv], solver_niter=st.solver_niter[0, inv],
                   overflow=st.overflow[0, inv])


def sort_perm(st: FusedState):
  """Stable permutation of worlds by the last step's solver_niter."""
  return torch.argsort(st.solver_niter[0], stable=True)


def sort_worlds(st: FusedState) -> FusedState:
  """Permute worlds by solver_niter so worlds of equal cost sit together;
  ``world_id`` carries identity and ``from_lane`` undoes the order."""
  perm = sort_perm(st)
  return st.map(lambda x: x[:, perm])


def step_lane(m: types.Model, st: FusedState) -> FusedState:
  """One physics step on lane-form state."""
  from mujoco_warp_tpu_torch.kernels import k1 as kk1
  from mujoco_warp_tpu_torch.kernels import k4 as kk4

  need_qLD = not k4_ref.has_rows(m)
  qM, qLD, bias, cdof, c_dist, c_pos, c_frame, stcom = kk1.k1(
      m, st.qpos, st.qvel, need_qLD=need_qLD)
  W = st.qpos.shape[-1]
  if m.ncand and m.opt.run_collision_detection:
    make_con = glue.compact if m.con_compact else glue.identity_con
    con, overflow = make_con(m, c_dist, c_pos, c_frame, stcom)
  else:
    con = None
    overflow = torch.zeros((1, W), dtype=torch.int32, device=st.qpos.device)
  qfs = glue.middle(m, bias, st.qpos, st.qvel, st.ctrl)
  qpos_n, qvel_n, warm, qacc_i, niter = kk4.k4(
      m, qM, qLD, qfs, st.warmstart, st.qvel, st.qpos, cdof, con)
  h = float(types.host(m.opt.timestep, np.float32))
  # the SOLVER bit: the Newton cap fired before the tolerance predicate
  overflow = overflow | torch.where(
      niter >= int(m.opt.iterations), int(types.OverflowType.SOLVER),
      0).to(torch.int32)
  return st.replace(qpos=qpos_n, qvel=qvel_n, warmstart=warm, qacc=qacc_i,
                    time=st.time + h, solver_niter=niter,
                    overflow=st.overflow | overflow)


def step(m: types.Model, d):
  """Data-in/Data-out fused step (physics state fields only)."""
  return from_lane(m, step_lane(m, to_lane(m, d)), d)
