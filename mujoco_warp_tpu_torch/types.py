"""Enums, the Model subset and the world-major Data, as PyTorch types.

Counterpart of ``mujoco_warp_tpu/types.py``.  Enum values are copied from
it (they mirror MuJoCo's public C enums).  ``Model`` holds only the fields
the ported paths read: the fused lanes-last step
(``mujoco_warp_tpu/pallas/fused.py``) and the general stage-split step
(``mujoco_warp_tpu/ops/forward.py`` ``_step_batched``).  Physical
parameters are ``torch.Tensor``s of the Model's dtype (float32, or
float64 for the CPU's float64 path; ``dtype_of``), index and type tables
are numpy arrays (host constants the plain versions fold and the CUDA wrappers
upload once per model).  ``Data`` is world-major: every field carries a
leading ``nworld`` axis, as the JAX Data does under ``vmap``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import numpy as np
import torch


class DisableBit(enum.IntFlag):
  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  SPRING = 1 << 5
  DAMPER = 1 << 6
  GRAVITY = 1 << 7
  CLAMPCTRL = 1 << 8
  WARMSTART = 1 << 9
  FILTERPARENT = 1 << 10
  ACTUATION = 1 << 11
  REFSAFE = 1 << 12
  SENSOR = 1 << 13
  MIDPHASE = 1 << 14
  EULERDAMP = 1 << 15
  AUTORESET = 1 << 16
  NATIVECCD = 1 << 17
  ISLAND = 1 << 18
  MULTICCD = 1 << 19


class EnableBit(enum.IntFlag):
  OVERRIDE = 1 << 0
  ENERGY = 1 << 1
  FWDINV = 1 << 2
  INVDISCRETE = 1 << 3
  SLEEP = 1 << 4
  DIAGEXACT = 1 << 5


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7
  SDF = 8


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4
  DCMOTOR = 5
  USER = 6


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2
  DCMOTOR = 3
  USER = 4


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2
  DCMOTOR = 3
  USER = 4


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3
  FLEX = 4
  FLEXVERT = 5
  FLEXSTRAIN = 6
  DISTANCE = 7


class WrapType(enum.IntEnum):
  NONE = 0
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class SolverType(enum.IntEnum):
  PGS = 0
  CG = 1
  NEWTON = 2


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class ConstraintType(enum.IntEnum):
  EQUALITY = 0
  FRICTION_DOF = 1
  FRICTION_TENDON = 2
  LIMIT_JOINT = 3
  LIMIT_TENDON = 4
  CONTACT_FRICTIONLESS = 5
  CONTACT_PYRAMIDAL = 6
  CONTACT_ELLIPTIC = 7


class ObjType(enum.IntEnum):
  UNKNOWN = 0
  BODY = 1
  XBODY = 2
  JOINT = 3
  GEOM = 5
  SITE = 6
  CAMERA = 7


class SensorType(enum.IntEnum):
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  CAMPROJECTION = 8
  JOINTPOS = 9
  JOINTVEL = 10
  TENDONPOS = 11
  TENDONVEL = 12
  ACTUATORPOS = 13
  ACTUATORVEL = 14
  ACTUATORFRC = 15
  JOINTACTFRC = 16
  TENDONACTFRC = 17
  BALLQUAT = 18
  BALLANGVEL = 19
  JOINTLIMITPOS = 20
  JOINTLIMITVEL = 21
  JOINTLIMITFRC = 22
  TENDONLIMITPOS = 23
  TENDONLIMITVEL = 24
  TENDONLIMITFRC = 25
  FRAMEPOS = 26
  FRAMEQUAT = 27
  FRAMEXAXIS = 28
  FRAMEYAXIS = 29
  FRAMEZAXIS = 30
  FRAMELINVEL = 31
  FRAMEANGVEL = 32
  FRAMELINACC = 33
  FRAMEANGACC = 34
  SUBTREECOM = 35
  SUBTREELINVEL = 36
  SUBTREEANGMOM = 37
  INSIDESITE = 38
  GEOMDIST = 39
  GEOMNORMAL = 40
  GEOMFROMTO = 41
  CONTACT = 42
  E_POTENTIAL = 43
  E_KINETIC = 44
  CLOCK = 45
  TACTILE = 46


class OverflowType(enum.IntFlag):
  """Per-world overflow bits: a fixed-capacity buffer saturated."""

  CONTACT = 1 << 0
  CONSTRAINT = 1 << 1
  SOLVER = 1 << 2


NREF = 2
NIMP = 5
# sleeping (``types.py:293-296``): the quiescent steps before a tree may
# sleep, and the tree_asleep value of a fully awake tree
MJ_MINAWAKE = 10
K_AWAKE = -(1 + MJ_MINAWAKE)


def _tensor(kind):
  return dataclasses.field(default=None, metadata={'kind': kind})


def array():
  """A float tensor field of the Model's dtype (a physical parameter)."""
  return _tensor('array')


def static():
  """A numpy table field (indices, types, masks)."""
  return _tensor('static')


def scalar(default=0):
  """A python int/bool field (a size or a flag)."""
  return dataclasses.field(default=default, metadata={'kind': 'scalar'})


def batch():
  """The names of the Model's batched fields (``io.batch_model``); not
  part of a snapshot."""
  return dataclasses.field(default=(), metadata={'kind': 'batch'})


def dtype_of(m) -> torch.dtype:
  """The float dtype of a Model: float32, or float64 (``io.put_model``'s
  ``dtype``)."""
  return m.qpos0.dtype


def np_float(dtype):
  """The numpy float type of a torch float dtype (a numpy type passes
  through)."""
  return {torch.float32: np.float32, torch.float64: np.float64}.get(
      dtype, dtype)


def field_kinds(cls):
  """Each field's kind: 'array', 'static', 'scalar', 'node' (a nested
  dataclass), or 'batch' (``Model.batch_fields``, kept out of snapshots)."""
  return {f.name: f.metadata.get('kind', 'node') for f in
          dataclasses.fields(cls)}


class _Replace:

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Option(_Replace):
  """Physics options (subset of ``mujoco_warp_tpu.types.Option``)."""

  timestep: torch.Tensor = array()
  impratio: torch.Tensor = array()
  tolerance: torch.Tensor = array()
  ls_tolerance: torch.Tensor = array()
  gravity: torch.Tensor = array()
  magnetic: torch.Tensor = array()
  density: torch.Tensor = array()
  viscosity: torch.Tensor = array()
  sleep_tolerance: torch.Tensor = array()  # velocity threshold of sleep
  # the contact override (EnableBit.OVERRIDE, ``types.py:317-321``)
  o_margin: torch.Tensor = array()  # ()
  o_solref: torch.Tensor = array()  # (NREF,)
  o_solimp: torch.Tensor = array()  # (NIMP,)
  o_friction: torch.Tensor = array()  # (5,)
  integrator: int = scalar(int(IntegratorType.EULER))
  cone: int = scalar(int(ConeType.PYRAMIDAL))
  solver: int = scalar(int(SolverType.NEWTON))
  iterations: int = scalar(100)
  ls_iterations: int = scalar(50)
  disableflags: int = scalar(0)
  enableflags: int = scalar(0)
  run_collision_detection: bool = scalar(True)


@dataclasses.dataclass(frozen=True)
class Statistic(_Replace):
  meaninertia: torch.Tensor = array()


@dataclasses.dataclass(frozen=True)
class TreeInfo(_Replace):
  """Static kinematic-tree tables (levels and masks)."""

  body_levels: Tuple[np.ndarray, ...] = scalar(())  # body ids per depth
  ancestor_mask: np.ndarray = static()  # (nv, nv) dof j is i or above i
  subtree_mask: np.ndarray = static()  # (nbody, nbody) j in subtree(i)
  body_dof_mask: np.ndarray = static()  # (nbody, nv) dof j moves body i
  dof_subtree_mask: np.ndarray = static()  # (nv, nbody) b in subtree(dof i)
  cdofdot_mask: np.ndarray = static()  # (nv, nv) dofs feeding cdof_dot[i]


@dataclasses.dataclass(frozen=True)
class EfcLayout(_Replace):
  """Static constraint-row layout: ids and first row of each group."""

  connect_id: np.ndarray = static()
  connect_adr: np.ndarray = static()
  weld_id: np.ndarray = static()
  weld_adr: np.ndarray = static()
  joint_id: np.ndarray = static()
  joint_adr: np.ndarray = static()
  tendon_id: np.ndarray = static()
  tendon_adr: np.ndarray = static()
  flex_id: np.ndarray = static()
  flex_adr: np.ndarray = static()
  fri_dof_id: np.ndarray = static()
  fri_dof_adr: np.ndarray = static()
  fri_ten_id: np.ndarray = static()
  fri_ten_adr: np.ndarray = static()
  lim_jnt_id: np.ndarray = static()
  lim_jnt_adr: np.ndarray = static()
  lim_ten_id: np.ndarray = static()
  lim_ten_adr: np.ndarray = static()
  efc_type: np.ndarray = static()
  efc_id: np.ndarray = static()


@dataclasses.dataclass(frozen=True)
class Model(_Replace):
  """Model fields the ported steps read (``mujoco_warp_tpu.types.Model``)."""

  nq: int = scalar()
  nv: int = scalar()
  nu: int = scalar()
  na: int = scalar()
  nbody: int = scalar()
  njnt: int = scalar()
  ngeom: int = scalar()
  nsite: int = scalar()
  ncam: int = scalar()
  nlight: int = scalar()
  nmocap: int = scalar()
  neq: int = scalar()
  ntendon: int = scalar()
  nsensor: int = scalar()
  nsensordata: int = scalar()
  nhistory: int = scalar()
  ntree: int = scalar()
  nflex: int = scalar()
  ne: int = scalar()
  nf: int = scalar()
  nl: int = scalar()
  nefc: int = scalar()
  ncon: int = scalar()
  ncand: int = scalar()
  # ((dim, cap, cand_idx, slot_start), ...) per condim class
  con_classes: Tuple[Any, ...] = scalar(())
  con_compact: bool = scalar(False)

  opt: Option = None
  stat: Statistic = None
  tree: TreeInfo = None
  efc: EfcLayout = None

  qpos0: torch.Tensor = array()
  qpos_spring: torch.Tensor = array()

  body_parentid: np.ndarray = static()
  body_rootid: np.ndarray = static()
  body_jntadr: np.ndarray = static()
  body_jntnum: np.ndarray = static()
  body_dofadr: np.ndarray = static()
  body_dofnum: np.ndarray = static()
  body_pos: torch.Tensor = array()
  body_quat: torch.Tensor = array()
  body_ipos: torch.Tensor = array()
  body_iquat: torch.Tensor = array()
  body_mass: torch.Tensor = array()
  body_subtreemass: torch.Tensor = array()
  body_inertia: torch.Tensor = array()
  body_invweight0: torch.Tensor = array()
  body_gravcomp: torch.Tensor = array()
  body_treeid: np.ndarray = static()
  tree_sleep_policy: np.ndarray = static()

  jnt_type: np.ndarray = static()
  jnt_qposadr: np.ndarray = static()
  jnt_dofadr: np.ndarray = static()
  jnt_bodyid: np.ndarray = static()
  jnt_limited: np.ndarray = static()
  jnt_actfrclimited: np.ndarray = static()
  jnt_actgravcomp: np.ndarray = static()
  jnt_solref: torch.Tensor = array()
  jnt_solimp: torch.Tensor = array()
  jnt_pos: torch.Tensor = array()
  jnt_axis: torch.Tensor = array()
  jnt_stiffness: torch.Tensor = array()
  jnt_range: torch.Tensor = array()
  jnt_margin: torch.Tensor = array()
  jnt_actfrcrange: torch.Tensor = array()  # (njnt, 2)

  dof_bodyid: np.ndarray = static()
  dof_jntid: np.ndarray = static()
  dof_treeid: np.ndarray = static()
  dof_length: torch.Tensor = array()
  dof_solref: torch.Tensor = array()
  dof_solimp: torch.Tensor = array()
  dof_frictionloss: torch.Tensor = array()
  dof_armature: torch.Tensor = array()
  dof_damping: torch.Tensor = array()
  dof_invweight0: torch.Tensor = array()

  geom_type: np.ndarray = static()
  geom_bodyid: np.ndarray = static()
  geom_size: torch.Tensor = array()
  geom_pos: torch.Tensor = array()
  geom_quat: torch.Tensor = array()
  geom_margin: torch.Tensor = array()
  # the geoms' contact parameters, which ``io.remix`` mixes into the
  # per-candidate tables (``override_model`` mixes them again)
  geom_priority: np.ndarray = static()
  geom_solmix: torch.Tensor = array()
  geom_solref: torch.Tensor = array()  # (ngeom, NREF)
  geom_solimp: torch.Tensor = array()  # (ngeom, NIMP)
  geom_friction: torch.Tensor = array()  # (ngeom, 3)
  geom_gap: torch.Tensor = array()

  site_bodyid: np.ndarray = static()
  site_type: np.ndarray = static()
  site_pos: torch.Tensor = array()
  site_quat: torch.Tensor = array()
  site_size: torch.Tensor = array()

  # cameras and lights (mjtCamLight modes: 0 fixed, 1 track, 2 trackcom,
  # 3 targetbody, 4 targetbodycom)
  cam_mode: np.ndarray = static()
  cam_bodyid: np.ndarray = static()
  cam_targetbodyid: np.ndarray = static()
  cam_resolution: np.ndarray = static()
  cam_pos: torch.Tensor = array()
  cam_quat: torch.Tensor = array()
  cam_poscom0: torch.Tensor = array()
  cam_pos0: torch.Tensor = array()
  cam_mat0: torch.Tensor = array()  # (ncam, 3, 3)
  cam_fovy: torch.Tensor = array()
  cam_intrinsic: torch.Tensor = array()
  cam_sensorsize: torch.Tensor = array()
  light_mode: np.ndarray = static()
  light_bodyid: np.ndarray = static()
  light_targetbodyid: np.ndarray = static()
  light_pos: torch.Tensor = array()
  light_dir: torch.Tensor = array()
  light_poscom0: torch.Tensor = array()
  light_pos0: torch.Tensor = array()
  light_dir0: torch.Tensor = array()

  sensor_type: np.ndarray = static()
  sensor_datatype: np.ndarray = static()
  sensor_objtype: np.ndarray = static()
  sensor_objid: np.ndarray = static()
  sensor_reftype: np.ndarray = static()
  sensor_refid: np.ndarray = static()
  sensor_dim: np.ndarray = static()
  sensor_adr: np.ndarray = static()
  sensor_cutoff: torch.Tensor = array()

  eq_type: np.ndarray = static()
  eq_objtype: np.ndarray = static()
  eq_obj1id: np.ndarray = static()
  eq_obj2id: np.ndarray = static()
  eq_active0: np.ndarray = static()
  eq_solref: torch.Tensor = array()
  eq_solimp: torch.Tensor = array()
  eq_data: torch.Tensor = array()

  # tendons (``types.py:702-723``)
  tendon_adr: np.ndarray = static()
  tendon_num: np.ndarray = static()
  tendon_limited: np.ndarray = static()
  tendon_actfrclimited: np.ndarray = static()
  tendon_solref_lim: torch.Tensor = array()  # (ntendon, NREF)
  tendon_solimp_lim: torch.Tensor = array()  # (ntendon, NIMP)
  tendon_solref_fri: torch.Tensor = array()  # (ntendon, NREF)
  tendon_solimp_fri: torch.Tensor = array()  # (ntendon, NIMP)
  tendon_range: torch.Tensor = array()  # (ntendon, 2)
  tendon_actfrcrange: torch.Tensor = array()  # (ntendon, 2)
  tendon_margin: torch.Tensor = array()
  tendon_stiffness: torch.Tensor = array()
  tendon_damping: torch.Tensor = array()
  tendon_armature: torch.Tensor = array()
  tendon_frictionloss: torch.Tensor = array()
  tendon_lengthspring: torch.Tensor = array()  # (ntendon, 2)
  tendon_length0: torch.Tensor = array()
  tendon_invweight0: torch.Tensor = array()
  wrap_type: np.ndarray = static()
  wrap_objid: np.ndarray = static()
  wrap_prm: torch.Tensor = array()

  actuator_trntype: np.ndarray = static()
  actuator_dyntype: np.ndarray = static()
  actuator_gaintype: np.ndarray = static()
  actuator_biastype: np.ndarray = static()
  actuator_trnid: np.ndarray = static()
  actuator_actadr: np.ndarray = static()  # (nu,) first act slot, or -1
  actuator_actnum: np.ndarray = static()  # (nu,) act slots
  actuator_ctrllimited: np.ndarray = static()
  actuator_forcelimited: np.ndarray = static()
  actuator_actlimited: np.ndarray = static()
  actuator_actearly: np.ndarray = static()
  actuator_dynprm: torch.Tensor = array()  # (nu, 10)
  actuator_gainprm: torch.Tensor = array()
  actuator_biasprm: torch.Tensor = array()
  actuator_ctrlrange: torch.Tensor = array()
  actuator_forcerange: torch.Tensor = array()
  actuator_actrange: torch.Tensor = array()  # (nu, 2)
  actuator_gear: torch.Tensor = array()
  actuator_cranklength: torch.Tensor = array()  # (nu,)
  actuator_acc0: torch.Tensor = array()  # (nu,) ||M^-1 moment|| at qpos0
  actuator_lengthrange: torch.Tensor = array()  # (nu, 2)

  # collision tables: candidate pairs, slots and per-slot mixed params
  pair_geom1: np.ndarray = static()
  pair_geom2: np.ndarray = static()
  con_pair: np.ndarray = static()  # (ncand,) slot -> pair index
  con_dim: np.ndarray = static()  # (ncon,) condim per contact slot
  con_efc_address: np.ndarray = static()  # (ncon,) first efc row per slot
  # ((geomtype1, geomtype2, pair_index_array, slot_start), ...)
  pair_groups: Tuple[Any, ...] = scalar(())
  cand_friction: torch.Tensor = array()
  cand_solref: torch.Tensor = array()
  cand_solimp: torch.Tensor = array()
  cand_includemargin: torch.Tensor = array()
  cand_margin: torch.Tensor = array()  # (ncand,) margin, gap included

  # the fields ``io.batch_model`` gave a leading world axis, sorted
  # (``opt.``-dotted for Option fields); read them through ``world_field``
  batch_fields: Tuple[str, ...] = batch()


@dataclasses.dataclass
class Contact:
  """World-major contact slots (``mujoco_warp_tpu.types.Contact`` under
  ``vmap``): one slot per candidate contact point, in the static slot
  order of ``Model.con_pair``.  A slot is live iff dist < includemargin."""

  dist: torch.Tensor = None  # (W, ncon)
  pos: torch.Tensor = None  # (W, ncon, 3)
  frame: torch.Tensor = None  # (W, ncon, 3, 3) rows: normal, t1, t2
  includemargin: torch.Tensor = None  # (W, ncon)
  friction: torch.Tensor = None  # (W, ncon, 5)
  solref: torch.Tensor = None  # (W, ncon, NREF)
  solreffriction: torch.Tensor = None  # (W, ncon, NREF)
  solimp: torch.Tensor = None  # (W, ncon, NIMP)
  geom1: torch.Tensor = None  # (W, ncon) int32
  geom2: torch.Tensor = None  # (W, ncon) int32
  cand: torch.Tensor = None  # (W, ncon) int32 candidate slot id

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Data:
  """World-major state and intermediates (``mujoco_warp_tpu.types.Data``
  fields under ``vmap``): every tensor has a leading ``nworld`` axis.
  Fields a path does not compute stay None."""

  time: torch.Tensor = None  # (W,)
  qpos: torch.Tensor = None  # (W, nq)
  qvel: torch.Tensor = None  # (W, nv)
  act: torch.Tensor = None  # (W, na)
  ctrl: torch.Tensor = None  # (W, nu)
  qfrc_applied: torch.Tensor = None  # (W, nv)
  xfrc_applied: torch.Tensor = None  # (W, nbody, 6)
  eq_active: torch.Tensor = None  # (W, neq) bool
  # position stages
  xpos: torch.Tensor = None  # (W, nbody, 3)
  xquat: torch.Tensor = None  # (W, nbody, 4)
  xmat: torch.Tensor = None  # (W, nbody, 3, 3)
  xipos: torch.Tensor = None  # (W, nbody, 3)
  ximat: torch.Tensor = None  # (W, nbody, 3, 3)
  xanchor: torch.Tensor = None  # (W, njnt, 3)
  xaxis: torch.Tensor = None  # (W, njnt, 3)
  geom_xpos: torch.Tensor = None  # (W, ngeom, 3)
  geom_xmat: torch.Tensor = None  # (W, ngeom, 3, 3)
  site_xpos: torch.Tensor = None  # (W, nsite, 3)
  site_xmat: torch.Tensor = None  # (W, nsite, 3, 3)
  cam_xpos: torch.Tensor = None  # (W, ncam, 3)
  cam_xmat: torch.Tensor = None  # (W, ncam, 3, 3)
  light_xpos: torch.Tensor = None  # (W, nlight, 3)
  light_xdir: torch.Tensor = None  # (W, nlight, 3)
  subtree_com: torch.Tensor = None  # (W, nbody, 3)
  cinert: torch.Tensor = None  # (W, nbody, 6, 6)
  cdof: torch.Tensor = None  # (W, nv, 6)
  qM: torch.Tensor = None  # (W, nv, nv)
  qLD: torch.Tensor = None  # (W, nv, nv) lower Cholesky factor of qM
  actuator_length: torch.Tensor = None  # (W, nu)
  actuator_moment: torch.Tensor = None  # (W, nu, nv)
  ten_length: torch.Tensor = None  # (W, ntendon)
  ten_J: torch.Tensor = None  # (W, ntendon, nv)
  # velocity stages
  ten_velocity: torch.Tensor = None  # (W, ntendon)
  cvel: torch.Tensor = None  # (W, nbody, 6)
  cdof_dot: torch.Tensor = None  # (W, nv, 6)
  actuator_velocity: torch.Tensor = None  # (W, nu)
  qfrc_bias: torch.Tensor = None  # (W, nv)
  qfrc_spring: torch.Tensor = None  # (W, nv)
  qfrc_damper: torch.Tensor = None  # (W, nv)
  qfrc_gravcomp: torch.Tensor = None  # (W, nv)
  qfrc_fluid: torch.Tensor = None  # (W, nv)
  qfrc_passive: torch.Tensor = None  # (W, nv)
  subtree_linvel: torch.Tensor = None  # (W, nbody, 3)
  subtree_angmom: torch.Tensor = None  # (W, nbody, 3)
  # forces and accelerations
  act_dot: torch.Tensor = None  # (W, na)
  actuator_force: torch.Tensor = None  # (W, nu)
  qfrc_actuator: torch.Tensor = None  # (W, nv)
  qfrc_smooth: torch.Tensor = None  # (W, nv)
  qacc_smooth: torch.Tensor = None  # (W, nv)
  qfrc_constraint: torch.Tensor = None  # (W, nv)
  qacc: torch.Tensor = None  # (W, nv)
  qacc_warmstart: torch.Tensor = None  # (W, nv)
  # inverse dynamics (``ops/inverse.py``)
  qfrc_inverse: torch.Tensor = None  # (W, nv)
  # after the solve (rne_postconstraint): com-frame body accelerations,
  # the force each body takes from its parent, external wrenches
  cacc: torch.Tensor = None  # (W, nbody, 6)
  cfrc_int: torch.Tensor = None  # (W, nbody, 6)
  cfrc_ext: torch.Tensor = None  # (W, nbody, 6)
  # constraint rows
  efc_J: torch.Tensor = None  # (W, nefc, nv)
  efc_pos: torch.Tensor = None  # (W, nefc)
  efc_margin: torch.Tensor = None  # (W, nefc)
  efc_frictionloss: torch.Tensor = None  # (W, nefc)
  efc_D: torch.Tensor = None  # (W, nefc)
  efc_aref: torch.Tensor = None  # (W, nefc)
  efc_force: torch.Tensor = None  # (W, nefc)
  efc_active: torch.Tensor = None  # (W, nefc) bool
  # collision
  contact: Contact = None
  ncon_active: torch.Tensor = None  # (W,) int32 live contact slots
  solver_niter: torch.Tensor = None  # (W,) int32
  # sleeping (``types.py:924-932``): < 0 awake, a counter from K_AWAKE up
  # to -1 (ready) while the tree stays quiescent; >= 0 asleep, the
  # smallest tree id of the group it fell asleep with (waking one member
  # wakes every tree with its label)
  tree_asleep: torch.Tensor = None  # (W, ntree) int32
  # constraint islands (``types.py:935-938``): -1 unconstrained
  nisland: torch.Tensor = None  # (W,) int32
  tree_island: torch.Tensor = None  # (W, ntree) int32
  dof_island: torch.Tensor = None  # (W, nv) int32
  efc_island: torch.Tensor = None  # (W, nefc) int32
  overflow: torch.Tensor = None  # (W,) int32 OverflowType bits
  energy: torch.Tensor = None  # (W, 2) potential, kinetic
  sensordata: torch.Tensor = None  # (W, nsensordata)

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


def _per_world(x, W: int) -> bool:
  return isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == W


# the state the general step carries from one step to the next; it
# recomputes the rest of Data every step
CARRY = ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qfrc_applied',
         'xfrc_applied', 'eq_active', 'qacc_warmstart', 'qacc',
         'solver_niter', 'overflow', 'tree_asleep', 'nisland', 'tree_island',
         'dof_island', 'efc_island')


def carried(d: Data, fn=lambda x: x) -> Data:
  """A Data of ``d``'s ``CARRY`` fields, with ``fn`` applied to each."""
  return Data(**{k: fn(getattr(d, k)) for k in CARRY
                 if getattr(d, k) is not None})


def map_worlds(d: Data, fn, W: int) -> Data:
  """``d`` with ``fn`` applied to every per-world tensor (every field,
  of ``d`` and of its ``contact``, whose leading dimension is ``W``)."""
  def one(obj):
    kw = {}
    for f in dataclasses.fields(obj):
      x = getattr(obj, f.name)
      if isinstance(x, Contact):
        kw[f.name] = one(x)
      elif _per_world(x, W):
        kw[f.name] = fn(x)
    return obj.replace(**kw)
  return one(d)


def scatter_worlds(d: Data, sub: Data, ids: torch.Tensor, W: int) -> Data:
  """``d`` with world ``ids[k]`` set to ``sub``'s world k for each k <
  len(ids) (``ids`` distinct; ``sub`` may hold more worlds), field by
  field: every per-world tensor of ``sub``.  A field ``d`` lacks starts
  at zeros."""
  n, Ws = ids.shape[0], sub.qpos.shape[0]

  def put(x, xs):
    if x is None:
      x = xs.new_zeros((W,) + tuple(xs.shape[1:]))
    return x.index_copy(0, ids, xs[:n])

  def one(obj, objs):
    kw = {}
    for f in dataclasses.fields(objs):
      xs = getattr(objs, f.name)
      x = None if obj is None else getattr(obj, f.name)
      if isinstance(xs, Contact):
        kw[f.name] = one(x, xs)
      elif _per_world(xs, Ws):
        kw[f.name] = put(x, xs)
    return (objs if obj is None else obj).replace(**kw)
  return one(d, sub)


def get_model_field(m: Model, name: str):
  """A Model field by name, ``opt.``-dotted for an Option field
  (``types.py:965``)."""
  if name.startswith('opt.'):
    return getattr(m.opt, name[4:])
  return getattr(m, name)


def set_model_fields(m: Model, updates: dict) -> Model:
  """``m`` with the fields of ``updates`` (names as ``get_model_field``
  takes them) replaced (``types.py:972``)."""
  opt = {k[4:]: v for k, v in updates.items() if k.startswith('opt.')}
  top = {k: v for k, v in updates.items() if not k.startswith('opt.')}
  if opt:
    top['opt'] = m.opt.replace(**opt)
  return m.replace(**top)


def model_nworld(m: Model):
  """The world count of a Model's batched fields, or None unbatched."""
  if not m.batch_fields:
    return None
  return get_model_field(m, m.batch_fields[0]).shape[0]


def world_field(m: Model, name: str):
  """A batchable Model field with a leading world axis: (W, ...) when
  ``name`` is in ``m.batch_fields``, else a (1, ...) view of the field
  (no copy) that broadcasts against world-major Data.  Every reader of a
  field ``io.batch_model`` takes goes through this: indexing the field on
  its element axis (``m.body_mass[ids]``) would index the world axis of a
  batched field.  A stand-in for a Model without ``batch_fields`` (a
  namespace of a few fields) reads as unbatched."""
  x = get_model_field(m, name)
  return x if name in getattr(m, 'batch_fields', ()) else x[None]


def map_model_worlds(m: Model, fn) -> Model:
  """``m`` with ``fn`` applied to every batched field (``map_worlds``'s
  sibling: the rollout's sort permutes a batched Model's worlds with its
  Data's)."""
  if not m.batch_fields:
    return m
  return set_model_fields(m, {n: fn(get_model_field(m, n))
                              for n in m.batch_fields})


# the Model's fields in order, the Option's one by one ('opt.'-dotted)
_LEAF_NAMES = []
for _f in dataclasses.fields(Model):
  if _f.name == 'opt':
    _LEAF_NAMES += ['opt.' + g.name for g in dataclasses.fields(Option)]
  else:
    _LEAF_NAMES.append(_f.name)


# model_token's tokens by the ids of the fields they stand for, the fields
# held so that their ids are not reused
_TOKENS = {}


def model_token(m: Model) -> object:
  """One object for every Model whose fields but ``batch_fields`` and
  those it names (the Option's one by one) are the same objects: what a
  table built once per Model may read is keyed on it
  (``kernels.TableCache``).  A Model whose batched fields a sort permuted
  shares its token; any other change makes a new one.  Kept on the Model,
  which is frozen, after the first call."""
  tok = m.__dict__.get('_token')
  if tok is None:
    skip = set(m.batch_fields) | {'batch_fields'}
    leaves = tuple(get_model_field(m, n) for n in _LEAF_NAMES
                   if n not in skip)
    tok = _TOKENS.setdefault(tuple(map(id, leaves)), (leaves, object()))[1]
    object.__setattr__(m, '_token', tok)
  return tok


_HOST = {}


def host(x, dtype=np.float64) -> np.ndarray:
  """A model field as a numpy array (float64 by default).  The host copy
  of a device tensor is made once: a copy on every call would wait for
  the device's stream, and the model's fields do not change."""
  if isinstance(x, torch.Tensor):
    if x.device.type == 'cpu':
      x = x.detach().numpy()
    else:
      hit = _HOST.get(id(x))
      if hit is None or hit[0] is not x:
        hit = (x, x.detach().cpu().numpy())
        _HOST[id(x)] = hit
      x = hit[1]
  return np.asarray(x, dtype)
