"""Model construction, the committed model snapshots, and Data allocation.

Counterpart of ``mujoco_warp_tpu/io.py`` for the Model subset of the
ported paths: the fused step's gate and the general step's slice
(``ops/forward.py`` ``unsupported``).  ``put_model`` needs ``mujoco`` and
imports it inside the function; everything else (``model_from_numpy``,
``load_model_npz``, ``make_data``) runs without it, so a machine without
``mujoco`` loads the committed snapshots instead::

  python -m mujoco_warp_tpu_torch.io --snapshot   # regenerate the snapshots

Every entry point puts its tensors on the CUDA device unless the caller
passes ``device='cpu'``; without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mujoco_warp_tpu_torch import types

_JT = types.JointType
_GT = types.GeomType

_ASSETS = os.path.join(os.path.dirname(__file__), 'assets')
SNAPSHOT = os.path.join(_ASSETS, 'humanoid_bench.npz')
# the general path's benchmark scene (mujoco_warp_tpu/models/constraints.xml)
CONSTRAINTS_SNAPSHOT = os.path.join(_ASSETS, 'constraints.npz')
_MODELS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'mujoco_warp_tpu', 'models')
CONSTRAINTS_XML = os.path.join(_MODELS, 'constraints.xml')
# the large-tree contact scene: clutter_arm.xml with sleep off
# (the registered benchmark clutter_arm_nosleep, lossless contact slots)
CLUTTER_SNAPSHOT = os.path.join(_ASSETS, 'clutter_arm_nosleep.npz')
CLUTTER_XML = os.path.join(_MODELS, 'clutter_arm.xml')
# the sleeping scene: clutter_arm.xml as it is (sleep on), lossless slots
# (the registered benchmark clutter_arm), and its settled state
CLUTTER_ARM_SNAPSHOT = os.path.join(_ASSETS, 'clutter_arm.npz')
CLUTTER_ARM_SETTLED = os.path.join(_ASSETS, 'clutter_arm_settled.npz')
# clutter.xml (12 free bodies, sleep on) with its contacts compacted into
# {1: 24, 3: 48} slots, as the JAX tests/test_sleep_skip.py builds it, and
# its settled state: the sleep-skip step's scene
CLUTTER_SLEEP_XML = os.path.join(_MODELS, 'clutter.xml')
CLUTTER_SLEEP_NCONMAX = {1: 24, 3: 48}
CLUTTER_SLEEP_SNAPSHOT = os.path.join(_ASSETS, 'clutter.npz')
CLUTTER_SETTLED = os.path.join(_ASSETS, 'clutter_settled.npz')
# the contact zoo spheres.xml (condim 3/4/6 pairs of planes, spheres,
# capsules and boxes) in both cones: the registered benchmarks spheres
# (pyramidal) and spheres_elliptic (opt.cone=elliptic), lossless slots
SPHERES_XML = os.path.join(_MODELS, 'spheres.xml')
SPHERES_SNAPSHOT = os.path.join(_ASSETS, 'spheres.npz')
SPHERES_ELLIPTIC_SNAPSHOT = os.path.join(_ASSETS, 'spheres_elliptic.npz')
# spheres.xml with opt.solver=cg (the registered benchmark spheres_cg)
SPHERES_CG_SNAPSHOT = os.path.join(_ASSETS, 'spheres_cg.npz')
# the fused step's small gated scenes: JOINT equality rows (a coupled
# polynomial and a constant target) and the implicitfast integrator with
# joint damping; K4's forms beside the humanoid's damped Euler
EQ_JOINT_XML = os.path.join(_ASSETS, 'eq_joint.xml')
EQ_JOINT_SNAPSHOT = os.path.join(_ASSETS, 'eq_joint.npz')
IMPLICITFAST_XML = os.path.join(_ASSETS, 'implicitfast.xml')
IMPLICITFAST_SNAPSHOT = os.path.join(_ASSETS, 'implicitfast.npz')
# dm_control's walker, cheetah, hopper and humanoid with their sensors,
# cameras and lights: the registered benchmarks of those names (the
# humanoid as humanoid_dmc), each with its contact budget (None: lossless
# slots)
DMC_NCONMAX = {'walker': None, 'cheetah': None, 'hopper': None,
               'humanoid_dmc': {1: 16, 3: 32}}
DMC_SNAPSHOTS = {name: os.path.join(_ASSETS, f'{name}.npz')
                 for name in DMC_NCONMAX}
# the tendon scenes: dm_control's ball_in_cup and point_mass (lossless
# slots), the repo's sensors2.xml, and the port's tendon_wrap.xml (the
# spatial-tendon scene of tests/test_tendon.py) and tendon_mix.xml (every
# tendon feature the general step ports)
TENDON_DMC = ('ball_in_cup', 'point_mass')
TENDON_XML = {'sensors2': os.path.join(_MODELS, 'sensors2.xml'),
              'tendon_wrap': os.path.join(_ASSETS, 'tendon_wrap.xml'),
              'tendon_mix': os.path.join(_ASSETS, 'tendon_mix.xml')}
TENDON_SNAPSHOTS = {name: os.path.join(_ASSETS, f'{name}.npz')
                    for name in TENDON_DMC + tuple(TENDON_XML)}
# dm_control's classic tasks of the cylinder, ellipsoid and integrator
# slice: pendulum, reacher and finger (Euler), cartpole and acrobot (RK4)
# and humanoid_CMU (1157 candidates: the default budget of 48 slots,
# ``_default_nconmax``); the others lossless
CLASSIC_DMC = ('pendulum', 'reacher', 'finger', 'cartpole', 'acrobot',
               'humanoid_CMU')
CLASSIC_SNAPSHOTS = {name: os.path.join(_ASSETS, f'{name}.npz')
                     for name in CLASSIC_DMC}
# the elliptic-cone slice's dm_control tasks, each the model its task builds
# (the suite module's ``make_model`` with these arguments), lossless slots:
# manipulator insert_peg and stacker stack_2 (the elliptic solve kernel),
# stacker stack_4 (nefc x nv past the kernel: the torch elliptic Newton)
TASK_DMC = {'manipulator_insert_peg': ('manipulator',
                                       {'use_peg': True, 'insert': True}),
            'stack_2': ('stacker', {'n_boxes': 2}),
            'stack_4': ('stacker', {'n_boxes': 4})}
TASK_SNAPSHOTS = {name: os.path.join(_ASSETS, f'{name}.npz')
                  for name in TASK_DMC}
# the actuation slice's dm_control tasks, each the model ``suite.load``
# builds for (domain, task): quadruped (walk; run takes the same model;
# 175 candidates, lossless) and dog (run; stand, walk and trot take the
# same model; 6273 candidates: the default budget of 48 slots per condim
# class), both FILTER activations
ACT_DMC = {'quadruped': ('quadruped', 'walk'), 'dog': ('dog', 'run')}
# the actuation slice's test scenes: the repo's dcmotor.xml (DC motors)
# and transmission.xml (slider-crank and adhesion), and the port's
# actuator_mix.xml (every other dyntype, muscles, site transmissions and
# a joint's actuatorfrcrange)
ACT_XML = {'dcmotor': os.path.join(_MODELS, 'dcmotor.xml'),
           'transmission': os.path.join(_MODELS, 'transmission.xml'),
           'actuator_mix': os.path.join(_ASSETS, 'actuator_mix.xml')}
ACT_SNAPSHOTS = {name: os.path.join(_ASSETS, f'{name}.npz')
                 for name in (*ACT_DMC, *ACT_XML)}
# the fluid, ray and height-field slice's dm_control tasks, each the model
# ``suite.load`` builds for (domain, task): swimmer6 and swimmer15
# (density 3000), fish (swim; upright takes the same model; density
# 5000) and quadruped escape (a 201 x 201 height field, 20 rangefinders),
# whose terrain ``escape_terrain`` draws from ESCAPE_SEED into the
# snapshot
FLUID_DMC = {'swimmer6': ('swimmer', 'swimmer6'),
             'swimmer15': ('swimmer', 'swimmer15'),
             'fish': ('fish', 'swim'),
             'quadruped_escape': ('quadruped', 'escape')}
ESCAPE_SEED = 0
# its test scenes: the repo's sensors.xml (a rangefinder) and
# contact_sensor.xml (six contact sensors), the port's fluid_ellipsoid.xml
# (both fluid models, viscosity and wind) and geomdist.xml (the
# geom-distance sensors)
FLUID_XML = {'sensors': os.path.join(_MODELS, 'sensors.xml'),
             'contact_sensor': os.path.join(_MODELS, 'contact_sensor.xml'),
             'fluid_ellipsoid': os.path.join(_ASSETS, 'fluid_ellipsoid.xml'),
             'geomdist': os.path.join(_ASSETS, 'geomdist.xml')}
FLUID_SNAPSHOTS = {name: os.path.join(_ASSETS, f'{name}.npz')
                   for name in (*FLUID_DMC, *FLUID_XML)}
# the mocap slice's scene: the port's mocap_arm.xml (a mocap target welded
# to an arm's end-effector site, gravity compensation, delayed servos and
# sensors, the joint-in-parent transmission, a site-anchored connect)
ARM_XML = {'mocap_arm': os.path.join(_ASSETS, 'mocap_arm.xml')}
ARM_SNAPSHOTS = {name: os.path.join(_ASSETS, f'{name}.npz')
                 for name in ARM_XML}
# more candidate pairs than this and no budget given: the default budget
# (``io.py:653-654``)
# the elliptic-cone tasks' committed start states (``make_task_start``):
# finger_cg is finger's snapshot under the CG solver
TASK_STARTS = {name: os.path.join(_ASSETS, f'{name}_start.npz')
               for name in (*TASK_DMC, 'finger_cg')}
TASK_START_NWORLD = 64
LOSSLESS_MAX_CAND = 512
# the benchmark's per-condim contact budget (12 condim-1 + 24 condim-3 slots)
BENCH_NCONMAX = {1: 12, 3: 24}

# contact points per pair for the lane colliders of the fused step (the
# general step's are ops/collision_driver.py group_ncon)
PAIR_NCON = {
    (_GT.PLANE, _GT.SPHERE): 1,
    (_GT.PLANE, _GT.CAPSULE): 2,
    (_GT.PLANE, _GT.BOX): 4,
    (_GT.SPHERE, _GT.SPHERE): 1,
    (_GT.SPHERE, _GT.CAPSULE): 1,
    (_GT.SPHERE, _GT.BOX): 1,
    (_GT.CAPSULE, _GT.CAPSULE): 1,
    (_GT.CAPSULE, _GT.BOX): 2,
}

_NESTED = {'opt': types.Option, 'stat': types.Statistic,
           'tree': types.TreeInfo, 'efc': types.EfcLayout}


def resolve_device(device=None) -> torch.device:
  """``device``, with None meaning the CUDA device; raises when CUDA is
  asked for and there is none (the port never falls back to the CPU)."""
  dev = torch.device('cuda' if device is None else device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device: pass device="cpu" to run the plain '
                       'PyTorch versions on the CPU')
  return dev


# ------------------------------------------------------------ numpy <-> Model


def model_to_numpy(m: types.Model) -> dict:
  """Flat dict of a Model: ``name`` or ``'opt.name'`` -> numpy value."""
  out = {}

  def put(obj, cls, prefix):
    for name, kind in types.field_kinds(cls).items():
      val = getattr(obj, name)
      if kind == 'node':
        put(val, _NESTED[name], name + '.')
      elif kind == 'batch':
        continue
      elif kind == 'array':
        out[prefix + name] = types.host(val, types.np_float(val.dtype))
      else:
        out[prefix + name] = val
  put(m, types.Model, '')
  return out


def float_dtype(dtype) -> torch.dtype:
  """torch.float32 or torch.float64 from a torch or numpy float dtype;
  raises for any other."""
  name = str(dtype).split('.')[-1] if isinstance(dtype, torch.dtype) \
      else np.dtype(dtype).name
  if name not in ('float32', 'float64'):
    raise ValueError(f'dtype {dtype}: the port runs float32 or float64')
  return getattr(torch, name)


def model_from_numpy(d: dict, device=None, dtype=torch.float32
                     ) -> types.Model:
  """The port's Model from the JAX Model's fields as numpy values.

  ``d`` maps each field name (``'opt.timestep'`` for nested fields) to a
  numpy array, or to a python value for sizes, flags and the static tuple
  tables (``pair_groups``, ``con_classes``, ``tree.body_levels``).  The
  float fields take ``dtype`` (float32 or float64).
  """
  device = resolve_device(device)
  fdt = types.np_float(float_dtype(dtype))

  def build(cls, prefix):
    kw = {}
    for name, kind in types.field_kinds(cls).items():
      if kind == 'node':
        kw[name] = build(_NESTED[name], name + '.')
        continue
      if kind == 'batch':
        continue
      val = d[prefix + name]
      if kind == 'array':
        kw[name] = torch.tensor(np.asarray(val, fdt), device=device)
      elif kind == 'static':
        kw[name] = np.array(val)
      elif name == 'pair_groups':
        kw[name] = tuple((int(t1), int(t2), np.asarray(idx, np.int32),
                          int(slot)) for t1, t2, idx, slot in val)
      elif name == 'con_classes':
        kw[name] = tuple((int(dim), int(cap), np.asarray(ci, np.int32),
                          int(slot)) for dim, cap, ci, slot in val)
      elif name == 'body_levels':
        kw[name] = tuple(np.asarray(x, np.int32) for x in val)
      elif isinstance(val, (bool, np.bool_)):
        kw[name] = bool(val)
      else:
        kw[name] = int(val)
    return cls(**kw)

  return build(types.Model, '')


def _encode(flat: dict) -> dict:
  """Flat dict -> arrays only (tuple tables split into numbered keys)."""
  enc = {}
  for k, v in flat.items():
    if k == 'pair_groups':
      enc[k + '.meta'] = np.asarray([(t1, t2, s) for t1, t2, _, s in v],
                                    np.int64).reshape(-1, 3)
      for i, g in enumerate(v):
        enc[f'{k}.idx.{i}'] = np.asarray(g[2], np.int32)
    elif k == 'con_classes':
      enc[k + '.meta'] = np.asarray([(dm, cap, s) for dm, cap, _, s in v],
                                    np.int64).reshape(-1, 3)
      for i, c in enumerate(v):
        enc[f'{k}.idx.{i}'] = np.asarray(c[2], np.int32)
    elif k == 'tree.body_levels':
      enc[k + '.n'] = np.asarray(len(v))
      for i, lvl in enumerate(v):
        enc[f'{k}.{i}'] = np.asarray(lvl, np.int32)
    else:
      enc[k] = np.asarray(v)
  return enc


def _decode(enc) -> dict:
  flat = {}
  for k in enc.files:
    if '.idx.' in k or k.startswith('tree.body_levels'):
      continue
    if k.endswith('.meta'):
      base = k[:-len('.meta')]
      meta = enc[k]
      flat[base] = tuple((int(a), int(b), enc[f'{base}.idx.{i}'], int(s))
                         for i, (a, b, s) in enumerate(meta))
      continue
    v = enc[k]
    flat[k] = v.item() if v.ndim == 0 else v
  n = int(enc['tree.body_levels.n'])
  flat['tree.body_levels'] = tuple(enc[f'tree.body_levels.{i}']
                                   for i in range(n))
  return flat


def save_model_npz(path: str, m: types.Model):
  if m.batch_fields:
    raise ValueError('a batched Model has no snapshot: save the unbatched '
                     'one and batch it after loading')
  np.savez_compressed(path, **_encode(model_to_numpy(m)))


def load_model_npz(path: str = SNAPSHOT, device=None,
                   dtype=torch.float32) -> types.Model:
  """A snapshot of ``save_model_npz`` (float32 snapshots: ``dtype``
  float64 widens them, it does not recover what float32 dropped)."""
  with np.load(path) as z:
    return model_from_numpy(_decode(z), device=device, dtype=dtype)


# ------------------------------------------------------------- put_model


def _tree_info(mjm) -> types.TreeInfo:
  """Levels and masks (``mujoco_warp_tpu/io.py:42`` ``_tree_info``)."""
  nbody, nv = mjm.nbody, mjm.nv
  parent = mjm.body_parentid
  depth = np.zeros(nbody, dtype=np.int32)
  for i in range(1, nbody):
    depth[i] = depth[parent[i]] + 1
  maxdepth = int(depth.max()) if nbody > 1 else 0
  levels = tuple(np.nonzero(depth == lv)[0].astype(np.int32)
                 for lv in range(1, maxdepth + 1))
  subtree = np.zeros((nbody, nbody), dtype=bool)
  for j in range(nbody):
    a = j
    while True:
      subtree[a, j] = True
      if a == 0:
        break
      a = parent[a]
  anc = np.zeros((nv, nv), dtype=bool)
  for i in range(nv):
    a = i
    while a >= 0:
      anc[i, a] = True
      a = mjm.dof_parentid[a]
  cdofdot = np.zeros((nv, nv), dtype=bool)
  for i in range(nv):
    jid = mjm.dof_jntid[i]
    a = mjm.dof_parentid[i]
    while a >= 0:
      if mjm.dof_jntid[a] != jid:
        cdofdot[i, a] = True
      a = mjm.dof_parentid[a]
    if mjm.jnt_type[jid] == _JT.FREE:
      dadr = mjm.jnt_dofadr[jid]
      if i >= dadr + 3:  # rotational dof of a free joint
        cdofdot[i, dadr:dadr + 3] = True
  return types.TreeInfo(
      body_levels=levels, ancestor_mask=anc, subtree_mask=subtree,
      body_dof_mask=subtree[mjm.dof_bodyid, :].T,
      dof_subtree_mask=subtree[mjm.dof_bodyid, :], cdofdot_mask=cdofdot)


_EQ_NROW = {int(types.EqType.CONNECT): ('connect', 3),
            int(types.EqType.WELD): ('weld', 6),
            int(types.EqType.JOINT): ('joint', 1),
            int(types.EqType.TENDON): ('tendon', 1)}


def _efc_layout(mjm, con_dim: np.ndarray, cone: int):
  """Static row layout (``mujoco_warp_tpu/io.py:126`` ``_efc_layout``).

  Rows: equality | dof friction | tendon friction | joint limits | tendon
  limits | contacts.  Returns (ne, nf, nl, nefc, con_efc_address,
  EfcLayout).
  """
  _CT = types.ConstraintType
  eq = {k: ([], []) for k in ('connect', 'weld', 'joint', 'tendon', 'flex')}
  efc_type, efc_id = [], []
  for eqid, et in enumerate(mjm.eq_type):
    if int(et) not in _EQ_NROW:  # flex equality: not ported yet
      raise NotImplementedError(f'equality type {int(et)} not supported')
    name, n = _EQ_NROW[int(et)]
    eq[name][0].append(eqid)
    eq[name][1].append(len(efc_type))
    efc_type += [int(_CT.EQUALITY)] * n
    efc_id += [eqid] * n
  ne = len(efc_type)
  ids = lambda x: np.asarray(x, np.int32).reshape(-1)

  def group(sel, ct):
    adr = len(efc_type) + np.arange(len(sel), dtype=np.int32)
    efc_type.extend([int(ct)] * len(sel))
    efc_id.extend(int(x) for x in sel)
    return ids(sel), adr

  no = np.zeros(0, np.int32)
  fri_dof, fri_dof_adr = group(np.nonzero(mjm.dof_frictionloss > 0)[0],
                               _CT.FRICTION_DOF)
  fri_ten, fri_ten_adr = group(
      np.nonzero(mjm.tendon_frictionloss > 0)[0] if mjm.ntendon else no,
      _CT.FRICTION_TENDON)
  nf = len(efc_type) - ne
  lim_jnt, lim_jnt_adr = group(np.nonzero(mjm.jnt_limited)[0],
                               _CT.LIMIT_JOINT)
  lim_ten, lim_ten_adr = group(
      np.nonzero(mjm.tendon_limited)[0] if mjm.ntendon else no,
      _CT.LIMIT_TENDON)
  nl = len(efc_type) - ne - nf
  con_adr = np.zeros(len(con_dim), np.int32)
  for i, dim in enumerate(con_dim):
    con_adr[i] = len(efc_type)
    if int(dim) == 1:
      ct, nrow = _CT.CONTACT_FRICTIONLESS, 1
    elif cone == types.ConeType.PYRAMIDAL:
      ct, nrow = _CT.CONTACT_PYRAMIDAL, 2 * (int(dim) - 1)
    else:
      ct, nrow = _CT.CONTACT_ELLIPTIC, int(dim)
    efc_type += [int(ct)] * nrow
    efc_id += [i] * nrow
  layout = types.EfcLayout(
      connect_id=ids(eq['connect'][0]), connect_adr=ids(eq['connect'][1]),
      weld_id=ids(eq['weld'][0]), weld_adr=ids(eq['weld'][1]),
      joint_id=ids(eq['joint'][0]), joint_adr=ids(eq['joint'][1]),
      tendon_id=ids(eq['tendon'][0]), tendon_adr=ids(eq['tendon'][1]),
      flex_id=ids(eq['flex'][0]), flex_adr=ids(eq['flex'][1]),
      fri_dof_id=fri_dof, fri_dof_adr=fri_dof_adr, fri_ten_id=fri_ten,
      fri_ten_adr=fri_ten_adr, lim_jnt_id=lim_jnt, lim_jnt_adr=lim_jnt_adr,
      lim_ten_id=lim_ten, lim_ten_adr=lim_ten_adr, efc_type=ids(efc_type),
      efc_id=ids(efc_id))
  return ne, nf, nl, len(efc_type), con_adr, layout


def _con_classes(con_dim: np.ndarray, nconmax) -> Tuple:
  """Per-condim slot classes (``mujoco_warp_tpu/io.py:367``)."""
  classes = []
  slot = 0
  for dim in sorted(set(int(x) for x in con_dim)):
    cand_idx = np.nonzero(con_dim == dim)[0].astype(np.int32)
    n = len(cand_idx)
    if isinstance(nconmax, dict):
      cap = min(n, max(1, int(nconmax.get(dim, n))))
    else:
      cap = min(n, max(1, int(nconmax)))
    classes.append((dim, cap, cand_idx, slot))
    slot += cap
  return tuple(classes)


def _custom_numeric(mjm, name: str):
  """A named MJCF ``<custom><numeric>`` scalar, or None
  (``mujoco_warp_tpu/io.py:358``)."""
  import mujoco
  nid = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_NUMERIC, name)
  if nid < 0:
    return None
  return float(mjm.numeric_data[mjm.numeric_adr[nid]])


def _default_nconmax(mjm) -> int:
  """The default per-world contact budget (``mujoco_warp_tpu/io.py:396``):
  a heuristic on the scene, rounded up to the ladder 16, 24, 32, 48, 64,
  96, ..."""
  valid = (2 + (np.arange(19) % 2)) * (2 ** (np.arange(19) // 2 + 3))
  has_sdf = bool((mjm.geom_type == int(_GT.SDF)).any())
  guess = max(mjm.nv * 0.35 * (mjm.nhfield > 0) * 10 + 45,
              256 * (mjm.nflex > 0), 64 * has_sdf)
  if guess > valid[-1]:
    return int(guess)
  return int(valid[np.searchsorted(valid, guess)])


def _collision_pairs(mjm):
  """Filtered candidate pairs grouped by collider
  (``mujoco_warp_tpu/ops/collision_driver.py:49``): the primitive
  colliders and, for two convex types without one (box-box), MPR with
  ``convex_ncon`` points per pair (:167-231).

  Returns (pair_geom1, pair_geom2, pair condim, con_pair, groups).
  """
  if mjm.npair or mjm.nflex:
    raise NotImplementedError('explicit <pair> and flex contacts run on '
                              'the general path, not ported yet')
  excluded = set()
  for sig in mjm.exclude_signature:
    excluded.add((int(sig) >> 16, int(sig) & 0xFFFF))
  gt, gb = mjm.geom_type, mjm.geom_bodyid
  g1s, g2s = [], []
  for a in range(mjm.ngeom):
    for b in range(a + 1, mjm.ngeom):
      ba, bb = gb[a], gb[b]
      if ba == bb:
        continue
      wa, wb = mjm.body_weldid[ba], mjm.body_weldid[bb]
      if wa == wb:
        continue
      if (int(mjm.geom_contype[a]) & int(mjm.geom_conaffinity[b])) == 0 and \
         (int(mjm.geom_contype[b]) & int(mjm.geom_conaffinity[a])) == 0:
        continue
      if not mjm.opt.disableflags & types.DisableBit.FILTERPARENT:
        wpa = mjm.body_weldid[mjm.body_parentid[wa]]
        wpb = mjm.body_weldid[mjm.body_parentid[wb]]
        if wa != 0 and wb != 0 and (wa == wpb or wb == wpa):
          continue
      if ((min(ba, bb), max(ba, bb)) in excluded or
          (max(ba, bb), min(ba, bb)) in excluded):
        continue
      if gt[a] <= gt[b]:
        g1s.append(a)
        g2s.append(b)
      else:
        g1s.append(b)
        g2s.append(a)
  from mujoco_warp_tpu_torch.ops import collision_driver
  keys = [(int(gt[a]), int(gt[b])) for a, b in zip(g1s, g2s)]
  for key in set(keys):
    collision_driver.collider(*key)  # raises for a pair without one
  pdim = np.zeros(len(g1s), np.int32)
  for i, (a, b) in enumerate(zip(g1s, g2s)):
    p1, p2 = mjm.geom_priority[a], mjm.geom_priority[b]
    if p1 > p2:
      pdim[i] = mjm.geom_condim[a]
    elif p2 > p1:
      pdim[i] = mjm.geom_condim[b]
    else:
      pdim[i] = max(mjm.geom_condim[a], mjm.geom_condim[b])
  order = sorted(range(len(g1s)), key=lambda i: (keys[i], int(pdim[i])))
  g1 = np.asarray([g1s[i] for i in order], np.int32).reshape(-1)
  g2 = np.asarray([g2s[i] for i in order], np.int32).reshape(-1)
  pdim = pdim[order] if order else pdim
  keys = [keys[i] for i in order]
  groups, con_pair = [], []
  slot = i = 0
  while i < len(keys):
    j = i
    while j < len(keys) and keys[j] == keys[i] and pdim[j] == pdim[i]:
      j += 1
    k = collision_driver.group_ncon(*keys[i])
    groups.append((keys[i][0], keys[i][1], np.arange(i, j, dtype=np.int32),
                   slot))
    for _ in range(k):  # slots are contact-point-major per group
      con_pair.extend(range(i, j))
    slot += k * (j - i)
    i = j
  return g1, g2, pdim, np.asarray(con_pair, np.int32).reshape(-1), \
      tuple(groups)


# the per-candidate contact tables that ``remix`` fills
CAND_FIELDS = ('cand_friction', 'cand_solref', 'cand_solimp',
               'cand_includemargin', 'cand_margin')


def remix(m: types.Model) -> types.Model:
  """``m`` with its per-candidate contact tables mixed from its geom
  fields (``collision_driver.py:250`` ``_mix_params``, host form, with its
  ``EnableBit.OVERRIDE`` branch :317-326), in the Model's dtype, on its
  device: the geoms' priority, solmix, solref, solimp, margin, gap and
  friction, or under the override ``opt.o_margin`` and the other ``o_*``
  fields.  ``cand_includemargin`` is margin - gap, ``cand_margin`` the
  margin (adhesion's contact test).  Where a geom contact field, or
  under the override an ``o_*`` field, is batched (``batch_model``),
  every world mixes its own values and the tables are batched too (the
  JAX ``batch_model`` re-mixes only for the geom fields, so a batched
  ``o_*`` leaves its tables at the unbatched values: ROADMAP queue 3)."""
  fdt = types.np_float(types.dtype_of(m))
  override = bool(int(m.opt.enableflags) & types.EnableBit.OVERRIDE)
  batched = any(n in m.batch_fields for n in GEOM_CONTACT + (
      _OVERRIDE if override else ()))

  def h(name, dtype=fdt):
    x = types.world_field(m, name)
    return np.asarray(types.host(x, dtype) if isinstance(x, torch.Tensor)
                      else x, dtype)

  # every operand (1 or W, ngeom, ...): the mix is elementwise per world
  g1, g2 = m.pair_geom1[m.con_pair], m.pair_geom2[m.con_pair]
  prio = h('geom_priority', np.int32)
  p1, p2 = prio[:, g1], prio[:, g2]
  use1 = (p1 > p2).astype(fdt)[..., None]
  use2 = (p2 > p1).astype(fdt)[..., None]
  eq = 1.0 - use1 - use2
  solmix = h('geom_solmix')
  s1, s2 = solmix[:, g1], solmix[:, g2]
  mix = s1 / np.maximum(s1 + s2, 1e-12)
  mix = np.where((s1 < 1e-12) & (s2 < 1e-12), 0.5, mix)
  mix = np.where((s1 < 1e-12) & (s2 >= 1e-12), 0.0, mix)
  mix = np.where((s1 >= 1e-12) & (s2 < 1e-12), 1.0, mix)
  mix = (eq[..., 0] * mix + use1[..., 0] * 1.0 + use2[..., 0] * 0.0)[
      ..., None]
  sr, si = h('geom_solref'), h('geom_solimp')
  sr1, sr2 = sr[:, g1], sr[:, g2]
  standard = (sr1[..., [0]] > 0) & (sr2[..., [0]] > 0)
  solref = np.where(standard, mix * sr1 + (1 - mix) * sr2,
                    np.minimum(sr1, sr2))
  solimp = mix * si[:, g1] + (1 - mix) * si[:, g2]
  gm, gg = h('geom_margin'), h('geom_gap')
  margin = np.maximum(gm[:, g1], gm[:, g2])
  gap = np.maximum(gg[:, g1], gg[:, g2])
  fr = h('geom_friction')
  f1, f2 = fr[:, g1], fr[:, g2]
  fr3 = eq * np.maximum(f1, f2) + use1 * f1 + use2 * f2
  friction = np.stack(
      [fr3[..., 0], fr3[..., 0], fr3[..., 1], fr3[..., 2], fr3[..., 2]],
      axis=-1)
  if override:  # each world's override values (1 or W, ...)
    o = lambda n, x: np.broadcast_to(
        h('opt.o_' + n)[:, None], (h('opt.o_' + n).shape[0],) + x.shape[1:])
    margin, solref = o('margin', margin), o('solref', solref)
    solimp, friction = o('solimp', solimp), o('friction', friction)
  dev = m.qpos0.device
  W = types.model_nworld(m) if batched else 1
  tables = dict(cand_friction=friction, cand_solref=solref,
                cand_solimp=solimp, cand_includemargin=margin - gap,
                cand_margin=margin)
  out = {}
  for k, x in tables.items():
    x = np.broadcast_to(x, (W,) + x.shape[1:])
    x = torch.tensor(np.ascontiguousarray(x, fdt), device=dev)
    out[k] = x if batched else x[0]
  if batched:
    out['batch_fields'] = tuple(sorted(set(m.batch_fields) |
                                       set(CAND_FIELDS)))
  return m.replace(**out)


# the fields that gate the program's structure on the host and that no
# world may carry its own value of (``io.py:1004``)
_NO_BATCH = frozenset({'geom_size', 'wrap_prm', 'sensor_cutoff',
                       'opt.timestep'})
# the geoms' contact parameters, which ``remix`` mixes into the
# candidate tables (``io.py:1009``)
GEOM_CONTACT = ('geom_friction', 'geom_solref', 'geom_solimp',
                'geom_margin', 'geom_gap', 'geom_solmix', 'geom_priority')
# the override values ``remix`` takes under the OVERRIDE flag
_OVERRIDE = ('opt.o_margin', 'opt.o_solref', 'opt.o_solimp', 'opt.o_friction')
# what ``set_const`` recomputes
SET_CONST_FIELDS = ('body_subtreemass', 'dof_invweight0', 'body_invweight0',
                    'tendon_length0', 'tendon_invweight0',
                    'tendon_lengthspring', 'eq_data', 'actuator_acc0',
                    'actuator_biasprm')
# the other fields the JAX batched step traces with a leading world
# axis: options, springs, placement, the joint, dof, tendon and equality
# solver parameters, cameras, lights, actuation and height fields
# (ROADMAP queue 1 holds the table)
_PER_WORLD = (
    'opt.impratio', 'opt.tolerance', 'opt.ls_tolerance', 'opt.wind',
    'opt.magnetic', 'opt.density', 'opt.viscosity', 'opt.sleep_tolerance',
    'opt.o_margin', 'opt.o_solref', 'opt.o_solimp', 'opt.o_friction',
    'qpos_spring', 'body_pos', 'body_quat', 'body_iquat', 'body_gravcomp',
    'jnt_solref', 'jnt_solimp', 'jnt_pos', 'jnt_axis', 'jnt_stiffness',
    'jnt_range', 'jnt_actfrcrange', 'jnt_margin', 'dof_solref',
    'dof_solimp', 'geom_rbound', 'geom_aabb', 'geom_pos', 'geom_quat',
    'site_pos', 'site_quat', 'site_size', 'cam_pos', 'cam_quat',
    'cam_poscom0', 'cam_pos0', 'cam_mat0', 'cam_fovy', 'cam_intrinsic',
    'cam_sensorsize', 'light_pos', 'light_dir', 'light_poscom0',
    'light_pos0', 'light_dir0', 'eq_solref', 'eq_solimp',
    'tendon_solref_lim', 'tendon_solimp_lim', 'tendon_solref_fri',
    'tendon_solimp_fri', 'tendon_range', 'tendon_actfrcrange',
    'tendon_margin', 'tendon_stiffness', 'tendon_damping',
    'tendon_armature', 'tendon_frictionloss', 'actuator_actrange',
    'actuator_cranklength', 'actuator_lengthrange', 'actuator_length0',
    'hfield_size', 'hfield_data')


def _dc_motors(m: types.Model) -> np.ndarray:
  return np.nonzero(np.asarray(m.actuator_dyntype) ==
                    types.DynType.DCMOTOR)[0] if m.nu else np.zeros(0, int)


def _fluid_runs(m: types.Model) -> bool:
  """Do fluid forces run: a batched density or viscosity (the JAX gate's
  ``concrete_or`` default, ``passive.py:315-316``), or one set."""
  return any(n in m.batch_fields or bool(np.any(types.host(
      types.get_model_field(m, n)) != 0))
      for n in ('opt.density', 'opt.viscosity'))


def _sensor_history(m: types.Model) -> bool:
  return bool(np.any(np.asarray(m.sensor_history).reshape(-1, 2)[:, 0] > 0))


# fields the JAX step reads on the host where a model uses them, so that
# its vmapped step cannot trace them batched there (elsewhere nothing
# reads them and both batch them): name -> (does ``m`` read it on the
# host, the JAX read)
HOST_READ = {
    'geom_fluid': (_fluid_runs, 'ops/passive.py:62 (_ellipsoid_bodies, '
                   'wherever fluid forces run)'),
    'dof_length': (lambda m: bool(m.opt.enableflags & types.EnableBit.SLEEP)
                   and m.ntree > 0, 'ops/sleep.py:55 (_cannot_sleep, '
                   'with sleep on)'),
    'sensor_delay': (_sensor_history,
                     'ops/history.py:150 (apply_sensor_delay)'),
    'sensor_interval': (_sensor_history,
                        'ops/history.py:151 (apply_sensor_delay)'),
    'actuator_delay': (lambda m: m.nhistory > 0 and m.nu > 0,
                       'ops/history.py:124 (read_ctrl_delayed)'),
    'actuator_dynprm': (lambda m: _dc_motors(m).size > 0,
                        'ops/forward.py:134 and :203, a DC motor\'s slot '
                        'layout'),
    'actuator_gainprm': (lambda m: _dc_motors(m).size > 0,
                         'ops/forward.py:135 and :204, a DC motor\'s input '
                         'mode'),
    'actuator_biasprm': (lambda m: bool(np.any(
        np.asarray(m.actuator_biastype)[_dc_motors(m)] ==
        types.BiasType.DCMOTOR)),
        'ops/forward.py:324, a DC motor\'s cogging switch'),
}
# fields of the JAX Model the port's Model lacks, with what ports them
_NOT_PORTED = {
    'mesh_vert': 'meshes (ROADMAP queue 1 item 2); the JAX step also '
                 'reads it on the host, ops/collision_convex.py:119',
    **{f'pair_{k}': 'explicit <pair> contacts (ROADMAP queue 1 item 3)'
       for k in ('margin', 'gap', 'friction', 'solref', 'solreffriction',
                 'solimp')},
}
# the fields the port's general step reads per world: what the JAX batched
# step takes; ``batch_model`` refuses the rest
BATCHABLE = frozenset(
    ('opt.gravity', 'dof_damping', 'dof_armature', 'dof_frictionloss',
     'body_mass', 'body_inertia', 'body_ipos', 'qpos0', 'actuator_gainprm',
     'actuator_biasprm', 'actuator_gear', 'actuator_ctrlrange',
     'actuator_forcerange', 'actuator_dynprm') + GEOM_CONTACT +
    SET_CONST_FIELDS + _PER_WORLD + tuple(HOST_READ))


def host_read(m: types.Model, name: str):
  """Where the JAX step reads field ``name`` of ``m`` (as batched as it
  is) on the host, or None where it does not (``HOST_READ``)."""
  reads, where = HOST_READ.get(name, (None, None))
  return where if reads is not None and reads(m) else None


def batch_model(m: types.Model, nworld: int, fields: dict) -> types.Model:
  """Per-world model parameters, for domain randomization
  (``io.py:1013`` ``batch_model``).

  ``fields`` maps names (``opt.``-dotted for Option fields) to ``(B,
  *field.shape)`` arrays; B must divide ``nworld``, and the arrays are
  tiled to ``nworld`` (world w takes row w % B).  Each named field gets a
  leading world axis on the Model's device, in its dtype, and
  ``batch_fields`` records the names.  Batching a geom contact field
  (``GEOM_CONTACT``) mixes the candidate tables per world (``remix``),
  whose names join ``batch_fields``, as does an override field
  (``opt.o_*``) under the OVERRIDE flag.  ``forward.step`` then runs
  world w with world w's values; it takes Data of ``nworld`` worlds.

  Raises NotImplementedError for a field of ``_NO_BATCH``, for one the
  JAX step reads on the host in this model (``HOST_READ``: the message
  names the read), for one the port's Model lacks (``_NOT_PORTED``),
  ValueError for a field that is not an array, a wrong trailing shape, a
  batch that does not divide ``nworld``, or a width other than the
  Model's batch."""
  have = types.model_nworld(m)
  if have is not None and have != nworld:
    raise ValueError(f'the Model is batched over {have} worlds, not '
                     f'{nworld}')
  dev = m.qpos0.device
  updates = {}
  for name, val in fields.items():
    if name in _NO_BATCH:
      raise NotImplementedError(
          f'{name} gates static host-side structure and cannot be '
          'batched per world')
    if name in _NOT_PORTED:
      raise NotImplementedError(f'{name}: not ported: {_NOT_PORTED[name]}')
    try:
      base = types.get_model_field(m, name)
    except AttributeError:
      base = None
    if not isinstance(base, (torch.Tensor, np.ndarray)) or \
        name not in BATCHABLE:
      raise ValueError(f'{name} is not a batchable array field')
    shape = tuple(base.shape[1:] if name in m.batch_fields else base.shape)
    if isinstance(val, torch.Tensor):
      val = val.detach().cpu().numpy()
    val = np.asarray(val)
    if val.shape[1:] != shape:
      raise ValueError(f'{name}: expected trailing shape {shape}, got '
                       f'{val.shape[1:]}')
    b = val.shape[0]
    if b == 0 or nworld % b:
      raise ValueError(f'{name}: batch {b} does not divide nworld {nworld}')
    # C order whatever the input's strides (a broadcast view, Fortran
    # order): the kernels read a batched field at a world stride
    val = np.ascontiguousarray(np.tile(val, (nworld // b,) +
                                       (1,) * (val.ndim - 1)))
    if isinstance(base, torch.Tensor):
      updates[name] = torch.tensor(val, dtype=base.dtype, device=dev)
    elif np.issubdtype(base.dtype, np.integer):  # geom_priority
      updates[name] = torch.tensor(val.astype(np.int32), device=dev)
    else:  # a float table the host reads where the model uses it
      updates[name] = torch.tensor(val, dtype=m.qpos0.dtype, device=dev)
  names = set(m.batch_fields) | set(updates)
  m = types.set_model_fields(m, updates).replace(
      batch_fields=tuple(sorted(names)))
  for name in m.batch_fields:
    where = host_read(m, name)
    if where is not None:
      raise NotImplementedError(
          f'{name}: the JAX batched step reads it on the host at {where}, '
          'so this model cannot take it per world')
  override = bool(int(m.opt.enableflags) & types.EnableBit.OVERRIDE)
  if m.ncand and any(n in updates for n in GEOM_CONTACT) or (
      override and any(n in updates for n in _OVERRIDE)):
    m = remix(m)
  return m


def put_model(mjm, nconmax=None, device=None, dtype=torch.float32
              ) -> types.Model:
  """A ``mujoco.MjModel`` as the port's Model (``io.py:585`` ``put_model``):
  every float field of ``dtype``, float32 or float64.  A float32 model
  floors ``opt.tolerance`` at 1e-6, a float64 model keeps MuJoCo's
  (``io.py:610-612``).  The float64 path runs the general step on the
  CPU; the fused step and the CUDA kernels take float32 only.

  ``nconmax``: per-world active-contact budget, an int or a
  ``{condim: budget}`` dict; below the candidate count, active contacts
  are compacted into the budgeted slots each step.  Without one, the
  model's ``<numeric name="nconmax">`` sets it, and failing that a model
  of more than ``LOSSLESS_MAX_CAND`` candidates takes ``_default_nconmax``
  (``io.py:616-661``).  Raises for a model that neither the fused step nor
  the general step supports yet.
  """
  device = resolve_device(device)
  dtype = float_dtype(dtype)
  if mjm.opt.solver == 0:
    raise NotImplementedError('PGS solver is not supported')
  if nconmax is None:
    cn = _custom_numeric(mjm, 'nconmax')
    nconmax = int(cn) if cn is not None else None
  g1, g2, pdim, con_pair, groups = _collision_pairs(mjm)
  ncand = len(con_pair)
  cand_dim = pdim[con_pair] if ncand else np.zeros(0, np.int32)
  if nconmax is None and ncand > LOSSLESS_MAX_CAND:
    nconmax = _default_nconmax(mjm)
  con_classes, con_compact, ncon, slot_dim = (), False, ncand, cand_dim
  if nconmax is not None and ncand:
    con_classes = _con_classes(cand_dim, nconmax)
    ncon = sum(c[1] for c in con_classes)
    if ncon < ncand:
      con_compact = True
      slot_dim = np.concatenate(
          [np.full(cap, dim, np.int32) for dim, cap, _, _ in con_classes])
    else:
      con_classes, ncon = (), ncand
  ne, nf, nl, nefc, con_adr, efc = _efc_layout(mjm, slot_dim,
                                               int(mjm.opt.cone))
  o = mjm.opt
  d = {
      'nq': mjm.nq, 'nv': mjm.nv, 'nu': mjm.nu, 'na': mjm.na,
      'nbody': mjm.nbody, 'njnt': mjm.njnt, 'ngeom': mjm.ngeom,
      'nsite': mjm.nsite, 'ncam': mjm.ncam, 'nlight': mjm.nlight,
      'nmocap': mjm.nmocap, 'neq': mjm.neq, 'ntendon': mjm.ntendon,
      'nsensor': mjm.nsensor, 'nsensordata': mjm.nsensordata,
      'nhistory': mjm.nhistory, 'ntree': mjm.ntree,
      'nflex': mjm.nflex, 'ne': ne, 'nf': nf, 'nl': nl, 'nefc': nefc,
      'ncon': ncon, 'ncand': ncand, 'con_classes': con_classes,
      'con_compact': con_compact,
      # f32 models floor the tolerance at 1e-6 (io.py:610-612)
      'opt.timestep': o.timestep, 'opt.impratio': o.impratio,
      'opt.tolerance': (max(float(o.tolerance), 1e-6)
                        if dtype == torch.float32 else float(o.tolerance)),
      'opt.ls_tolerance': o.ls_tolerance, 'opt.gravity': o.gravity,
      'opt.magnetic': o.magnetic,
      'opt.density': o.density, 'opt.viscosity': o.viscosity,
      'opt.wind': o.wind,
      'opt.sleep_tolerance': o.sleep_tolerance,
      'opt.o_margin': o.o_margin, 'opt.o_solref': o.o_solref,
      'opt.o_solimp': o.o_solimp, 'opt.o_friction': o.o_friction,
      'opt.integrator': int(o.integrator), 'opt.cone': int(o.cone),
      'opt.solver': int(o.solver), 'opt.iterations': int(o.iterations),
      'opt.ls_iterations': int(o.ls_iterations),
      'opt.disableflags': int(o.disableflags),
      'opt.enableflags': int(o.enableflags),
      'opt.run_collision_detection': True,
      'stat.meaninertia': mjm.stat.meaninertia,
      'con_dim': slot_dim, 'con_efc_address': con_adr, 'pair_geom1': g1, 'pair_geom2': g2,
      'con_pair': con_pair, 'pair_groups': groups,
      # filled by remix below, from the Model's geom fields
      **{k: np.zeros(0) for k in CAND_FIELDS},
      'cam_mat0': np.asarray(mjm.cam_mat0).reshape(-1, 3, 3),
      'geom_fluid': np.asarray(mjm.geom_fluid).reshape(mjm.ngeom, -1),
      'geom_aabb': np.asarray(mjm.geom_aabb).reshape(mjm.ngeom, 6),
      'hfield_size': np.asarray(mjm.hfield_size).reshape(-1, 4),
  }
  for name in ('ancestor_mask', 'subtree_mask', 'body_dof_mask',
               'dof_subtree_mask', 'cdofdot_mask', 'body_levels'):
    d['tree.' + name] = getattr(_tree_info(mjm), name)
  for name in types.field_kinds(types.EfcLayout):
    d['efc.' + name] = getattr(efc, name)
  for name, kind in types.field_kinds(types.Model).items():
    if name in d or kind not in ('array', 'static'):
      continue
    d[name] = np.array(getattr(mjm, name))
  m = remix(model_from_numpy(d, device=device, dtype=dtype))
  check_supported(m)
  return m


def check_supported(m: types.Model):
  """Raise unless the fused step or the general step runs ``m``."""
  from mujoco_warp_tpu_torch import fused
  from mujoco_warp_tpu_torch.ops import forward
  why_fused, why_general = fused.reason(m), forward.unsupported(m)
  if why_fused is not None and why_general is not None:
    raise NotImplementedError(
        f'model outside the ported paths: fused gate ({why_fused}), '
        f'general step ({why_general})')


# ------------------------------------------------------------------ Data


def make_data(m: types.Model, nworld: int, device=None, dtype=None
              ) -> types.Data:
  """A batch of worlds at qpos0 and rest (``io.py:1076`` ``make_data``):
  every tree awake (``K_AWAKE``, ``io.py:1198-1202``), no island.  The
  float fields take ``dtype``, by default the Model's.  A batched qpos0
  (``batch_model``) gives each world its own, and then ``nworld`` must be
  the Model's batch."""
  dev = resolve_device(device)
  fl = dict(dtype=types.dtype_of(m) if dtype is None else float_dtype(dtype),
            device=dev)
  z = lambda *shape: torch.zeros((nworld,) + shape, **fl)
  i32 = lambda fill, *shape: torch.full((nworld,) + shape, fill,
                                        dtype=torch.int32, device=dev)
  qpos0 = types.world_field(m, 'qpos0').to(**fl)
  if qpos0.shape[0] not in (1, nworld):
    raise ValueError(f'qpos0 is batched over {qpos0.shape[0]} worlds, not '
                     f'{nworld}')
  eq0 = torch.as_tensor(np.asarray(m.eq_active0, bool).reshape(-1),
                        device=dev)
  mocap_pos, mocap_quat = mocap_rest(m)
  d = types.Data(
      time=z(), qpos=qpos0.expand(nworld, m.nq).clone(), qvel=z(m.nv),
      act=z(m.na), act_dot=z(m.na), ctrl=z(m.nu), qfrc_applied=z(m.nv),
      xfrc_applied=z(m.nbody, 6), eq_active=eq0[None].repeat(nworld, 1),
      mocap_pos=mocap_pos.to(**fl).expand(nworld, -1, -1).clone(),
      mocap_quat=mocap_quat.to(**fl).expand(nworld, -1, -1).clone(),
      history=z(m.nhistory), qacc_warmstart=z(m.nv), qacc=z(m.nv),
      energy=z(2), sensordata=z(m.nsensordata),
      solver_niter=i32(0), overflow=i32(0),
      tree_asleep=i32(types.K_AWAKE, m.ntree), nisland=i32(0),
      tree_island=i32(-1, m.ntree), dof_island=i32(-1, m.nv),
      efc_island=i32(-1, m.nefc))
  from mujoco_warp_tpu_torch.ops import history
  return history.init_history(m, d)


def mocap_rest(m: types.Model):
  """(mocap_pos (1 or W, nmocap, 3), mocap_quat (1 or W, nmocap, 4)):
  each mocap body's body_pos and body_quat, each world's where they are
  batched, as MuJoCo C's ``mj_resetData`` sets them.  The JAX
  ``make_data`` sets mocap_pos to zero (``io.py:1151``)."""
  bodies = np.nonzero(np.asarray(m.body_mocapid) >= 0)[0]
  order = bodies[np.argsort(np.asarray(m.body_mocapid)[bodies])]
  idx = torch.as_tensor(order, dtype=torch.long, device=m.body_pos.device)
  return (types.world_field(m, 'body_pos')[:, idx],
          types.world_field(m, 'body_quat')[:, idx])


# ------------------------------------------------------- the public Data API

# the MjData fields ``put_data`` copies (``io.py:1221-1234``)
PUT_FIELDS = ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qfrc_applied',
              'xfrc_applied', 'mocap_pos', 'mocap_quat', 'qacc_warmstart',
              'qacc')
# the fields ``get_data_into`` copies back, each where the model has its
# objects (``io.py:1282-1327``); MjData keeps its xmat-like fields flat
GET_FIELDS = (('qpos', None), ('qvel', None), ('act', 'na'), ('ctrl', 'nu'),
              ('qacc', None), ('qacc_warmstart', None), ('xpos', None),
              ('xquat', None), ('xmat', None), ('sensordata', 'nsensordata'),
              ('xipos', None), ('ximat', None), ('geom_xpos', None),
              ('geom_xmat', None), ('site_xpos', 'nsite'),
              ('site_xmat', 'nsite'), ('subtree_com', None),
              ('qfrc_bias', None), ('qfrc_passive', None),
              ('qfrc_actuator', None), ('qfrc_constraint', None),
              ('actuator_force', 'nu'), ('actuator_length', 'nu'),
              ('actuator_velocity', 'nu'), ('ten_length', 'ntendon'),
              ('ten_velocity', 'ntendon'), ('act_dot', 'na'),
              ('mocap_pos', 'nmocap'), ('mocap_quat', 'nmocap'),
              ('history', 'nhistory'))


def _asleep_cycles_to_labels(asleep: np.ndarray) -> np.ndarray:
  """MuJoCo C's sleep cycles (each asleep tree points at the next of its
  group) as group labels, the smallest tree id of the group; awake
  counters (< 0) pass through (``io.py:1245``)."""
  out = asleep.astype(np.int32).copy()
  n = len(asleep)
  for t in range(n):
    if asleep[t] < 0:
      continue
    smallest, cur = t, t
    for _ in range(n + 1):
      nxt = int(asleep[cur])
      if nxt < 0 or nxt >= n:
        break
      smallest = min(smallest, nxt)
      cur = nxt
      if cur == t:
        break
    out[t] = smallest
  return out


def _asleep_labels_to_cycles(labels: np.ndarray) -> np.ndarray:
  """The inverse of ``_asleep_cycles_to_labels``: each group linked into
  a cycle in ascending tree id (``io.py:1266``)."""
  out = labels.astype(np.int32).copy()
  n = len(labels)
  for lab in sorted(set(int(x) for x in labels if x >= 0)):
    members = sorted(int(t) for t in range(n) if labels[t] == lab)
    for i, t in enumerate(members):
      out[t] = members[(i + 1) % len(members)]
  return out


def put_data(mjm, mjd, m: types.Model, nworld: Optional[int] = None,
             dtype=None) -> types.Data:
  """Batched Data of ``nworld`` worlds, each in ``mjd``'s state
  (``io.py:1214`` ``put_data``), on the Model's device: time, qpos, qvel,
  act, ctrl, qfrc_applied, xfrc_applied, eq_active, qacc_warmstart and
  qacc, and ``tree_asleep`` as the port's group labels.  The port's Data
  is always batched: ``nworld`` None gives one world, where the JAX
  ``put_data`` gives unbatched Data.  The float fields take ``dtype``, by
  default the Model's.  Every tensor is a copy: a later change to ``mjd``
  does not reach it.  The mocap poses and the delay history come as
  MjData holds them, the history's float cursors included."""
  W = 1 if nworld is None else int(nworld)
  dev = m.qpos0.device
  d = make_data(m, W, device=dev, dtype=dtype)
  fdt = types.np_float(d.qpos.dtype)

  def put(x, dt=fdt):
    t = torch.tensor(np.array(x, dt, copy=True), device=dev)
    return t[None].repeat((W,) + (1,) * t.dim())

  kw = {k: put(getattr(mjd, k)) for k in PUT_FIELDS}
  if m.nhistory:
    kw['history'] = put(mjd.history)
  kw['eq_active'] = put(mjd.eq_active, bool)
  if m.ntree and hasattr(mjd, 'tree_asleep'):
    kw['tree_asleep'] = put(_asleep_cycles_to_labels(
        np.asarray(mjd.tree_asleep)), np.int32)
  return d.replace(**kw)


def get_data_into(mjd, mjm, d: types.Data, world: int = 0):
  """Copy world ``world`` of batched Data (on either device) into an
  MjData (``io.py:1278`` ``get_data_into``): the state, the frames, the
  forces, the mocap poses and sensordata that the JAX function copies,
  the delay history, and
  ``tree_asleep`` as MuJoCo C's sleep cycles.  A field the step has not
  computed (None) leaves ``mjd``'s as it is."""
  def one(x):
    return x[world].detach().cpu().numpy().astype(np.float64)

  mjd.time = float(one(d.time))
  if mjm.ntree and hasattr(mjd, 'tree_asleep') and \
      d.tree_asleep is not None:
    mjd.tree_asleep[:] = _asleep_labels_to_cycles(
        d.tree_asleep[world].cpu().numpy())
  for name, size in GET_FIELDS:
    x = getattr(d, name)
    if x is None or (size is not None and not getattr(mjm, size)):
      continue
    dst = getattr(mjd, name)
    dst[:] = one(x).reshape(dst.shape)


# the rotation fields, which rest at the identity (``io.py:1111-1129``)
_IDENTITY_FIELDS = {'xquat', 'xmat', 'ximat', 'geom_xmat', 'site_xmat',
                    'cam_xmat'}


def _contact_rest(m: types.Model, name: str, x: torch.Tensor
                  ) -> torch.Tensor:
  """The value the JAX ``make_data`` gives contact field ``name`` of
  world-major slots ``x`` (``io.py:1116-1146``): dist 1e10 (every row
  masked until collision fills the slot), frame the identity, geom1 and
  geom2 each slot's first candidate, cand -1 where slots are compacted
  (else the candidate id), the rest zero."""
  if name == 'dist':
    return torch.full_like(x, 1e10)
  if name == 'frame':
    return torch.eye(3, dtype=x.dtype, device=x.device).expand_as(x)
  if name not in ('geom1', 'geom2', 'cand'):
    return torch.zeros_like(x)
  if m.con_compact:
    first = np.concatenate([ci[np.minimum(np.arange(cap), len(ci) - 1)]
                            for _, cap, ci, _ in m.con_classes])
    cand = np.full(m.ncon, -1)
  else:
    first = cand = np.arange(m.ncon)
  pair = m.pair_geom1 if name == 'geom1' else m.pair_geom2
  val = cand if name == 'cand' else pair[m.con_pair[first]]
  return torch.as_tensor(np.asarray(val, np.int64), device=x.device).to(
      x.dtype).expand_as(x)


def reset_data(m: types.Model, d: types.Data, reset_mask=None
               ) -> types.Data:
  """``d`` reset to ``make_data``'s state (``io.py:1330`` ``reset_data``):
  every world (then ``make_data``'s Data, whose stage outputs are None),
  or the worlds of ``reset_mask``, a (W,) bool tensor on ``d``'s device.
  In the masked worlds every field takes the JAX ``make_data``'s value:
  the fields the port's ``make_data`` sets take its values, the port's
  ``tree_island``, ``nisland`` and the other island fields among them;
  the stage outputs (frames, forces, rows) rest at zero and the rotations
  at the identity; the contact slots as ``_contact_rest`` gives them."""
  W = d.qpos.shape[0]
  fresh = make_data(m, W, device=d.qpos.device, dtype=d.qpos.dtype)
  if reset_mask is None:
    return fresh
  mask = torch.as_tensor(reset_mask, dtype=torch.bool,
                         device=d.qpos.device).reshape(W)

  def rest(name, x):
    if name in _IDENTITY_FIELDS - {'xquat'}:
      return torch.eye(3, dtype=x.dtype, device=x.device).expand_as(x)
    out = torch.zeros_like(x)
    if name == 'xquat':
      out[..., 0] = 1.0
    return out

  def pick(obj, new_of):
    kw = {}
    for f in dataclasses.fields(obj):
      x = getattr(obj, f.name)
      if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] != W:
        continue
      kw[f.name] = torch.where(mask.reshape((W,) + (1,) * (x.dim() - 1)),
                               new_of(f.name, x), x)
    return obj.replace(**kw)

  def data_rest(name, x):
    new = getattr(fresh, name)
    return rest(name, x) if new is None else new

  out = pick(d, data_rest)
  if d.contact is not None:
    out = out.replace(contact=pick(
        d.contact, lambda name, x: _contact_rest(m, name, x)))
  return out


# the option enums ``override_model`` takes by name (``io.py:1349``)
_ENUM_VALUES = {
    'solver': {'cg': types.SolverType.CG, 'newton': types.SolverType.NEWTON},
    'integrator': {
        'euler': types.IntegratorType.EULER, 'rk4': types.IntegratorType.RK4,
        'implicit': types.IntegratorType.IMPLICIT,
        'implicitfast': types.IntegratorType.IMPLICITFAST},
}


def override_model(m: types.Model, overrides) -> types.Model:
  """``m`` with ``opt.*`` overrides (``io.py:1498`` ``override_model``),
  e.g. ``['opt.solver=cg', 'opt.iterations=20', 'opt.o_margin=0.01']``:
  enums by name or number, ints, and float fields (a vector field takes
  the value in every entry).  ``opt.cone`` raises, since the cone shapes
  the row layout.  The per-candidate contact tables are mixed again from
  the Model's geom fields (the contact override among them) in the
  Model's dtype, on its device; no ``mujoco`` is needed."""
  for ov in overrides:
    key, val = ov.split('=')
    parts = key.split('.')
    if parts[0] != 'opt' or len(parts) != 2:
      raise NotImplementedError(f'override path {key!r} not supported '
                                '(only opt.*)')
    name = parts[1]
    cur = getattr(m.opt, name)
    if name == 'cone':
      raise ValueError('opt.cone is baked into the constraint row layout at '
                       'put_model; set mjm.opt.cone before put_model')
    if name in _ENUM_VALUES and not val.lstrip('-').isdigit():
      new = int(_ENUM_VALUES[name][val.lower()])
    elif isinstance(cur, (int, bool)):
      new = type(cur)(float(val))
    else:
      new = torch.full_like(cur, float(val))
    m = m.replace(opt=m.opt.replace(**{name: new}))
  return remix(m)


# the batchable fields each output of ``set_const`` depends on (M at
# qpos0 on the masses, inertias, inertial frames, qpos0 and armature): an
# output is batched where one of them is
# the placement of bodies, joints, geoms and sites, which moves every
# frame set_const reads
_POSE = ('body_pos', 'body_quat', 'body_iquat', 'jnt_pos', 'jnt_axis',
         'geom_pos', 'geom_quat', 'site_pos', 'site_quat')
_M_INPUTS = ('body_mass', 'body_inertia', 'body_ipos', 'qpos0',
             'dof_armature', 'tendon_armature') + _POSE
_SET_CONST_DEPS = {
    'body_subtreemass': ('body_mass',),
    'dof_invweight0': _M_INPUTS, 'body_invweight0': _M_INPUTS,
    'tendon_invweight0': _M_INPUTS,
    'actuator_acc0': _M_INPUTS + ('actuator_gear', 'actuator_cranklength'),
    'tendon_length0': ('qpos0',) + _POSE,
    'tendon_lengthspring': ('tendon_lengthspring', 'qpos_spring') + _POSE,
    'eq_data': ('qpos0', 'eq_data') + _POSE,
    'actuator_biasprm': _M_INPUTS + ('actuator_gainprm', 'actuator_biasprm',
                                     'actuator_gear', 'actuator_cranklength'),
}


def _block_average(m: types.Model) -> np.ndarray:
  """(nv, nv): the mean over each joint's dof block (a ball joint's 3, a
  free joint's translational and rotational triples), as mj_setConst
  averages dof_invweight0 (``io.py:1406-1413``)."""
  avg = np.zeros((m.nv, m.nv))
  for j in range(m.njnt):
    adr, jt = int(m.jnt_dofadr[j]), int(m.jnt_type[j])
    blocks = ([(adr, 3), (adr + 3, 3)] if jt == _JT.FREE else
              [(adr, 3)] if jt == _JT.BALL else [(adr, 1)])
    for a, n in blocks:
      avg[a:a + n, a:a + n] = 1.0 / n
  return avg


def set_const(m: types.Model) -> types.Model:
  """The qpos0-derived constants of ``m`` recomputed from its fields
  (``io.py:1360`` ``set_const``): body_subtreemass, dof_invweight0 (the
  diagonal of M^-1, averaged within ball and free blocks),
  body_invweight0 (trace(J M^-1 J^T) / 3 of each body's translation and
  rotation), tendon_length0, tendon_invweight0, the automatic entries of
  tendon_lengthspring, the connect and weld anchors of eq_data,
  actuator_acc0 and the dampratio of position actuators in
  actuator_biasprm.  Call it after editing masses, inertias, qpos0 and
  the like.

  On a batched Model each world takes its own values: the position
  stages and the mass chain run at the batch's width, M^-1 comes from
  the ``chol_batched`` factor and one ``chol_solve`` per dof (the kernels
  on the card, their plain versions on the CPU), and each output that
  depends on a batched field (``_SET_CONST_DEPS``) is batched and joins
  ``batch_fields``.  In the Model's dtype, float64 included."""
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.ops import constraint, forward, math, smooth
  W = types.model_nworld(m) or 1
  dev, dt = m.qpos0.device, types.dtype_of(m)
  nv = m.nv
  wf = lambda name: types.world_field(m, name)
  out, names = {}, set(m.batch_fields)

  def put(name, x):
    """Output ``name`` from its (W, ...) value: batched where an input it
    depends on is, else world 0's."""
    if any(n in m.batch_fields for n in _SET_CONST_DEPS[name]):
      out[name] = x.expand((W,) + tuple(x.shape[1:])).contiguous()
      names.add(name)
    else:
      out[name] = x[0].contiguous()
      names.discard(name)

  def model():
    return types.set_model_fields(m, out).replace(
        batch_fields=tuple(sorted(names)))

  sub = torch.as_tensor(m.tree.subtree_mask, dtype=dt, device=dev)
  put('body_subtreemass', torch.sum(wf('body_mass')[:, None, :] * sub,
                                    dim=-1))
  m1 = model()
  d0 = forward.pre(m1, make_data(m1, W, device=dev))
  d0 = smooth.transmission(m1, kmass.mass_chain(m1, d0))
  L = klinalg.chol_batched(m1, d0.qM.contiguous())
  eye = torch.eye(nv, dtype=dt, device=dev)
  # M^-1 column by column: one chol_solve per dof
  Minv = torch.stack([klinalg.chol_solve_batched(
      m1, L, eye[j].expand(W, nv)) for j in range(nv)], dim=-1)
  avg = torch.as_tensor(_block_average(m), dtype=dt, device=dev)
  put('dof_invweight0', torch.sum(
      torch.diagonal(Minv, dim1=-2, dim2=-1)[:, None, :] * avg, dim=-1))
  jacp, jacr = constraint._jac(m1, d0, d0.xipos, np.arange(m.nbody))

  def block_w(jac):  # trace(J M^-1 J^T) / 3 per body
    JM = torch.einsum('wbvk,wvu->wbuk', jac, Minv)
    return torch.sum(JM * jac, dim=(-1, -2)) / 3.0

  put('body_invweight0', torch.stack([block_w(jacp), block_w(jacr)], -1))
  if m.ntendon:
    tJ = d0.ten_J
    put('tendon_length0', d0.ten_length)
    put('tendon_invweight0', torch.einsum('wtv,wvu,wtu->wt', tJ, Minv, tJ))
    # automatic spring ranges (-1, -1) resolve to the length at
    # qpos_spring (``io.py:1431``)
    spring = wf('tendon_lengthspring')
    auto = torch.all(spring == -1.0, dim=-1, keepdim=True)
    if bool(auto.any()):
      ds = make_data(m1, W, device=dev)
      ds = smooth.tendon(m1, smooth.kinematics(m1, ds.replace(
          qpos=wf('qpos_spring').to(dt).expand(W, m.nq).clone())))
      spring = torch.where(auto, ds.ten_length[..., None], spring)
    put('tendon_lengthspring', spring.expand(W, m.ntendon, 2))
  if m.neq:
    # connect: data[3:6] is body1's anchor in body2's frame; weld:
    # data[3:6] body2's anchor in body1's frame, data[6:10] the relative
    # quaternion unless the model set one (``io.py:1440-1472``)
    data = wf('eq_data').expand(W, m.neq, -1)
    o1 = torch.as_tensor(np.asarray(m.eq_obj1id, np.int64), device=dev)
    o2 = torch.as_tensor(np.asarray(m.eq_obj2id, np.int64), device=dev)
    body = np.asarray(m.eq_objtype) == types.ObjType.BODY
    conn = (np.asarray(m.eq_type) == types.EqType.CONNECT) & body
    weld = (np.asarray(m.eq_type) == types.EqType.WELD) & body
    xp1, xm1 = d0.xpos[:, o1], d0.xmat[:, o1]
    xp2, xm2 = d0.xpos[:, o2], d0.xmat[:, o2]
    rot = lambda mat, v: torch.sum(mat * v[..., None, :], dim=-1)
    rot_t = lambda mat, v: torch.sum(mat * v[..., :, None], dim=-2)
    a_conn = rot_t(xm2, xp1 + rot(xm1, data[..., 0:3]) - xp2)
    a_weld = rot_t(xm1, xp2 + rot(xm2, data[..., 0:3]) - xp1)
    relquat = math.mul_quat(math.quat_inv(d0.xquat[:, o1]), d0.xquat[:, o2])
    q = data[..., 6:10]
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    has_q = qq > 0.0
    qn = q / torch.sqrt(torch.clamp(qq, min=1e-15))
    is_conn = torch.as_tensor(conn, device=dev)[:, None]
    is_weld = torch.as_tensor(weld, device=dev)[:, None]
    anchor = torch.where(is_conn, a_conn, torch.where(
        is_weld & ~has_q, a_weld, data[..., 3:6]))
    quat = torch.where(is_weld, torch.where(has_q, qn, relquat),
                       data[..., 6:10])
    put('eq_data', torch.cat([data[..., 0:3], anchor, quat, data[..., 10:]],
                             dim=-1))
  if m.nu:
    mom = d0.actuator_moment
    acc = torch.einsum('wuv,wvx->wux', mom, Minv)
    put('actuator_acc0', torch.sqrt(torch.clamp(
        torch.sum(acc * acc, dim=-1), min=0.0)))
    # dampratio -> damping of position actuators (``io.py:1476-1493``)
    M0 = torch.diagonal(d0.qM, dim1=-2, dim2=-1)
    kp = wf('actuator_gainprm')[..., 0]
    bp = wf('actuator_biasprm').expand(W, m.nu, -1)
    aff = torch.as_tensor(np.asarray(m.actuator_biastype) ==
                          types.BiasType.AFFINE, device=dev)
    cond = aff & (torch.abs(kp + bp[..., 1]) <= 1e-15) & (bp[..., 2] > 0.0)
    mass = torch.sum(torch.where(
        torch.abs(mom) > 1e-15,
        M0[:, None, :] / torch.clamp(mom * mom, min=1e-30),
        torch.zeros((), dtype=dt, device=dev)), dim=-1)
    damping = bp[..., 2] * 2.0 * torch.sqrt(torch.clamp(kp * mass, min=0.0))
    put('actuator_biasprm', torch.cat([
        bp[..., :2], torch.where(cond, -damping, bp[..., 2])[..., None],
        bp[..., 3:]], dim=-1))
  return model()


def load_humanoid_benchmark():
  """The benchmark humanoid as a ``mujoco.MjModel`` (needs ``mujoco`` and
  ``dm_control``): dm_control's humanoid with sensors and cameras removed,
  the scene ``mujoco_warp_tpu.benchmarks.load_humanoid_benchmark`` loads
  where the MJWarp checkout is absent."""
  import re
  import shutil
  import tempfile

  import importlib.util

  import mujoco

  src = os.path.join(os.path.dirname(
      importlib.util.find_spec('dm_control').origin), 'suite', 'humanoid.xml')
  xml = open(src).read()
  xml = re.sub(r'<sensor>.*?</sensor>', '', xml, flags=re.S)
  xml = re.sub(r'<camera[^/]*?/>', '', xml)
  tmp = tempfile.mkdtemp(prefix='mjw_torch_bench_')
  try:
    shutil.copytree(os.path.join(os.path.dirname(src), 'common'),
                    os.path.join(tmp, 'common'))
    path = os.path.join(tmp, 'humanoid.xml')
    with open(path, 'w') as f:
      f.write(xml)
    return mujoco.MjModel.from_xml_path(path)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


def make_snapshot(path: str = SNAPSHOT) -> types.Model:
  """The benchmark humanoid, written to ``path``."""
  m = put_model(load_humanoid_benchmark(), nconmax=BENCH_NCONMAX,
                device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


def make_constraints_snapshot(path: str = CONSTRAINTS_SNAPSHOT
                              ) -> types.Model:
  """The ``constraints`` benchmark scene, written to ``path``."""
  import mujoco
  m = put_model(mujoco.MjModel.from_xml_path(CONSTRAINTS_XML), device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


def load_clutter():
  """``clutter_arm.xml`` as a ``mujoco.MjModel`` with ``opt.enableflags``
  0, the override of the benchmark ``clutter_arm_nosleep`` (needs
  ``mujoco``)."""
  import mujoco
  mjm = mujoco.MjModel.from_xml_path(CLUTTER_XML)
  mjm.opt.enableflags = 0
  return mjm


def make_clutter_snapshot(path: str = CLUTTER_SNAPSHOT) -> types.Model:
  """The ``clutter_arm_nosleep`` scene with lossless contact slots
  (``nconmax=None``), written to ``path``."""
  m = put_model(load_clutter(), nconmax=None, device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


def make_clutter_arm_snapshot(path: str = CLUTTER_ARM_SNAPSHOT
                              ) -> types.Model:
  """The ``clutter_arm`` scene (sleep on) with lossless contact slots,
  written to ``path``."""
  import mujoco
  m = put_model(mujoco.MjModel.from_xml_path(CLUTTER_XML), nconmax=None,
                device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


def make_clutter_sleep_snapshot(path: str = CLUTTER_SLEEP_SNAPSHOT
                                ) -> types.Model:
  """``clutter.xml`` (sleep on) with its contacts compacted into
  ``CLUTTER_SLEEP_NCONMAX`` slots, written to ``path``."""
  import mujoco
  m = put_model(mujoco.MjModel.from_xml_path(CLUTTER_SLEEP_XML),
                nconmax=CLUTTER_SLEEP_NCONMAX, device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


# the fields of a saved state (``save_state``); a rollout starts from them
STATE_FIELDS = ('qpos', 'qvel', 'qacc_warmstart', 'tree_asleep', 'nisland',
                'tree_island', 'dof_island', 'efc_island')


def save_state(path: str, d: types.Data, **meta):
  """The per-world fields ``STATE_FIELDS`` of ``d`` (and ``meta``, numbers
  that describe how it was made) as an npz file."""
  np.savez_compressed(path, **{k: getattr(d, k).cpu().numpy()
                               for k in STATE_FIELDS},
                      **{'meta.' + k: np.asarray(v) for k, v in meta.items()})


def load_state(path: str) -> dict:
  """A state of ``save_state``: field -> numpy array (n worlds)."""
  with np.load(path) as z:
    return {k: z[k] for k in z.files if not k.startswith('meta.')}


# how ``make_settled_state`` makes the committed settled states
SETTLE_NWORLD = 64
SETTLE_SEED = 0
SETTLE_MAX_STEPS = 2000
SETTLE_ASLEEP_SHARE = 0.95


def make_settled_state(model_path: str, path: str) -> types.Data:
  """A settled state of the sleeping scene at ``model_path``, written to
  ``path``: ``SETTLE_NWORLD`` worlds at qpos0 plus uniform noise of 1 mm
  (``SETTLE_SEED``), stepped with zero ctrl by the general step's plain
  versions on the CPU until ``SETTLE_ASLEEP_SHARE`` of the trees that may
  sleep are asleep (the steps taken go into the file).  Raises, and
  writes nothing, if that share is not reached in ``SETTLE_MAX_STEPS``."""
  from mujoco_warp_tpu_torch.ops import forward
  m = load_model_npz(model_path, device='cpu')
  d = make_data(m, SETTLE_NWORLD, device='cpu')
  rng = np.random.default_rng(SETTLE_SEED)
  noise = rng.uniform(-1e-3, 1e-3, tuple(d.qpos.shape)).astype(np.float32)
  d = d.replace(qpos=d.qpos + torch.as_tensor(noise))
  may = torch.as_tensor(np.asarray(m.tree_sleep_policy) != 1)
  for steps in range(1, SETTLE_MAX_STEPS + 1):
    d = forward.step(m, d)
    share = float((d.tree_asleep[:, may] >= 0).float().mean())
    if steps % 10 == 0 and share >= SETTLE_ASLEEP_SHARE:
      save_state(path, d, steps=steps, seed=SETTLE_SEED)
      return d
  raise RuntimeError(
      f'{model_path}: {share:.3f} of the trees that may sleep are asleep '
      f'after {SETTLE_MAX_STEPS} steps, short of {SETTLE_ASLEEP_SHARE}')


def make_task_start(name: str, path: str) -> types.Data:
  """The seeded contact state of the elliptic-cone task ``name`` of
  ``TASK_STARTS``, ``TASK_START_NWORLD`` worlds, written to ``path``:
  ``parity.task_state`` (seed 0) for manipulator and stacker, whose qpos0
  holds their objects in the air, and ``parity.touching`` (seed 0) for
  finger_cg, whose tip is off its spinner at qpos0; zero ctrl."""
  from mujoco_warp_tpu_torch import parity
  n = TASK_START_NWORLD
  if name == 'finger_cg':
    m = load_model_npz(CLASSIC_SNAPSHOTS['finger'], device='cpu')
    qpos, qvel, _ = parity.touching(m, 0, n)
  else:
    m = load_model_npz(TASK_SNAPSHOTS[name], device='cpu')
    qpos, qvel, _ = parity.task_state(m, n, 0)
  d = make_data(m, n, device='cpu').replace(qpos=torch.as_tensor(qpos),
                                            qvel=torch.as_tensor(qvel))
  save_state(path, d, seed=0)
  return d


def load_spheres(cone: int = types.ConeType.PYRAMIDAL):
  """``spheres.xml`` as a ``mujoco.MjModel`` with ``opt.cone`` set to
  ``cone``, as the JAX ``benchmarks.build`` sets it before ``put_model``
  (needs ``mujoco``)."""
  import mujoco
  mjm = mujoco.MjModel.from_xml_path(SPHERES_XML)
  mjm.opt.cone = int(cone)
  return mjm


def make_spheres_snapshot(cone: int = types.ConeType.PYRAMIDAL,
                          path: Optional[str] = None,
                          solver: int = types.SolverType.NEWTON
                          ) -> types.Model:
  """The ``spheres`` (pyramidal), ``spheres_elliptic`` or (with the CG
  ``solver``) ``spheres_cg`` scene with lossless contact slots
  (``nconmax=None``), written to ``path`` (by default its committed
  snapshot)."""
  if path is None:
    path = SPHERES_ELLIPTIC_SNAPSHOT if cone == types.ConeType.ELLIPTIC \
        else SPHERES_CG_SNAPSHOT if solver == types.SolverType.CG \
        else SPHERES_SNAPSHOT
  mjm = load_spheres(cone)
  mjm.opt.solver = int(solver)
  m = put_model(mjm, nconmax=None, device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


def escape_terrain(mjm, seed: int = ESCAPE_SEED) -> np.ndarray:
  """Quadruped escape's terrain heights (nrow * ncol,), as its task's
  ``initialize_episode`` draws them (``dm_control/suite/quadruped.py``
  ``Escape``, :369-384) from a ``RandomState(seed)``: a sinusoidal bowl
  times smooth random bumps, without the rendering context that the
  task's call asks for (needs ``scipy`` and ``dm_control``)."""
  from dm_control.suite import quadruped
  from scipy import ndimage
  res = int(mjm.hfield_nrow[0])
  row_grid, col_grid = np.ogrid[-1:1:res * 1j, -1:1:res * 1j]
  radius = np.clip(np.sqrt(col_grid ** 2 + row_grid ** 2), .04, 1)
  bowl = .5 - np.cos(2 * np.pi * radius) / 2
  bump_res = int(2 * mjm.hfield_size[0, 0] / quadruped._TERRAIN_BUMP_SCALE)
  bumps = np.random.RandomState(seed).uniform(
      quadruped._TERRAIN_SMOOTHNESS, 1, (bump_res, bump_res))
  return (bowl * ndimage.zoom(bumps, res / float(bump_res))).ravel()


def load_dmc(name: str):
  """A dm_control suite scene of ``DMC_NCONMAX``, ``TENDON_DMC``,
  ``CLASSIC_DMC``, ``TASK_DMC``, ``ACT_DMC`` or ``FLUID_DMC`` as a
  ``mujoco.MjModel`` with its sensors, cameras and lights, from the XML in
  the installed ``dm_control`` (needs ``mujoco`` and ``dm_control``);
  quadruped escape with its seeded terrain (``escape_terrain``)."""
  import importlib
  import importlib.util

  import mujoco
  if name in ACT_DMC or name in FLUID_DMC:
    from dm_control import suite
    mjm = suite.load(*{**ACT_DMC, **FLUID_DMC}[name]).physics.model.ptr
    if name == 'quadruped_escape':
      adr, n = int(mjm.hfield_adr[0]), int(mjm.hfield_nrow[0] *
                                          mjm.hfield_ncol[0])
      mjm.hfield_data[adr:adr + n] = escape_terrain(mjm)
    return mjm
  if name in TASK_DMC:
    module, kw = TASK_DMC[name]
    xml, assets = importlib.import_module(
        f'dm_control.suite.{module}').make_model(**kw)
    return mujoco.MjModel.from_xml_string(xml, assets)
  suite = os.path.join(os.path.dirname(
      importlib.util.find_spec('dm_control').origin), 'suite')
  xml = 'humanoid' if name == 'humanoid_dmc' else name
  return mujoco.MjModel.from_xml_path(os.path.join(suite, f'{xml}.xml'))


def make_dmc_snapshot(name: str, path: Optional[str] = None) -> types.Model:
  """The dm_control scene ``name`` at its contact budget (``DMC_NCONMAX``;
  the others ``put_model``'s default), written to ``path`` (by default its
  committed snapshot)."""
  if path is None:
    path = {**DMC_SNAPSHOTS, **TENDON_SNAPSHOTS, **CLASSIC_SNAPSHOTS,
            **TASK_SNAPSHOTS, **ACT_SNAPSHOTS, **FLUID_SNAPSHOTS}[name]
  m = put_model(load_dmc(name), nconmax=DMC_NCONMAX.get(name),
                device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


def make_xml_snapshot(xml: str, path: str) -> types.Model:
  """The scene of the MJCF file ``xml`` (default contact slots), written
  to ``path``."""
  import mujoco
  m = put_model(mujoco.MjModel.from_xml_path(xml), device='cpu')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  save_model_npz(path, m)
  return m


def snapshot_makers() -> tuple:
  """(committed snapshot path, maker) of every committed scene; each maker
  takes the path to write."""
  xml = lambda path: lambda p: make_xml_snapshot(path, p)
  spheres = lambda cone, solver=types.SolverType.NEWTON: \
      lambda p: make_spheres_snapshot(cone, p, solver)
  dmc = lambda name: lambda p: make_dmc_snapshot(name, p)
  return ((SNAPSHOT, make_snapshot),
          (CONSTRAINTS_SNAPSHOT, make_constraints_snapshot),
          (CLUTTER_SNAPSHOT, make_clutter_snapshot),
          (SPHERES_SNAPSHOT, spheres(types.ConeType.PYRAMIDAL)),
          (SPHERES_ELLIPTIC_SNAPSHOT, spheres(types.ConeType.ELLIPTIC)),
          (EQ_JOINT_SNAPSHOT, xml(EQ_JOINT_XML)),
          (IMPLICITFAST_SNAPSHOT, xml(IMPLICITFAST_XML))) + tuple(
              (DMC_SNAPSHOTS[name], dmc(name)) for name in DMC_NCONMAX) + (
          (CLUTTER_ARM_SNAPSHOT, make_clutter_arm_snapshot),
          (SPHERES_CG_SNAPSHOT, spheres(types.ConeType.PYRAMIDAL,
                                        types.SolverType.CG)),
          (CLUTTER_SLEEP_SNAPSHOT, make_clutter_sleep_snapshot)) + tuple(
              (TENDON_SNAPSHOTS[name], dmc(name)) for name in TENDON_DMC) + \
      tuple((TENDON_SNAPSHOTS[name], xml(path))
            for name, path in TENDON_XML.items()) + tuple(
              (CLASSIC_SNAPSHOTS[name], dmc(name)) for name in CLASSIC_DMC) + \
      tuple((TASK_SNAPSHOTS[name], dmc(name)) for name in TASK_DMC) + \
      tuple((ACT_SNAPSHOTS[name], dmc(name)) for name in ACT_DMC) + \
      tuple((ACT_SNAPSHOTS[name], xml(path)) for name, path in
            ACT_XML.items()) + \
      tuple((FLUID_SNAPSHOTS[name], dmc(name)) for name in FLUID_DMC) + \
      tuple((FLUID_SNAPSHOTS[name], xml(path)) for name, path in
            FLUID_XML.items()) + \
      tuple((ARM_SNAPSHOTS[name], xml(path)) for name, path in
            ARM_XML.items())


def main(argv: Optional[list] = None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--snapshot', action='store_true',
                 help='regenerate assets/humanoid_bench.npz, '
                 'assets/constraints.npz, assets/clutter_arm_nosleep.npz, '
                 'assets/spheres.npz, assets/spheres_elliptic.npz, '
                 'assets/eq_joint.npz, assets/implicitfast.npz, the '
                 'dm_control scenes assets/walker.npz, cheetah.npz, '
                 'hopper.npz and humanoid_dmc.npz, assets/clutter_arm.npz, '
                 'assets/spheres_cg.npz and assets/clutter.npz, the tendon '
                 'scenes assets/ball_in_cup.npz, point_mass.npz, '
                 'sensors2.npz, tendon_wrap.npz and tendon_mix.npz, '
                 'dm_control\'s pendulum.npz, reacher.npz, finger.npz, '
                 'cartpole.npz, acrobot.npz and humanoid_CMU.npz, '
                 'manipulator_insert_peg.npz, stack_2.npz and stack_4.npz, '
                 'the actuation scenes quadruped.npz, dog.npz, '
                 'dcmotor.npz, transmission.npz and actuator_mix.npz, '
                 'the fluid, ray and height-field scenes swimmer6.npz, '
                 'swimmer15.npz, fish.npz, quadruped_escape.npz (its '
                 'terrain seeded), sensors.npz, contact_sensor.npz, '
                 'fluid_ellipsoid.npz and geomdist.npz, the mocap '
                 'scene mocap_arm.npz, '
                 'the elliptic-cone tasks\' start states '
                 'assets/*_start.npz, and '
                 '(with --settle) the settled states '
                 'assets/clutter_arm_settled.npz and '
                 'assets/clutter_settled.npz')
  p.add_argument('--settle', action='store_true',
                 help='also remake the settled states (the plain general '
                 'step on the CPU, minutes)')
  args = p.parse_args(argv)
  if not args.snapshot:
    p.error('nothing to do (pass --snapshot)')
  for path, make in snapshot_makers():
    m = make(path)
    print(f'wrote {path}: nq {m.nq} nv {m.nv} nbody {m.nbody} '
          f'ncand {m.ncand} ncon {m.ncon} nefc {m.nefc}')
  for name, path in TASK_STARTS.items():
    d = make_task_start(name, path)
    print(f'wrote {path}: {d.qpos.shape[0]} worlds')
  if args.settle:
    for model_path, path in ((CLUTTER_ARM_SNAPSHOT, CLUTTER_ARM_SETTLED),
                             (CLUTTER_SLEEP_SNAPSHOT, CLUTTER_SETTLED)):
      d = make_settled_state(model_path, path)
      print(f'wrote {path}: {d.qpos.shape[0]} worlds, trees asleep '
            f'{float((d.tree_asleep >= 0).float().mean()):.3f}')


if __name__ == '__main__':
  main()
