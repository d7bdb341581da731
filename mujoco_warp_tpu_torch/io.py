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
# more candidate pairs than this and no budget given: the default budget
# (``io.py:653-654``)
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
      elif kind == 'array':
        out[prefix + name] = types.host(val, np.float32)
      else:
        out[prefix + name] = val
  put(m, types.Model, '')
  return out


def model_from_numpy(d: dict, device=None) -> types.Model:
  """The port's Model from the JAX Model's fields as numpy values.

  ``d`` maps each field name (``'opt.timestep'`` for nested fields) to a
  numpy array, or to a python value for sizes, flags and the static tuple
  tables (``pair_groups``, ``con_classes``, ``tree.body_levels``).
  """
  device = resolve_device(device)

  def build(cls, prefix):
    kw = {}
    for name, kind in types.field_kinds(cls).items():
      if kind == 'node':
        kw[name] = build(_NESTED[name], name + '.')
        continue
      val = d[prefix + name]
      if kind == 'array':
        kw[name] = torch.tensor(np.asarray(val, np.float32), device=device)
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
  np.savez_compressed(path, **_encode(model_to_numpy(m)))


def load_model_npz(path: str = SNAPSHOT, device=None) -> types.Model:
  with np.load(path) as z:
    return model_from_numpy(_decode(z), device=device)


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


def _mix_params(mjm, g1, g2):
  """Per-candidate mixed contact params in float32 numpy
  (``collision_driver.py:250`` ``_mix_params``, host form)."""
  f32 = lambda x: np.asarray(x, np.float32)
  dtype = np.float32
  p1, p2 = mjm.geom_priority[g1], mjm.geom_priority[g2]
  use1 = (p1 > p2).astype(dtype)[:, None]
  use2 = (p2 > p1).astype(dtype)[:, None]
  eq = 1.0 - use1 - use2
  s1, s2 = f32(mjm.geom_solmix)[g1], f32(mjm.geom_solmix)[g2]
  mix = s1 / np.maximum(s1 + s2, 1e-12)
  mix = np.where((s1 < 1e-12) & (s2 < 1e-12), 0.5, mix)
  mix = np.where((s1 < 1e-12) & (s2 >= 1e-12), 0.0, mix)
  mix = np.where((s1 >= 1e-12) & (s2 < 1e-12), 1.0, mix)
  mix = (eq[:, 0] * mix + use1[:, 0] * 1.0 + use2[:, 0] * 0.0)[:, None]
  sr1, sr2 = f32(mjm.geom_solref)[g1], f32(mjm.geom_solref)[g2]
  standard = (sr1[:, [0]] > 0) & (sr2[:, [0]] > 0)
  solref = np.where(standard, mix * sr1 + (1 - mix) * sr2,
                    np.minimum(sr1, sr2))
  solimp = mix * f32(mjm.geom_solimp)[g1] + \
      (1 - mix) * f32(mjm.geom_solimp)[g2]
  margin = np.maximum(f32(mjm.geom_margin)[g1], f32(mjm.geom_margin)[g2])
  gap = np.maximum(f32(mjm.geom_gap)[g1], f32(mjm.geom_gap)[g2])
  f1, f2 = f32(mjm.geom_friction)[g1], f32(mjm.geom_friction)[g2]
  fr3 = eq * np.maximum(f1, f2) + use1 * f1 + use2 * f2
  friction = np.stack(
      [fr3[:, 0], fr3[:, 0], fr3[:, 1], fr3[:, 2], fr3[:, 2]], axis=-1)
  return solref, solimp, margin - gap, friction


def put_model(mjm, nconmax=None, device=None) -> types.Model:
  """A ``mujoco.MjModel`` as the port's Model (``io.py:585`` ``put_model``,
  float32).

  ``nconmax``: per-world active-contact budget, an int or a
  ``{condim: budget}`` dict; below the candidate count, active contacts
  are compacted into the budgeted slots each step.  Without one, the
  model's ``<numeric name="nconmax">`` sets it, and failing that a model
  of more than ``LOSSLESS_MAX_CAND`` candidates takes ``_default_nconmax``
  (``io.py:616-661``).  Raises for a model that neither the fused step nor
  the general step supports yet.
  """
  device = resolve_device(device)
  if mjm.opt.solver == 0:
    raise NotImplementedError('PGS solver is not supported')
  if mjm.opt.enableflags & types.EnableBit.OVERRIDE:
    raise NotImplementedError('contact override runs on the general path')
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
  if ncand:
    solref, solimp, imargin, friction = _mix_params(
        mjm, g1[con_pair], g2[con_pair])
  else:
    solref = np.zeros((0, types.NREF), np.float32)
    solimp = np.zeros((0, types.NIMP), np.float32)
    imargin = np.zeros(0, np.float32)
    friction = np.zeros((0, 5), np.float32)
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
      # f32 models floor the tolerance at 1e-6 (io.py:610)
      'opt.timestep': o.timestep, 'opt.impratio': o.impratio,
      'opt.tolerance': max(float(o.tolerance), 1e-6),
      'opt.ls_tolerance': o.ls_tolerance, 'opt.gravity': o.gravity,
      'opt.magnetic': o.magnetic,
      'opt.density': o.density, 'opt.viscosity': o.viscosity,
      'opt.sleep_tolerance': o.sleep_tolerance,
      'opt.integrator': int(o.integrator), 'opt.cone': int(o.cone),
      'opt.solver': int(o.solver), 'opt.iterations': int(o.iterations),
      'opt.ls_iterations': int(o.ls_iterations),
      'opt.disableflags': int(o.disableflags),
      'opt.enableflags': int(o.enableflags),
      'opt.run_collision_detection': True,
      'stat.meaninertia': mjm.stat.meaninertia,
      'con_dim': slot_dim, 'con_efc_address': con_adr, 'pair_geom1': g1, 'pair_geom2': g2,
      'con_pair': con_pair, 'pair_groups': groups,
      'cand_friction': friction, 'cand_solref': solref,
      'cand_solimp': solimp, 'cand_includemargin': imargin,
      'cam_mat0': np.asarray(mjm.cam_mat0).reshape(-1, 3, 3),
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
  m = model_from_numpy(d, device=device)
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


def make_data(m: types.Model, nworld: int, device=None) -> types.Data:
  """A batch of worlds at qpos0 and rest (``io.py:1076`` ``make_data``):
  every tree awake (``K_AWAKE``, ``io.py:1198-1202``), no island."""
  dev = resolve_device(device)
  f32 = dict(dtype=torch.float32, device=dev)
  z = lambda *shape: torch.zeros((nworld,) + shape, **f32)
  i32 = lambda fill, *shape: torch.full((nworld,) + shape, fill,
                                        dtype=torch.int32, device=dev)
  qpos = m.qpos0.to(**f32)
  eq0 = torch.as_tensor(np.asarray(m.eq_active0, bool).reshape(-1),
                        device=dev)
  return types.Data(
      time=z(), qpos=qpos[None].repeat(nworld, 1), qvel=z(m.nv),
      act=z(m.na), ctrl=z(m.nu), qfrc_applied=z(m.nv),
      xfrc_applied=z(m.nbody, 6), eq_active=eq0[None].repeat(nworld, 1),
      qacc_warmstart=z(m.nv), qacc=z(m.nv),
      energy=z(2), sensordata=z(m.nsensordata),
      solver_niter=i32(0), overflow=i32(0),
      tree_asleep=i32(types.K_AWAKE, m.ntree), nisland=i32(0),
      tree_island=i32(-1, m.ntree), dof_island=i32(-1, m.nv),
      efc_island=i32(-1, m.nefc))


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


def load_dmc(name: str):
  """A dm_control suite scene of ``DMC_NCONMAX``, ``TENDON_DMC`` or
  ``CLASSIC_DMC`` as a
  ``mujoco.MjModel`` with its sensors, cameras and lights, from the XML in
  the installed ``dm_control`` (needs ``mujoco`` and ``dm_control``)."""
  import importlib.util

  import mujoco
  suite = os.path.join(os.path.dirname(
      importlib.util.find_spec('dm_control').origin), 'suite')
  xml = 'humanoid' if name == 'humanoid_dmc' else name
  return mujoco.MjModel.from_xml_path(os.path.join(suite, f'{xml}.xml'))


def make_dmc_snapshot(name: str, path: Optional[str] = None) -> types.Model:
  """The dm_control scene ``name`` at its contact budget (``DMC_NCONMAX``;
  the others ``put_model``'s default), written to ``path`` (by default its
  committed snapshot)."""
  if path is None:
    path = {**DMC_SNAPSHOTS, **TENDON_SNAPSHOTS, **CLASSIC_SNAPSHOTS}[name]
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
              (CLASSIC_SNAPSHOTS[name], dmc(name)) for name in CLASSIC_DMC)


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
                 'cartpole.npz, acrobot.npz and humanoid_CMU.npz, and '
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
  if args.settle:
    for model_path, path in ((CLUTTER_ARM_SNAPSHOT, CLUTTER_ARM_SETTLED),
                             (CLUTTER_SLEEP_SNAPSHOT, CLUTTER_SETTLED)):
      d = make_settled_state(model_path, path)
      print(f'wrote {path}: {d.qpos.shape[0]} worlds, trees asleep '
            f'{float((d.tree_asleep >= 0).float().mean()):.3f}')


if __name__ == '__main__':
  main()
