"""Which Model fields ``io.batch_model`` takes per world, field by field,
against the JAX batched step (``mujoco_warp_tpu/ops/forward.py:653-671``
vmaps the one-world step over ``m.batch_fields``).

Every float field of the JAX Model is one case, and each asserts one of
four things:

- the port batches it (``io.BATCHABLE``): distinct values in two worlds
  land in the Model's batched field on a scene that holds the field;
- the port refuses it where the JAX step reads it on the host
  (``io.HOST_READ``): on a scene that reads it the port's message names
  that read, and the JAX batched step fails to trace with the field
  batched (tracing only);
- both packages refuse it as static structure (``_NO_BATCH``, JAX
  ``io.py:1004``);
- the port refuses it as not ported (``io._NOT_PORTED``), naming the
  ROADMAP queue-1 item that ports it.

Each case also holds ROADMAP's queue-1 field table to the same verdict, so
that the table and ``io.BATCHABLE`` cannot part.

Per-world tolerances in the solves: with ``opt.tolerance``,
``opt.ls_tolerance`` (and for elliptic cones ``opt.impratio``) drawn per
world, each world of the plain version of the solve kernel
(``solver_ref.solve_tiles``, pyramidal on the constraints scene, elliptic
on spheres_elliptic), of the torch Newton and of CG (``ops/solver.py``)
equals, to the bit, the solve of the unbatched Model with that world's
values (the worlds of one solve do not share a stop test).

Cache hygiene (no ``kernels.TableCache`` holds a value drawn per world):
tendon armature that is 0 in one world and set in the others gives each
world its own unbatched step (its bias plan and the mass chain's form
follow any world's armature), and the rollout's sort keeps every drawn
field of ``quadruped_dr`` at 8 worlds with its world.
"""

import functools
import os
import re

import jax
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu import types as jtypes
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import benchmarks, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.kernels import lanes
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from mujoco_warp_tpu_torch.ops import solver as osolver
from tests.test_torch_batch_model import close_world, world_model
from tests.torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODELS = os.path.join(_REPO, 'mujoco_warp_tpu', 'models')

# a mesh geom that falls onto a plane: the JAX step reads its vertices on
# the host (the port has no meshes)
_MESH = """<mujoco><asset><mesh name="c" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/>
</asset><worldbody><geom type="plane" size="2 2 .1"/><body pos="0 0 0.3">
<freejoint/><geom type="mesh" mesh="c"/></body></worldbody></mujoco>"""

# the scene (an MJCF path, or a snapshot of the port's ``io``) on which
# each field is read, where constraints.xml does not read it
_XML = {
    'constraints': os.path.join(_MODELS, 'constraints.xml'),
    'clutter': os.path.join(_MODELS, 'clutter.xml'),
    'dcmotor': os.path.join(_MODELS, 'dcmotor.xml'),
    'transmission': os.path.join(_MODELS, 'transmission.xml'),
    'fluid_ellipsoid': os.path.join(tio._ASSETS, 'fluid_ellipsoid.xml'),
    'mocap_arm': os.path.join(tio._ASSETS, 'mocap_arm.xml'),
    'camlight': os.path.join(tio._ASSETS, 'camlight.xml'),
    'tendon_mix': os.path.join(tio._ASSETS, 'tendon_mix.xml'),
    'actuator_mix': os.path.join(tio._ASSETS, 'actuator_mix.xml'),
    'sensors_general': os.path.join(tio._ASSETS, 'sensors_general.xml'),
}
_SCENE = {
    **{f: 'fluid_ellipsoid' for f in ('opt.wind', 'opt.density',
                                      'opt.viscosity', 'geom_fluid')},
    **{f: 'clutter' for f in ('opt.sleep_tolerance', 'dof_length')},
    **{f: 'mocap_arm' for f in ('body_gravcomp', 'jnt_actfrcrange',
                                'sensor_delay', 'sensor_interval',
                                'actuator_delay')},
    **{f: 'camlight' for f in ('cam_pos', 'cam_quat', 'cam_poscom0',
                               'cam_pos0', 'cam_mat0', 'light_pos',
                               'light_dir', 'light_poscom0', 'light_pos0',
                               'light_dir0')},
    **{f: 'sensors_general' for f in ('cam_fovy', 'cam_intrinsic',
                                      'cam_sensorsize', 'opt.magnetic',
                                      'site_size')},
    **{f: 'actuator_mix' for f in ('actuator_actrange',
                                   'actuator_lengthrange',
                                   'actuator_length0')},
    'actuator_cranklength': 'transmission',
    **{f: 'dcmotor' for f in ('actuator_dynprm', 'actuator_gainprm',
                              'actuator_biasprm')},
    'hfield_size': 'hfield', 'hfield_data': 'hfield',
}


def _jax_floats():
  """The float array fields of the JAX Model (``opt.``-dotted)."""
  m = _jax_model('constraints')
  out = []
  for name in jtypes.Model.__dataclass_fields__:
    x = getattr(m, name)
    if name == 'opt':
      out += ['opt.' + k for k in m.opt.__dataclass_fields__
              if np.issubdtype(np.asarray(getattr(m.opt, k)).dtype,
                               np.floating)
              and not isinstance(getattr(m.opt, k), (bool, int, float))]
    elif hasattr(x, 'dtype') and np.issubdtype(x.dtype, np.floating):
      out.append(name)
  return out


@functools.lru_cache(maxsize=None)
def _mjm(scene):
  if scene == 'mesh':
    return mujoco.MjModel.from_xml_string(_MESH)
  return mujoco.MjModel.from_xml_path(_XML[scene])


@functools.lru_cache(maxsize=None)
def _jax_model(scene):
  return jio.put_model(_mjm(scene))


@functools.lru_cache(maxsize=None)
def _port_model(scene):
  if scene == 'hfield':
    return tio.load_model_npz(tio.FLUID_SNAPSHOTS['quadruped_escape'],
                              device='cpu')
  return tio.put_model(_mjm(scene), device='cpu')


def _two_worlds(base):
  """(2, ...) distinct values from ``base``: itself, then scaled."""
  base = np.asarray(base, np.float64)
  return np.stack([base, base * 1.05 + 0.01])


@functools.lru_cache(maxsize=None)
def _roadmap_table():
  """ROADMAP queue 1's field table: {field: verdict}."""
  text = open(os.path.join(_REPO, 'ROADMAP.md')).read()
  return {m.group(1): m.group(2).strip() for m in re.finditer(
      r'^\s*\| `([a-z_.0-9]+)` \| ([^|]+) \|', text, re.M)}


def _jax_traces(scene, name):
  """Does the JAX batched step trace with ``name`` batched (distinct
  values in two worlds) on ``scene``?"""
  mj = _jax_model(scene)
  mb = jio.batch_model(mj, 2, {name: _two_worlds(
      jtypes.get_model_field(mj, name))})
  d = jio.make_data(mb, nworld=2)
  try:
    jax.eval_shape(lambda dd: jfwd.step(mb, dd), d)
  except (jax.errors.TracerArrayConversionError,
          jax.errors.ConcretizationTypeError):
    return False
  return True


FIELDS = _jax_floats()


def test_every_float_field_has_a_case():
  """The 110 float fields of the JAX Model: the 32 the port batched
  before (or refuses as static), the 78 this table settles."""
  assert len(FIELDS) == 110
  assert set(FIELDS) >= tio.BATCHABLE - {'geom_priority'}
  assert set(FIELDS) >= set(tio.HOST_READ) | set(tio._NOT_PORTED) | \
      tio._NO_BATCH


@pytest.mark.parametrize('name', FIELDS)
def test_field(name):
  verdict = _roadmap_table().get(name)
  assert verdict is not None, f'{name}: no row in ROADMAP queue 1'
  if name in tio._NO_BATCH:
    m = _port_model('constraints')
    val = _two_worlds(types.host(types.get_model_field(m, name)))
    with pytest.raises(NotImplementedError, match='static'):
      tio.batch_model(m, 2, {name: val})
    with pytest.raises(NotImplementedError):
      jio.batch_model(_jax_model('constraints'), 2, {name: val})
    assert verdict.startswith('refused: static'), verdict
    return
  if name in tio._NOT_PORTED:
    item = re.search(r'queue 1 item \d', tio._NOT_PORTED[name]).group(0)
    with pytest.raises(NotImplementedError,
                       match=f'{re.escape(name)}: not ported.*{item}'):
      tio.batch_model(_port_model('constraints'), 2,
                      {name: np.zeros((2, 1))})
    assert verdict.startswith('refused: not ported') and \
        item.replace('queue 1 ', '') in verdict, verdict
    if name == 'mesh_vert':  # the JAX step reads it on the host too
      assert not _jax_traces('mesh', name)
    return
  scene = _SCENE.get(name, 'constraints')
  m = _port_model(scene)
  val = _two_worlds(types.host(types.get_model_field(m, name)))
  if name in tio.HOST_READ and tio.host_read(
      m.replace(batch_fields=(name,)), name):
    where = tio.HOST_READ[name][1].split(' ')[0]
    with pytest.raises(NotImplementedError, match=re.escape(where)):
      tio.batch_model(m, 2, {name: val})
    assert not _jax_traces(scene, name), f'{name}: JAX traces it'
    assert verdict.startswith('refused: JAX reads it on the host') and \
        where in verdict, verdict
    return
  assert name in tio.BATCHABLE
  mb = tio.batch_model(m, 2, {name: val})
  assert name in mb.batch_fields
  got = types.get_model_field(mb, name)
  assert got.shape[0] == 2 and torch.equal(
      got, torch.as_tensor(val, dtype=got.dtype)), name
  assert verdict.startswith('batched'), verdict


# per-world solver scalars of the solve tests: 4 worlds, each its own
_TOLS = {'opt.tolerance': np.asarray([1e-6, 3e-5, 1e-4, 1e-3]),
         'opt.ls_tolerance': np.asarray([0.01, 0.005, 0.05, 0.02]),
         'opt.impratio': np.asarray([1.0, 2.0, 4.0, 1.5])}


def _solve_state(name, keys):
  """(batched Model, Data before the solve) of scene ``name`` at 4
  worlds of its seeded contact state, ``keys`` of ``_TOLS`` batched."""
  m = benchmarks.load_scene(name, device='cpu')[0]
  state = {'constraints': parity.general_state,
           'spheres_elliptic': parity.spheres_state,
           'spheres_cg': parity.spheres_state}[name]
  qpos, qvel, ctrl = state(m, 4, 5)
  mb = tio.batch_model(m, 4, {k: _TOLS[k] for k in keys})
  d = tio.make_data(mb, 4, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  return mb, forward.mid(mb, kmass.mass_chain(mb, forward.pre(mb, d)))


def _plain_solve(m, d):
  return solver_ref.solve_tiles(
      m, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
      lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
      lanes(d.qacc_warmstart), solver_ref.ell_scales(m, d.contact.friction)
      if solver_ref.ell_groups(m) else None)


@pytest.mark.parametrize('name,keys', [
    ('constraints', ('opt.tolerance', 'opt.ls_tolerance')),
    ('spheres_elliptic', ('opt.tolerance', 'opt.ls_tolerance',
                          'opt.impratio'))])
def test_plain_solve_stops_each_world_on_its_own_tolerance(name, keys):
  mb, d = _solve_state(name, keys)
  got = _plain_solve(mb, d)
  wants = [_plain_solve(world_model(mb, w), d) for w in range(4)]
  for w, want in enumerate(wants):
    for a, b, what in zip(got, want, ('qacc', 'efc_force', 'qfrc', 'niter')):
      assert torch.equal(a[:, w], b[:, w]), f'{name} world {w}: {what}'
  # the draws reach the solve: the loosest world's values (tolerance
  # 1e-3) in every world move another world's qacc
  assert any(not torch.equal(got[0][:, w], wants[3][0][:, w])
             for w in range(3))


@pytest.mark.parametrize('name', ('constraints', 'spheres_cg'))
def test_torch_solvers_stop_each_world_on_its_own_tolerance(name):
  """The torch Newton (on the constraints system) and CG (spheres_cg):
  each world equals the solve of its own unbatched Model."""
  mb, d = _solve_state(name, ('opt.tolerance', 'opt.ls_tolerance'))
  got = osolver.solve(mb, d)
  for w in range(4):
    want = osolver.solve(world_model(mb, w), d)
    for k in ('qacc', 'efc_force', 'solver_niter'):
      assert torch.equal(getattr(got, k)[w], getattr(want, k)[w]), \
          f'{name} world {w}: {k}'


def test_tendon_armature_in_some_worlds():
  """tendon_mix with its tendons' armature in worlds 1 and 2 and none in
  world 0: each world against the unbatched step of its own values (world
  0's takes the small-tree mass chain, the batch the large-tree form)."""
  m = benchmarks.load_scene('tendon_mix', device='cpu')[0]
  arm = np.repeat(types.host(m.tendon_armature)[None], 3, 0)
  assert np.any(arm > 0)
  arm[0] = 0.0
  arm[2] *= 2.0
  mb = tio.set_const(tio.batch_model(m, 3, {'tendon_armature': arm}))
  qpos, qvel, ctrl = parity.general_state(m, 3, 3)
  d = tio.make_data(m, 3, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  got = forward.step(mb, d)
  assert not kmass.factor_in_kernel(mb)
  assert kmass.factor_in_kernel(world_model(mb, 0))
  for w in range(3):
    dw = forward.step(world_model(mb, w), d)
    close_world(got.qacc[w:w + 1], dw.qacc[w:w + 1], f'qacc of world {w}')
    close_world(got.qpos[w:w + 1], dw.qpos[w:w + 1], f'qpos of world {w}',
                True)


def test_sort_keeps_quadruped_dr_fields_with_their_worlds():
  """quadruped_dr at 8 worlds from the quadruped's seeded contact state:
  the Model ``benchmarks.run`` returns holds every drawn field at the
  world ids it returns, and a run sorted by a reversing permutation
  equals the unsorted run once the order is undone, where the same sort
  with the parameters left in place does not."""
  mb, W = benchmarks.load_scene('quadruped_dr', device='cpu', nworld=8)
  m0 = benchmarks.load_scene('quadruped', device='cpu')[0]
  qpos, qvel, _ = parity.dmc_state(m0, 'quadruped', W, 0)
  res = benchmarks.run(mb, W, nstep=8, warmup_steps=1, device='cpu',
                       init_state={'qpos': qpos, 'qvel': qvel})
  st, mw0, ids = res['state'], res['model'], res['world_ids']
  assert res['overflow_worlds'] == 0
  for n in mb.batch_fields:
    assert torch.equal(types.get_model_field(mw0, n),
                       types.get_model_field(mb, n)[ids]), n
  d0 = types.carried(st)
  flip = torch.arange(W - 1, -1, -1)

  def run(perm_model):
    d = types.map_worlds(d0, lambda x: x[flip], W)
    mw = types.map_model_worlds(mw0, lambda x: x[flip]) if perm_model \
        else mw0
    for _ in range(3):
      d = forward.step(mw, d)
    return d.qpos[flip]

  plain = d0
  for _ in range(3):
    plain = forward.step(mw0, plain)
  close_world(run(True), plain.qpos, 'qpos, sorted with the parameters',
              True)
  with pytest.raises(AssertionError):
    close_world(run(False), plain.qpos, 'qpos, parameters left behind',
                True)
