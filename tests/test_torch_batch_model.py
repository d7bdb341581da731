"""Per-world model parameters on the general step: ``io.batch_model``
(``mujoco_warp_tpu/io.py:1013``) and the batch branch of
``forward.step`` (``mujoco_warp_tpu/ops/forward.py:653-671``).

- The four cases of ``tests/test_batch_model.py``, each held against the
  JAX ``batch_model`` + ``forward.step`` (jitted, its vmapped jnp step on
  the CPU) and against the port's unbatched steps: per-world gravity on
  pendula (qacc within the JAX test's rtol 1e-5, atol 1e-6 of each
  world's unbatched port step at the same width, and within parity's
  qacc bar of the JAX step), damping of batch 2 tiled to 4 worlds, low
  friction on spheres reaching the contacts, and the errors for bad
  shapes.
- Every batchable field as W copies of its unbatched value: the batched
  step equals the unbatched step to the bit, every field of Data, on
  scenes that between them read every batchable field (equality,
  friction-loss, limit and contact rows, compacted and lossless
  contacts, MPR, tendons, sensors and energy, the implicit integrators).
  A reader that indexed a (W, ...) field on its element axis would fail
  this or the next test.
- Distinct values per world, each world held against an unbatched step
  of its own values (at the same width: a step's rounding may follow the
  batch's width) at parity's bars (qacc: ``QACC_ATOL`` + ``QACC_RTOL``
  of the world's scale, qpos: ``QPOS_*``): on the constraints scene (the
  friction loss, damping, armature, eq_data, masses, inertias, inertial
  frames, qpos0 and the affine actuators' gains and biases, then
  set_const; also against the JAX batched set_const and step,
  ``_against_jax``) and on ``humanoid_dmc_dr`` at 8 worlds (the scene's
  own draws, from a seeded contact state; against JAX in
  ``test_torch_set_const.py``).
- The rollout's sort keeps each world's parameters: the sorted Model
  ``benchmarks.run`` returns holds the drawn fields at the world ids it
  returns, and a run sorted
  by a reversing permutation equals the unsorted run once the order is
  undone, where the same sort with the parameters left in place does
  not.
- The fused gate refuses a batched Model (``benchmarks.run`` takes the
  general step; ``step_lane`` raises), the Data API reads a batched qpos0
  per world, and the refusals raise.
"""

import dataclasses

import jax
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu import types as jtypes
from mujoco_warp_tpu.models import load_mjm
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import benchmarks, fused, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.kernels import TableCache
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_classic_step import fast_compile
from tests.torch_threads import few_threads  # noqa: F401


def _jax_step(mb, d):
  return fast_compile(lambda dd: jfwd.step(mb, dd), d)(d)


def _np(x):
  return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else x)


def world_model(mb, w):
  """The unbatched Model of world w of a batched Model."""
  return types.set_model_fields(mb, {
      n: types.get_model_field(mb, n)[w] for n in mb.batch_fields}).replace(
          batch_fields=())


def close_world(got, want, name, qpos=False):
  """(W, n) tensors at parity's bar, each world at its own scale."""
  bar = (parity.QPOS_ATOL, parity.QPOS_RTOL) if qpos else \
      (parity.QACC_ATOL, parity.QACC_RTOL)
  parity.check_world_scale(torch.as_tensor(_np(got)).T,
                           torch.as_tensor(_np(want)).T, name, *bar)


@pytest.fixture(scope='module')
def pendula():
  mjm = load_mjm('pendula.xml')
  return mjm, tio.put_model(mjm, device='cpu'), jio.put_model(mjm)


@pytest.fixture(scope='module')
def jax_pendula(pendula):
  """The JAX step of pendula at 4 worlds with per-world gravity and
  damping, compiled once: (data, gravity (4, 3), damping (4, nv)) ->
  data."""
  _, _, mj = pendula
  W = 4
  mjb = jio.batch_model(mj, W, {
      'opt.gravity': np.tile(np.asarray(mj.opt.gravity), (W, 1)),
      'dof_damping': np.tile(np.asarray(mj.dof_damping), (W, 1))})

  def step(d, grav, damp):
    mm = jtypes.set_model_fields(mjb, {'opt.gravity': grav,
                                       'dof_damping': damp})
    return jfwd.step(mm, d)

  d = jio.make_data(mjb, nworld=W)
  fn = jax.jit(step).lower(d, mjb.opt.gravity, mjb.dof_damping).compile(
      {'xla_backend_optimization_level': 0})
  return fn, mjb


def test_batched_gravity_matches_per_world_models(pendula, jax_pendula):
  mjm, m, mj = pendula
  W = 4
  grav = np.stack([[0, 0, -9.81], [0, 0, -1.0], [0, 0, 0.0],
                   [1.0, 0, -9.81]]).astype(np.float32)
  mb = tio.batch_model(m, W, {'opt.gravity': grav})
  assert mb.batch_fields == ('opt.gravity',)
  d = forward.step(mb, tio.make_data(mb, W, device='cpu'))
  for w in range(W):
    mw = m.replace(opt=m.opt.replace(gravity=torch.as_tensor(grav[w])))
    dw = forward.step(mw, tio.make_data(mw, W, device='cpu'))
    np.testing.assert_allclose(_np(d.qacc)[w], _np(dw.qacc)[w], rtol=1e-5,
                               atol=1e-6)
  fn, mjb = jax_pendula
  dj = fn(jio.make_data(mjb, nworld=W), grav, mjb.dof_damping)
  close_world(d.qacc, dj.qacc, 'qacc against JAX')


def test_batched_damping_divisor_broadcast(pendula, jax_pendula):
  mjm, m, mj = pendula
  W = 4
  damp = np.stack([np.full(m.nv, 0.1), np.full(m.nv, 5.0)]).astype(
      np.float32)  # B=2 tiles to 4: world w takes row w % 2
  mb = tio.batch_model(m, W, {'dof_damping': damp})
  d = tio.make_data(mb, W, device='cpu')
  d = forward.step(mb, d.replace(qvel=torch.ones_like(d.qvel)))
  qv = _np(d.qvel)
  np.testing.assert_allclose(qv[0], qv[2], rtol=1e-6)
  np.testing.assert_allclose(qv[1], qv[3], rtol=1e-6)
  assert not np.allclose(qv[0], qv[1])
  for w in range(2):
    mw = m.replace(dof_damping=torch.as_tensor(damp[w]))
    dw = tio.make_data(mw, W, device='cpu')
    dw = forward.step(mw, dw.replace(qvel=torch.ones_like(dw.qvel)))
    np.testing.assert_allclose(qv[w], _np(dw.qvel)[w], rtol=1e-5, atol=1e-6)
  fn, mjb = jax_pendula
  assert jio.batch_model(mj, W, {'dof_damping': damp}).dof_damping.shape == \
      (W, m.nv)
  dj = jio.make_data(mjb, nworld=W)
  dj = fn(dj.replace(qvel=jax.numpy.ones_like(dj.qvel)), mjb.opt.gravity,
          np.tile(damp, (2, 1)))
  close_world(d.qvel, dj.qvel, 'qvel against JAX')


def test_batched_friction_flows_into_contacts():
  mjm = load_mjm('spheres.xml')
  mjd = mujoco.MjData(mjm)
  mujoco.mj_resetData(mjm, mjd)
  mujoco.mj_step(mjm, mjd, 50)
  mujoco.mj_forward(mjm, mjd)
  m = tio.put_model(mjm, device='cpu')
  W = 2
  fric = np.tile(_np(m.geom_friction)[None], (W, 1, 1))
  fric[1, :, 0] = 0.05  # low-friction world 1
  mb = tio.batch_model(m, W, {'geom_friction': fric})
  for k in tio.CAND_FIELDS:
    assert k in mb.batch_fields
  qv = np.zeros((W, m.nv), np.float32)
  qv[:, 0] = 1.0  # slide a sphere
  d = tio.put_data(mjm, mjd, mb, nworld=W)
  d = forward.step(mb, d.replace(qvel=torch.as_tensor(qv)))
  v0, v1 = float(d.qvel[0, 0]), float(d.qvel[1, 0])
  assert v1 > v0 + 1e-5, (v0, v1)
  for w in range(W):
    mw = world_model(mb, w)
    dw = tio.put_data(mjm, mjd, mw, nworld=W)
    dw = forward.step(mw, dw.replace(qvel=torch.as_tensor(qv)))
    close_world(d.qvel[w:w + 1], dw.qvel[w:w + 1], f'qvel of world {w}')
  mj = jio.put_model(mjm)
  mjb = jio.batch_model(mj, W, {'geom_friction': fric})
  dj = jio.put_data(mjm, mjd, mjb, nworld=W)
  dj = _jax_step(mjb, dj.replace(qvel=jax.numpy.asarray(qv)))
  close_world(d.qvel, dj.qvel, 'qvel against JAX')


def test_bad_batch_shapes_raise(pendula):
  _, m, _ = pendula
  with pytest.raises(ValueError):
    tio.batch_model(m, 4, {'opt.gravity': np.zeros((3, 2), np.float32)})
  with pytest.raises(ValueError):
    tio.batch_model(m, 4, {'dof_damping': np.zeros((3, m.nv), np.float32)})
  with pytest.raises(NotImplementedError):
    tio.batch_model(m, 4, {'geom_size': np.zeros((4, m.ngeom, 3),
                                                 np.float32)})


def test_port_refusals_raise(pendula):
  """A field the port does not batch yet (explicit pairs' margin) names
  itself and ROADMAP queue 1; a non-array field, a width other than the
  Model's batch and Data of another width raise ValueError."""
  _, m, _ = pendula
  with pytest.raises(NotImplementedError, match='pair_margin.*queue 1'):
    tio.batch_model(m, 4, {'pair_margin': np.zeros((4, 1))})
  for name in ('nv', 'opt.iterations', 'no_such_field'):
    with pytest.raises(ValueError, match=name):
      tio.batch_model(m, 4, {name: np.zeros((4,))})
  mb = tio.batch_model(m, 4, {'dof_damping': np.ones((1, m.nv))})
  with pytest.raises(ValueError):
    tio.batch_model(mb, 8, {'dof_armature': np.ones((1, m.nv))})
  with pytest.raises(ValueError, match='batched over 4'):
    forward.step(mb, tio.make_data(m, 2, device='cpu'))
  with pytest.raises(ValueError):
    tio.save_model_npz('unused.npz', mb)
  mq = tio.batch_model(m, 4, {'qpos0': np.tile(_np(m.qpos0), (4, 1))})
  with pytest.raises(ValueError):
    tio.make_data(mq, 2, device='cpu')


def _all_copies(m, W, skip=()):
  """Every field ``batch_model`` takes on ``m`` as W copies of its value:
  the batchable fields but those the JAX step reads on the host in
  ``m`` once the others are batched (``io.host_read``)."""
  names = sorted(tio.BATCHABLE - set(skip))
  copies = lambda ns: {n: np.repeat(_np(types.get_model_field(m, n))[None],
                                    W, 0) for n in ns}
  mb = tio.batch_model(m, W, copies(n for n in names
                                    if n not in tio.HOST_READ))
  return copies(n for n in names
                if n not in tio.HOST_READ or tio.host_read(mb, n) is None)


def _assert_data_equal(a, b, where):
  for obj_a, obj_b, pre in ((a, b, ''), (a.contact, b.contact, 'contact.')):
    if obj_a is None:
      continue
    for f in dataclasses.fields(obj_a):
      x, y = getattr(obj_a, f.name), getattr(obj_b, f.name)
      if isinstance(x, torch.Tensor):
        assert torch.equal(x, y), f'{where}: {pre}{f.name}'


def _scene(name):
  if name in ('sensors_general', 'camlight'):
    return tio.put_model(mujoco.MjModel.from_xml_path(
        f'{tio._ASSETS}/{name}.xml'), device='cpu')
  if name in tio.ACT_SNAPSHOTS and name not in benchmarks.SCENES:
    return tio.load_model_npz(tio.ACT_SNAPSHOTS[name], device='cpu')
  if name == 'humanoid_dmc_energy':
    m, _ = benchmarks.load_scene('humanoid_dmc', device='cpu')
    return m.replace(opt=m.opt.replace(
        enableflags=m.opt.enableflags | types.EnableBit.ENERGY))
  return benchmarks.load_scene(name, device='cpu')[0]


# scenes that between them read every batchable field: equality (connect,
# weld, joint), friction-loss and limit rows and AFFINE actuators
# (constraints, under IMPLICITFAST too), compacted contacts with sensors
# and energy (humanoid_dmc), lossless contacts (spheres), MPR's geom
# margin (finger), tendons with armature, springs and equality
# (tendon_mix), INSIDESITE and the subtree sensors (sensors_general),
# IMPLICIT's RNE derivative (cheetah_implicit), RK4 (cartpole); since the
# placement, solver, option, camera and light fields are batchable too:
# a tendon equality and FILTER actuators on tendons (quadruped), the
# elliptic solve kernel (stack_2), the torch Newton (clutter_arm_nosleep,
# at 2 worlds), CG (spheres_cg), every camera and light mode (camlight),
# both fluid models and the wind (fluid_ellipsoid), the slider-crank and
# site transmissions (transmission), DC motors (dcmotor), gravcomp,
# actuator force ranges and site equality (mocap_arm), height fields and
# rangefinders (quadruped_escape), sidesites (tendon_wrap), activation
# ranges and muscle length ranges (actuator_mix) and sleep (clutter_arm)
COPY_SCENES = ('constraints', 'constraints_implicitfast',
               'humanoid_dmc_energy', 'spheres', 'finger', 'tendon_mix',
               'sensors_general', 'cheetah_implicit', 'cartpole',
               'quadruped', 'stack_2', 'clutter_arm_nosleep', 'spheres_cg',
               'camlight', 'fluid_ellipsoid', 'transmission', 'dcmotor',
               'mocap_arm', 'quadruped_escape', 'tendon_wrap',
               'actuator_mix', 'clutter_arm')
# the worlds of a copies case, where not 3
COPY_WORLDS = {'clutter_arm_nosleep': 2}


@pytest.mark.parametrize('name', COPY_SCENES)
def test_identical_copies_equal_the_unbatched_step_to_the_bit(name):
  """W copies of every batchable field: two steps equal the unbatched
  steps in every field of Data and its contacts, to the bit.  A model
  without joint damping leaves dof_damping unbatched here: batched, the
  step takes the damped solve for every value (as JAX does where the
  damping is a tracer), which rounds apart from the undamped step."""
  if name in ('humanoid_dmc_energy', 'finger', 'cheetah_implicit',
              'cartpole'):
    pytest.importorskip('dm_control')
  m = _scene(name)
  W = COPY_WORLDS.get(name, 3)
  skip = () if bool((m.dof_damping > 0).any()) else ('dof_damping',)
  fields = _all_copies(m, W, skip)
  mb = tio.batch_model(m, W, fields)
  assert set(mb.batch_fields) >= set(fields) - {'geom_priority'} | (
      set(tio.CAND_FIELDS) if m.ncand else set())
  qpos, qvel, ctrl = parity.general_state(m, W, 3)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(0.5 * qvel),
      ctrl=torch.as_tensor(ctrl))
  a, b = d, d
  for i in range(2):
    a, b = forward.step(m, a), forward.step(mb, b)
    _assert_data_equal(a, b, f'{name} step {i}')


def _jax_batched(mj, W, fields):
  """The JAX batched Model of ``fields`` with each world's set_const
  outputs, and those outputs ({field: (W, ...)}): ``jio.batch_model``,
  then ``jio.set_const`` of each world's Model (compiled once, at
  optimisation level 0), and the outputs batched in by a second
  ``jio.batch_model``."""
  mjb = jio.batch_model(mj, W, fields)
  m0 = mjb.replace(batch_fields=())
  world = lambda w: jtypes.set_model_fields(m0, {
      n: jtypes.get_model_field(mjb, n)[w] for n in mjb.batch_fields})
  set_const = fast_compile(jio.set_const, world(0))
  per = [set_const(world(w)) for w in range(W)]
  sc = {k: np.stack([np.asarray(jtypes.get_model_field(x, k)) for x in per])
        for k in tio.SET_CONST_FIELDS}
  sc = {k: v for k, v in sc.items() if v.size}
  return jio.batch_model(mj, W, {**fields, **sc}), sc


# set_const's outputs through M^-1: float32 sides each lie within 1e-5
# of the float64 value, and may part by up to twice that
_MINV = ('dof_invweight0', 'body_invweight0', 'tendon_invweight0',
         'actuator_acc0')


def _against_jax(mjm, mb, W, drawn, qpos, qvel, ctrl, got):
  """The port's batched Model ``mb`` (``drawn``, then set_const) and its
  step ``got`` against the JAX side, each set_const output within 1e-5
  of the field's largest entry (at least 1) in every world: against the
  JAX batched set_const, and, for the outputs through M^-1, both float32
  sides against the port's float64 set_const instead, which the set_const
  tests hold to mj_setConst at 1e-9 (on humanoid_dmc's draws the port
  lies 5.4e-6 from it, JAX 5.7e-6, the two 1.03e-5 apart, in
  actuator_acc0: float32 rounding of an M of condition up to 5e3, not a
  fault).  Then qacc and qpos of the JAX batched step from the same
  state at parity's bars."""
  mj = jio.put_model(mjm)
  mjb, sc = _jax_batched(mj, W, drawn)
  m64 = tio.set_const(tio.batch_model(
      tio.put_model(mjm, device='cpu', dtype=torch.float64), W, drawn))
  for k, want in sc.items():
    port = _np(types.world_field(mb, k).expand(want.shape))
    sides = [(port, 'port'), (want, 'JAX')]
    if k in _MINV:
      want = _np(types.world_field(m64, k).expand(want.shape))
    else:
      sides = sides[:1]
    scale = max(1.0, float(np.abs(want).max()))
    for x, side in sides:
      np.testing.assert_allclose(x, want, rtol=0, atol=1e-5 * scale,
                                 err_msg=f'set_const {k}, {side}')
  dj = jio.make_data(mjb, nworld=W).replace(
      qpos=jax.numpy.asarray(qpos), qvel=jax.numpy.asarray(qvel),
      ctrl=jax.numpy.asarray(ctrl))
  dj = _jax_step(mjb, dj)
  close_world(got.qacc, dj.qacc, 'qacc against JAX')
  close_world(got.qpos, dj.qpos, 'qpos against JAX', True)


def _drawn(mb):
  """The fields of a batched Model that were drawn: not set_const's
  outputs, not the candidate tables the geom fields mix into."""
  return {k: _np(types.get_model_field(mb, k)) for k in mb.batch_fields
          if k not in tio.SET_CONST_FIELDS and not k.startswith('cand_')}


def test_distinct_worlds_on_constraints():
  """Per-world friction loss, damping, armature, eq_data, masses,
  inertias, inertial frames, qpos0 (its hinge and slide entries) and
  the affine actuators' gains and biases on the constraints scene, then
  set_const: each world against an unbatched port step with its values,
  and the set_const outputs and the step against the JAX batched
  set_const and step, at parity's bars."""
  mjm = mujoco.MjModel.from_xml_path(tio.CONSTRAINTS_XML)
  m = tio.put_model(mjm, device='cpu')
  W = 4
  rng = np.random.default_rng(1)
  u = lambda lo, hi, *shape: rng.uniform(lo, hi, (W,) + shape)
  scale = lambda x, lo, hi: _np(x)[None] * u(lo, hi, *x.shape)
  body = u(0.8, 1.2, m.nbody)
  q0 = np.repeat(_np(m.qpos0)[None], W, 0)
  scalar = np.asarray(m.jnt_qposadr)[np.isin(
      np.asarray(m.jnt_type), [types.JointType.HINGE,
                               types.JointType.SLIDE])]
  q0[:, scalar] += u(-0.1, 0.1, len(scalar))
  # a position actuator stays one: kp and -kp scale together
  kp = u(0.8, 1.2, m.nu)
  gain = np.repeat(_np(m.actuator_gainprm)[None], W, 0)
  gain[..., 0] *= kp
  bias = np.repeat(_np(m.actuator_biasprm)[None], W, 0)
  bias[..., 1] *= kp
  bias[..., 2] *= u(0.8, 1.2, m.nu)
  fields = {'dof_frictionloss': scale(m.dof_frictionloss, 0.5, 1.5),
            'dof_damping': scale(m.dof_damping, 0.5, 1.5),
            'dof_armature': scale(m.dof_armature, 1.0, 2.0) + 0.01,
            'eq_data': scale(m.eq_data, 0.98, 1.02),
            'body_mass': _np(m.body_mass) * body,
            'body_inertia': _np(m.body_inertia) * body[..., None],
            'body_ipos': _np(m.body_ipos) + u(-0.01, 0.01, m.nbody, 3),
            'qpos0': q0, 'actuator_gainprm': gain,
            'actuator_biasprm': bias}
  mb = tio.set_const(tio.batch_model(m, W, fields))
  qpos, qvel, ctrl = parity.general_state(m, W, 5)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  got = forward.step(mb, d)
  for w in range(W):
    dw = forward.step(world_model(mb, w), d)
    close_world(got.qacc[w:w + 1], dw.qacc[w:w + 1], f'qacc of world {w}')
    close_world(got.qpos[w:w + 1], dw.qpos[w:w + 1], f'qpos of world {w}',
                True)
  _against_jax(mjm, mb, W, fields, qpos, qvel, ctrl, got)


@pytest.fixture(scope='module')
def dr():
  pytest.importorskip('dm_control')
  m, W = benchmarks.load_scene('humanoid_dmc_dr', device='cpu', nworld=8)
  return m, W


def test_distinct_worlds_on_humanoid_dmc_dr(dr):
  """The scene's draws at 8 worlds, from the seeded contact state of
  ``parity.dmc_state``: each world against an unbatched step of its own
  values (its friction mixed into the candidate tables, its set_const
  outputs), qacc and qpos at parity's bars."""
  mb, W = dr
  assert not fused.supported(mb)
  m0, _ = benchmarks.load_scene('humanoid_dmc', device='cpu')
  qpos, qvel, ctrl = parity.dmc_state(m0, 'humanoid_dmc', W, 2)
  d = tio.make_data(mb, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  got = forward.step(mb, d)
  assert int(got.ncon_active.sum()) > 0
  for w in range(W):
    mw = world_model(mb, w)
    assert torch.equal(mw.cand_friction, tio.remix(mw).cand_friction)
    dw = forward.step(mw, d)
    close_world(got.qacc[w:w + 1], dw.qacc[w:w + 1], f'qacc of world {w}')
    close_world(got.qpos[w:w + 1], dw.qpos[w:w + 1], f'qpos of world {w}',
                True)


def test_rollout_sort_keeps_parameters_with_their_worlds(dr):
  mb, W = dr
  res = benchmarks.run(mb, W, nstep=8, warmup_steps=1, device='cpu')
  st, mw0, ids = res['state'], res['model'], res['world_ids']
  for n in mb.batch_fields:
    assert torch.equal(types.get_model_field(mw0, n),
                       types.get_model_field(mb, n)[ids]), n
  assert bool(torch.isfinite(st.qpos).all())
  # a sort that moves every world against none, the order undone, with
  # the parameters carried and with them left in their slots
  d0 = types.carried(st)
  flip = torch.arange(W - 1, -1, -1)

  def run(perm_model):
    d = types.map_worlds(d0, lambda x: x[flip], W)
    mw = types.map_model_worlds(mw0, lambda x: x[flip]) if perm_model \
        else mw0
    for _ in range(4):
      d = forward.step(mw, d)
    return d.qpos[flip]

  plain = d0
  for _ in range(4):
    plain = forward.step(mw0, plain)
  close_world(run(True), plain.qpos, 'qpos, sorted with the parameters',
              True)
  with pytest.raises(AssertionError):
    close_world(run(False), plain.qpos, 'qpos, parameters left behind',
                True)


def test_batched_fields_are_contiguous(pendula):
  """A field given as a broadcast view (world stride 0) or in Fortran
  order is stored world-major and contiguous, as the kernels read it."""
  _, m, _ = pendula
  W = 4
  arm = torch.as_tensor(_np(m.dof_armature))[None].expand(W, m.nv).numpy()
  grav = np.asfortranarray(np.tile(_np(m.opt.gravity)[None], (W, 1)))
  mb = tio.batch_model(m, W, {'dof_armature': arm, 'opt.gravity': grav})
  for k in mb.batch_fields:
    x = types.get_model_field(mb, k)
    assert x.is_contiguous(), k
    np.testing.assert_array_equal(_np(x), {'dof_armature': arm,
                                           'opt.gravity': grav}[k])


def test_table_caches_survive_the_sort(pendula):
  """``kernels.TableCache`` keys on ``types.model_token``: a sort of a
  batched Model's worlds keeps the token, so its tables are not rebuilt;
  a change of an unbatched field, or batching one, makes a new token."""
  _, m, _ = pendula
  W = 4
  mb = tio.batch_model(m, W, {'dof_damping': np.tile(
      _np(m.dof_damping)[None], (W, 1))})
  flip = torch.arange(W - 1, -1, -1)
  ms = types.map_model_worlds(mb, lambda x: x[flip])
  assert ms is not mb
  assert types.model_token(ms) is types.model_token(mb)
  assert types.model_token(mb) is not types.model_token(m)
  built = []
  cache = TableCache(lambda mm, dev: built.append(mm) or len(built))
  assert cache.get(mb, 'cpu') == cache.get(ms, 'cpu') == 1
  assert cache.get(mb.replace(dof_armature=mb.dof_armature * 2),
                   'cpu') == 2


def test_fused_gate_refuses_a_batched_model():
  """The humanoid is inside the fused gate; batched it is not: run takes
  the general step and ``step_lane`` raises."""
  m = tio.load_model_npz(device='cpu')
  assert fused.supported(m)
  mb = tio.batch_model(m, 4, {'dof_damping': _np(m.dof_damping)[None]})
  assert 'per-world' in fused.reason(mb)
  res = benchmarks.run(mb, nworld=4, nstep=1, warmup_steps=1, device='cpu')
  assert isinstance(res['state'], types.Data)
  with pytest.raises(NotImplementedError):
    fused.step_lane(mb, fused.to_lane(m, tio.make_data(m, 4, device='cpu')))


def test_data_api_reads_qpos0_per_world(pendula):
  mjm, m, _ = pendula
  W = 3
  q0 = _np(m.qpos0)[None] + 0.01 * np.arange(W)[:, None]
  mb = tio.batch_model(m, W, {'qpos0': q0})
  d = tio.make_data(mb, W, device='cpu')
  np.testing.assert_array_equal(_np(d.qpos), q0.astype(np.float32))
  d = forward.step(mb, d)
  mask = torch.tensor([True, False, True])
  r = tio.reset_data(mb, d, mask)
  np.testing.assert_array_equal(_np(r.qpos)[[0, 2]], q0[[0, 2]].astype(
      np.float32))
  assert torch.equal(r.qpos[1], d.qpos[1])
  mjd = mujoco.MjData(mjm)
  pd = tio.put_data(mjm, mjd, mb, nworld=W)
  np.testing.assert_array_equal(_np(pd.qpos), np.tile(
      mjd.qpos.astype(np.float32), (W, 1)))
