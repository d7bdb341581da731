"""Port io, the gate and per-world actuator fields for actuation.

- The five scenes of the slice (dm_control's quadruped and dog, the
  repo's dcmotor.xml and transmission.xml, the port's actuator_mix.xml):
  every field of the port's Model equals the JAX ``put_model``'s, the
  activation fields among them, float32 arrays bit for bit; each
  committed snapshot equals a fresh ``put_model``; the general step
  takes each scene and the fused gate refuses it, as the JAX gate does.
- The gate over dm_control's tasks: every quadruped and dog task whose
  model the ROADMAP listed as refused for activation passes
  ``unsupported`` and ``put_model``; quadruped escape (its height field),
  swimmer and fish (fluid forces), which their own slice admits, pass
  too with those features on, and since the mocap slice actuator
  gravcomp (its force against MuJoCo C's).
- ``io.batch_model`` on the actuator fields the step reads per world
  (``actuator_gear``, ``actuator_ctrlrange``, ``actuator_forcerange``,
  ``actuator_dynprm``): W copies of every batchable field equal the
  unbatched step to the bit, distinct values reach only their world,
  ``set_const`` batches actuator_acc0 with the gear, and a model with a
  DC motor refuses every actuator field.
"""

import os

import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.pallas import fused as jfused
from mujoco_warp_tpu_torch import fused, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_batch_model import _all_copies, _assert_data_equal, \
    _np, world_model
from tests.test_torch_classic_io import assert_matches_jax
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

# (nv, nu, na, ncand, ncon, nefc) of each scene
SIZES = {'quadruped': (22, 12, 12, 175, 175, 300),
         'dog': (79, 38, 38, 6273, 144, 793),
         'dcmotor': (3, 3, 6, 2, 2, 8),
         'transmission': (7, 3, 0, 8, 8, 32),
         'actuator_mix': (3, 7, 5, 12, 12, 51)}
_ACT_FIELDS = ('actuator_dynprm', 'actuator_actadr', 'actuator_actnum',
               'actuator_actlimited', 'actuator_actrange',
               'actuator_actearly', 'actuator_cranklength',
               'actuator_lengthrange', 'jnt_actfrcrange')


def load(scene):
  if scene in tio.ACT_DMC:
    pytest.importorskip('dm_control')
    return tio.load_dmc(scene)
  return mujoco.MjModel.from_xml_path(tio.ACT_XML[scene])


@pytest.mark.parametrize('scene', sorted(SIZES))
def test_actuation_model_matches_jax(scene):
  mjm = load(scene)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  assert_matches_jax(mj, m)
  assert (m.nv, m.nu, m.na, m.ncand, m.ncon, m.nefc) == SIZES[scene]
  for k in _ACT_FIELDS:
    assert types.host(getattr(m, k)).shape[0] == (
        m.njnt if k.startswith('jnt_') else m.nu), k
  assert forward.unsupported(m) is None
  assert fused.reason(m) is not None and not fused.supported(m)
  assert not jfused.supported_features(mj)
  assert_models_equal(tio.load_model_npz(tio.ACT_SNAPSHOTS[scene],
                                         device='cpu'), m)


def _suite_model(domain, task):
  from dm_control import suite
  return suite.load(domain, task).physics.model.ptr


@pytest.mark.parametrize('domain,task', [
    ('quadruped', 'walk'), ('quadruped', 'run'), ('quadruped', 'fetch'),
    ('dog', 'stand'), ('dog', 'walk'), ('dog', 'trot'), ('dog', 'run'),
    ('dog', 'fetch')])
def test_gate_takes_activation_tasks(domain, task):
  pytest.importorskip('dm_control')
  mjm = _suite_model(domain, task)
  assert mjm.na and np.all(mjm.actuator_dyntype == 2)  # FILTER
  m = tio.put_model(mjm, device='cpu')
  assert forward.unsupported(m) is None


@pytest.mark.parametrize('domain,task,why', [
    ('quadruped', 'escape', 'HFIELD'), ('swimmer', 'swimmer6', 'fluid'),
    ('fish', 'swim', 'fluid')])
def test_gate_keeps_other_reasons(domain, task, why):
  """The tasks that the activation slice left to their own reasons (the
  height field of escape, the fluid forces of swimmer and fish): since
  the fluid, ray and height-field slice, put_model and the general step
  take each with its feature on, and the fused gate still refuses it."""
  pytest.importorskip('dm_control')
  mjm = _suite_model(domain, task)
  m = tio.put_model(mjm, device='cpu')
  assert forward.unsupported(m) is None
  assert fused.reason(m) is not None
  if why == 'HFIELD':
    assert any(g[0] == types.GeomType.HFIELD for g in m.pair_groups)
    assert np.any(m.sensor_type == types.SensorType.RANGEFINDER)
  else:
    assert float(types.host(m.opt.density)) > 0.0


_GRAVCOMP = """
<mujoco>
  <option gravity="0 0 -9.81"/>
  <worldbody>
    <body gravcomp="1">
      <joint name="j" type="hinge" axis="0 1 0" actuatorgravcomp="{g}"
             actuatorfrclimited="true" actuatorfrcrange="-0.5 0.5"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
    </body>
  </worldbody>
  <actuator><motor joint="j" gear="{gear}"/></actuator>
</mujoco>"""


def test_gate_refuses_actuator_gravcomp():
  """Since the mocap slice the gate takes a joint with actuatorgravcomp:
  with it the body's gravity compensation goes into qfrc_actuator before
  the joint's actfrcrange clamp (-1.30 of compensation plus 0.6 of ctrl,
  held to -0.5), without it into qfrc_passive.  Either way put_model
  admits the model, and one forward's qfrc_actuator, qfrc_passive and
  qfrc_gravcomp equal ``mj_forward``'s within 1e-5."""
  for g in ('true', 'false'):
    mjm = mujoco.MjModel.from_xml_string(_GRAVCOMP.format(g=g, gear=2))
    m = tio.put_model(mjm, device='cpu')
    assert forward.unsupported(m) is None
    assert fused.reason(m) is not None
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = 0.4
    mjd.ctrl[:] = 0.3
    mujoco.mj_forward(mjm, mjd)
    d = forward._forward(m, tio.put_data(mjm, mjd, m))
    for k in ('qfrc_actuator', 'qfrc_passive', 'qfrc_gravcomp'):
      np.testing.assert_allclose(getattr(d, k)[0].numpy(), getattr(mjd, k),
                                 atol=1e-5, err_msg=f'{k} ({g})')
    assert abs(float(mjd.qfrc_gravcomp[0])) > 0.1
    if g == 'true':
      assert float(mjd.qfrc_actuator[0]) == pytest.approx(-0.5)


# scenes whose steps read every batchable actuator field: muscles, site
# transmissions, actearly and actrange, a joint's actuatorfrcrange
# (actuator_mix); FILTER activations on tendons and joints with contacts
# (quadruped); the slider-crank and adhesion (transmission)
COPY_SCENES = ('actuator_mix', 'quadruped', 'transmission')


@pytest.mark.parametrize('name', COPY_SCENES)
def test_identical_actuator_copies_equal_the_unbatched_step(name):
  """W copies of every batchable field (the four actuator fields of this
  slice among them): two steps equal the unbatched steps in every field
  of Data and its contacts, to the bit."""
  m = tio.load_model_npz(tio.ACT_SNAPSHOTS[name], device='cpu')
  W = 3
  skip = () if bool((m.dof_damping > 0).any()) else ('dof_damping',)
  mb = tio.batch_model(m, W, _all_copies(m, W, skip))
  for k in ('actuator_gear', 'actuator_ctrlrange', 'actuator_forcerange',
            'actuator_dynprm'):
    assert k in mb.batch_fields
  qpos, qvel, ctrl = (parity.dmc_state(m, name, W, 3) if name in
                      parity.DMC_DROP else parity.general_state(m, W, 3))
  rng = np.random.default_rng(3)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(0.5 * qvel),
      ctrl=torch.as_tensor(3.0 * ctrl), act=torch.as_tensor(
          0.1 * rng.standard_normal((W, m.na)), dtype=torch.float32))
  a, b = d, d
  for i in range(2):
    a, b = forward.step(m, a), forward.step(mb, b)
    _assert_data_equal(a, b, f'{name} step {i}')


def test_actuator_fields_per_world():
  """Each world's own gear, ctrl range, force range and dynprm reach that
  world alone: on actuator_mix, world 1 takes changed values of all four,
  and each world's step equals the unbatched step of its own values at
  the same width (to the bit); world 1 parts from world 0, which starts
  from the same state."""
  m = tio.load_model_npz(tio.ACT_SNAPSHOTS['actuator_mix'], device='cpu')
  W = 2
  vals = {k: np.repeat(_np(getattr(m, k))[None], W, 0) for k in (
      'actuator_gear', 'actuator_ctrlrange', 'actuator_forcerange',
      'actuator_dynprm')}
  vals['actuator_gear'][1, :, 0] *= 1.5
  vals['actuator_gear'][1, 0, 4] = 0.5  # the site actuator's torque
  vals['actuator_ctrlrange'][1] *= 0.5
  vals['actuator_forcerange'][1, 5] = (-5.0, 5.0)
  vals['actuator_dynprm'][1, 3, 0] *= 3.0  # FILTER's time constant
  vals['actuator_dynprm'][1, 5, :2] *= 2.0  # the muscle's tau
  mb = tio.batch_model(m, W, vals)
  rng = np.random.default_rng(5)
  one = lambda x: np.repeat(x[:1], W, 0)
  qpos, qvel, _ = parity.general_state(m, W, 5)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(one(qpos)), qvel=torch.as_tensor(one(qvel)),
      ctrl=torch.as_tensor(one(rng.uniform(-2, 2, (W, m.nu))),
                           dtype=torch.float32),
      act=torch.as_tensor(one(0.1 * rng.standard_normal((W, m.na))),
                          dtype=torch.float32))
  db = forward.step(mb, d)
  for w in range(W):
    dw = forward.step(world_model(mb, w), d)
    for k in ('act', 'act_dot', 'actuator_force', 'actuator_length',
              'qfrc_actuator', 'qvel'):
      assert torch.equal(getattr(db, k)[w], getattr(dw, k)[w]), (w, k)
  for k in ('act', 'actuator_force', 'actuator_length', 'qvel'):
    assert not torch.equal(db.__dict__[k][0], db.__dict__[k][1]), k


def test_set_const_batches_acc0_with_the_gear():
  m = tio.load_model_npz(tio.ACT_SNAPSHOTS['actuator_mix'], device='cpu')
  gear = np.repeat(_np(m.actuator_gear)[None], 2, 0)
  gear[1, :, 0] *= 2.0
  mb = tio.set_const(tio.batch_model(m, 2, {'actuator_gear': gear}))
  assert 'actuator_acc0' in mb.batch_fields
  acc0 = types.world_field(mb, 'actuator_acc0')
  ref = tio.set_const(m).actuator_acc0
  torch.testing.assert_close(acc0[0], ref, rtol=1e-6, atol=0.0)
  # a joint or tendon actuator's acc0 scales with its gear
  u = np.nonzero(np.isin(m.actuator_trntype, (types.TrnType.JOINT,
                                              types.TrnType.TENDON)))[0]
  torch.testing.assert_close(acc0[1, u], 2.0 * ref[u], rtol=1e-5, atol=0.0)


def test_dcmotor_model_batches_no_actuator_field():
  """A model with a DC motor batches no actuator field that lays out or
  switches the motor's act slots on the host: dynprm and gainprm (the
  JAX step reads them there, so its batched step cannot take them); its
  other actuator fields batch, as they do in JAX."""
  m = tio.load_model_npz(tio.ACT_SNAPSHOTS['dcmotor'], device='cpu')
  for k in ('actuator_dynprm', 'actuator_gainprm'):
    with pytest.raises(NotImplementedError, match='DC motor'):
      tio.batch_model(m, 2, {k: np.repeat(_np(getattr(m, k))[None], 2, 0)})
  # other fields still batch
  mb = tio.batch_model(m, 2, {'dof_damping': np.ones((2, m.nv)),
                              'actuator_gear': np.repeat(
                                  _np(m.actuator_gear)[None], 2, 0)})
  assert mb.batch_fields == ('actuator_gear', 'dof_damping')


def test_snapshot_scenes_exist():
  for name, path in tio.ACT_SNAPSHOTS.items():
    assert os.path.exists(path), name
