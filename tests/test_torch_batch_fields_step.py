"""Distinct values per world of more of the fields batchable since the
placement, solver, option and actuation fields joined ``io.BATCHABLE``
(a file of its own beside ``test_torch_batch_fields_jax.py``, to share
the JAX compile time across workers).

Against the JAX batched step (one compile per scene, as there): wind,
density and viscosity (fluid_ellipsoid), gravity compensation and the
joints' actuator force ranges (mocap_arm), activation and muscle length
ranges (actuator_mix).

Against unbatched port steps, each world with its own values at parity's
bars (``QACC_*``, ``QPOS_*``; the unbatched step of each drawn value is
held against JAX by the scene's own tests): the height field's size and
heights (quadruped escape, its collider and rangefinders: the JAX step
compiles in ~40 s there), the slider-crank's cranklength
(transmission), the sleep tolerance (clutter_arm from its settled state,
where it decides which trees fall asleep), and the contact override
fields under the OVERRIDE flag (spheres), which ``io.remix`` mixes into
each world's candidate tables (the JAX ``batch_model`` re-mixes only for
geom fields, so its tables keep the unbatched override: ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import benchmarks, io as tio, parity, types
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_batch_fields_jax import W, _check, _draw, _mjm, _state
from tests.test_torch_batch_model import close_world, world_model
from tests.torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize('name,names,sensors', [
    ('fluid_ellipsoid', ('opt.wind', 'opt.density', 'opt.viscosity'),
     False),
    ('mocap_arm', ('body_gravcomp', 'jnt_actfrcrange'), True),
    ('actuator_mix', ('actuator_actrange', 'actuator_lengthrange'), False),
])
def test_scene_group_against_jax(name, names, sensors):
  mjm = _mjm(name)
  m = tio.put_model(mjm, device='cpu')
  fields = _draw(m, names, 7)
  if name == 'fluid_ellipsoid':  # a wind that differs in direction
    fields['opt.wind'] = np.asarray([[0.0, 0.0, 0.0], [1.0, -0.5, 0.2],
                                     [-2.0, 0.3, 0.0]])
  mb = tio.batch_model(m, W, fields)
  _check(name, mjm, m, mb, fields, _state(m), sensors)


def _per_world(mb, d, nstep=1, asleep=False):
  """``nstep`` steps of the batched Model against each world's unbatched
  Model from the same state, qacc and qpos at parity's bars (and
  tree_asleep equal)."""
  got = d
  for _ in range(nstep):
    got = forward.step(mb, got)
  for w in range(d.qpos.shape[0]):
    mw, dw = world_model(mb, w), d
    for _ in range(nstep):
      dw = forward.step(mw, dw)
    close_world(got.qacc[w:w + 1], dw.qacc[w:w + 1], f'qacc of world {w}')
    close_world(got.qpos[w:w + 1], dw.qpos[w:w + 1], f'qpos of world {w}',
                True)
    if asleep:
      assert torch.equal(got.tree_asleep[w], dw.tree_asleep[w]), w
  return got


def test_height_field_per_world():
  """quadruped escape with its terrain's heights scaled per world and its
  size per world, from its seeded contact state: contacts with the
  terrain and its 20 rangefinders read each world's field."""
  pytest.importorskip('dm_control')
  m = benchmarks.load_scene('quadruped_escape', device='cpu')[0]
  size = np.repeat(types.host(m.hfield_size)[None], W, 0)
  size[1, :, :2] *= 1.1
  size[2, :, 2] *= 0.8
  data = np.random.default_rng(9).uniform(0.7, 1.0, (W, 1)) * \
      types.host(m.hfield_data)[None]
  mb = tio.batch_model(m, W, {'hfield_size': size, 'hfield_data': data})
  qpos, qvel, _ = parity.dmc_state(m, 'quadruped_escape', W, 2)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  got = _per_world(mb, d)
  sens = got.sensordata
  assert int(got.ncon_active.sum()) > 0
  assert not torch.equal(sens[0], sens[1]) and not torch.equal(sens[0],
                                                                sens[2])


def test_cranklength_per_world():
  m = tio.load_model_npz(tio.ACT_SNAPSHOTS['transmission'], device='cpu')
  mb = tio.batch_model(m, W, _draw(m, ('actuator_cranklength',), 3))
  _per_world(mb, _state(m))


def test_sleep_tolerance_per_world():
  """clutter_arm from its settled state, woken at random, 3 steps with
  a sleep tolerance of 0, the model's and 10 times it: each world's trees
  fall asleep as its own unbatched run's do."""
  m = benchmarks.load_scene('clutter_arm', device='cpu')[0]
  tol = float(types.host(m.opt.sleep_tolerance))
  mb = tio.batch_model(m, W, {'opt.sleep_tolerance': np.asarray(
      [0.0, tol, 10.0 * tol])})
  init = benchmarks.start_state('clutter_arm')
  woke = parity.woken_state(m, {k: v[:W] for k, v in init.items()},
                            np.random.default_rng(18))
  d = benchmarks.build(m, W, init_state=woke, device='cpu')
  _per_world(mb, d, nstep=3, asleep=True)


def test_override_per_world():
  """The spheres scene under the OVERRIDE flag, from its seeded contact
  state, its margin, solref, solimp and friction override per world:
  every world mixes its own candidate tables, and each world steps as
  its unbatched Model does."""
  m = benchmarks.load_scene('spheres', device='cpu')[0]
  m = tio.remix(m.replace(opt=m.opt.replace(
      enableflags=m.opt.enableflags | types.EnableBit.OVERRIDE)))
  fields = _draw(m, ('opt.o_margin', 'opt.o_solref', 'opt.o_solimp',
                     'opt.o_friction'), 4)
  fields['opt.o_margin'] = np.asarray([0.0, 0.01, 0.02])
  mb = tio.batch_model(m, W, fields)
  assert set(tio.CAND_FIELDS) <= set(mb.batch_fields)
  for w in range(W):
    mw = world_model(mb, w)
    assert torch.equal(mw.cand_margin, tio.remix(mw).cand_margin)
  assert not torch.equal(mb.cand_solref[0], mb.cand_solref[1])
  qpos, qvel, _ = parity.spheres_state(m, W, 5)
  _per_world(mb, tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
