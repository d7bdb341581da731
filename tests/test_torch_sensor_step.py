"""The general step's sensordata and energy against the JAX
``ops/forward.step`` (batched, jitted) on the same seeded states: 3 steps
at 16 worlds on dm_control's humanoid (humanoid_dmc, 34 sensors of 7
types, contacts compacted into {1: 16, 3: 32} slots, feet in the floor),
on its hopper (lossless slots, the foot's TOUCH sites in the floor) and
on ``assets/sensors_general.xml`` (``mujoco_warp_tpu/models/
sensors.xml`` without its tendon, tendon sensors and rangefinder, plus
INSIDESITE, CAMPROJECTION, the energies and cutoffs; the ball lowered
into the floor so that TOUCH reads a force).  After every step the
position and velocity sensors, and energy, within atol 1e-4 + rtol 1e-4
|JAX| elementwise; the acceleration sensors by ``parity.check_sensors``'
world-scale rule (atol 1e-4 + rtol 1e-3 of the world's largest |JAX| of
the type, where the Newton counts agree); qpos and qvel at the bars of
tests/test_torch_step_small.py (qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3
rtol 5e-3)."""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.torch_threads import few_threads  # noqa: F401

SENSORS_XML = os.path.join(os.path.dirname(tio.__file__), 'assets',
                           'sensors_general.xml')
W = 16


def scene_state(scene, seed):
  """(JAX Model, port Model, JAX Data, port Data) of a scene's seeded
  contact state."""
  if scene == 'sensors_general':
    mjm, nconmax = mujoco.MjModel.from_xml_path(SENSORS_XML), None
  else:
    pytest.importorskip('dm_control')
    mjm, nconmax = tio.load_dmc(scene), tio.DMC_NCONMAX[scene]
  mj = jio.put_model(mjm, nconmax=nconmax)
  m = tio.put_model(mjm, nconmax=nconmax, device='cpu')
  if scene == 'sensors_general':
    qpos, qvel, ctrl = parity.general_state(m, W, seed)
    ball = int(m.jnt_qposadr[2])  # the free ball: 2 cm into the floor
    qpos[:, ball:ball + 3] = [0.8, 0.0, 0.08]
  else:
    qpos, qvel, ctrl = parity.dmc_state(m, scene, W, seed)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  return mj, m, dj, d


@pytest.mark.parametrize('scene', ['humanoid_dmc', 'hopper',
                                   'sensors_general'])
def test_sensordata_matches_jax(scene):
  mj, m, dj, d = scene_state(scene, 4)
  step = jax.jit(lambda x: jfwd.step(mj, x))
  touch = 0.0
  for _ in range(3):
    dj = step(dj)
    d = forward.step(m, d)
    parity.check_sensors(m, d.sensordata, np.asarray(dj.sensordata),
                         d.solver_niter, np.asarray(dj.solver_niter))
    e, ej = d.energy.numpy(), np.asarray(dj.energy)
    np.testing.assert_allclose(e, ej, atol=1e-4, rtol=1e-4)
    cols = parity.sensor_stages(m)['acc'].get('TOUCH')
    if cols is not None:
      touch = max(touch, float(d.sensordata[:, cols].max()))
  # the state itself at the step tests' bars (test_torch_step_small.py)
  assert_close(d.qpos.numpy(), np.asarray(dj.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(d.qvel.numpy(), np.asarray(dj.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
  assert np.isfinite(d.sensordata.numpy()).all()
  assert int(d.overflow.max()) == 0 and int(np.asarray(dj.overflow).max()) == 0
  assert touch > 0.0  # contacts pushed on a TOUCH site
  if scene == 'sensors_general':
    assert m.opt.enableflags & types.EnableBit.ENERGY
    assert float(np.abs(e).min()) > 0.0
