"""The general step on the fluid, ray and height-field scenes against the
JAX ``forward.step`` (batched, jitted, its jnp path on the CPU), from the
same seeded state at 8 worlds: dm_control's swimmer6 (fluid, contacts
off), fish (fluid, constraints off) and quadruped escape (the committed
seeded terrain, 19 height-field pairs, 20 rangefinders, pyramidal rows
through the solve kernel at nefc 488), and the repo's sensors.xml (a
rangefinder) and contact_sensor.xml (six contact sensors).

One step stage by stage with the bars of
``tests/test_torch_classic_step.py`` (rows, actuator forces and
qfrc_passive within atol 1e-5 + rtol 1e-4, efc_aref, qM and qfrc_bias at
the world's scale; qpos atol 2e-4 rtol 1e-3, qvel 5e-3, sensordata by
``parity.check_sensors``), qfrc_fluid within 1e-5 + 1e-4; then three
steps on swimmer6 and escape.  The helpers serve
``tests/test_torch_sensor_contact.py``.
"""

import functools

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import benchmarks, io as tio, parity, types
from mujoco_warp_tpu_torch.ops import forward, ray
from tests.oracle import assert_close
from tests.test_torch_classic_step import check_stage, check_state, \
    fast_compile
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

W = 8


def load(scene):
  """The scene's MjModel: a dm_control task of ``io.FLUID_DMC`` (escape
  with its seeded terrain) or an XML of ``io.FLUID_XML``."""
  if scene in tio.FLUID_DMC:
    pytest.importorskip('dm_control')
    return tio.load_dmc(scene)
  return mujoco.MjModel.from_xml_path(tio.FLUID_XML[scene])


@functools.lru_cache(maxsize=None)
def models(scene):
  """(MjModel, JAX Model, port Model); the port Model is the scene's
  committed snapshot, which must equal ``put_model``."""
  mjm = load(scene)
  m, w = benchmarks.load_scene(scene, device='cpu')
  assert w == 8192
  assert_models_equal(m, tio.put_model(mjm, device='cpu'))
  return mjm, jio.put_model(mjm), m


@functools.lru_cache(maxsize=None)
def case(scene, nworld=W):
  """(MjModel, JAX Model, port Model, jitted JAX step)."""
  mjm, mj, m = models(scene)
  dj = jio.make_data(mj, nworld=nworld)
  return mjm, mj, m, fast_compile(lambda x: jfwd.step(mj, x), dj)


def seeded(m, scene, nworld, seed):
  """World-major float32 numpy (qpos, qvel, ctrl): ``parity.dmc_state``
  on escape (its root lowered into the terrain); elsewhere qpos0 + 0.01 N
  with every free and ball quaternion renormalised, qvel 0.3 N and ctrl
  0.3 N, drawn in that order from ``default_rng(seed)``."""
  if scene in parity.DMC_DROP:
    return parity.dmc_state(m, scene, nworld, seed)
  rng = np.random.default_rng(seed)
  qpos = (types.host(m.qpos0, np.float32)[None] +
          0.01 * rng.standard_normal((nworld, m.nq))).astype(np.float32)
  for j in range(m.njnt):
    jt, a = int(m.jnt_type[j]), int(m.jnt_qposadr[j])
    if jt in (types.JointType.FREE, types.JointType.BALL):
      q = slice(a + 3, a + 7) if jt == types.JointType.FREE else \
          slice(a, a + 4)
      qpos[:, q] /= np.linalg.norm(qpos[:, q], axis=1, keepdims=True)
  qvel = (0.3 * rng.standard_normal((nworld, m.nv))).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((nworld, m.nu))).astype(np.float32)
  return qpos, qvel, ctrl


def start(scene, seed=3, nworld=W):
  """The seeded state on both sides, (JAX Data, port Data)."""
  _, mj, m, _ = case(scene, nworld)
  qpos, qvel, ctrl = seeded(m, scene, nworld, seed)
  dj = jio.make_data(mj, nworld=nworld).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  t = torch.as_tensor
  d = tio.make_data(m, nworld, device='cpu').replace(
      qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))
  return dj, d


def one_step(scene, seed=3):
  """One step of both sides from ``start``, checked stage by stage."""
  dj, d = start(scene, seed)
  _, _, m, step = case(scene)
  d1, dj1 = forward.step(m, d), step(dj)
  check_stage(m, d1, dj1)
  check_state(m, d1, dj1)
  assert_close(d1.qfrc_fluid.numpy(), np.asarray(dj1.qfrc_fluid),
               'qfrc_fluid', 1e-5, 1e-4)
  return m, d1, dj1


SCENES = ('swimmer6', 'fish', 'quadruped_escape', 'sensors',
          'contact_sensor')


@pytest.mark.parametrize('scene', SCENES)
def test_one_step_stage_by_stage(scene):
  m, d, _ = one_step(scene)
  assert forward.unsupported(m) is None
  if scene in ('swimmer6', 'fish'):
    assert float(d.qfrc_fluid.abs().max()) > 0.1
  if scene == 'quadruped_escape':
    # feet on the terrain in every world, through the solve kernel
    assert forward.solve_kernel_runs(m) and (m.nefc, m.ncon) == (488, 222)
    assert bool((d.ncon_active > 0).all())
    assert ray.walks > 0


@pytest.mark.parametrize('scene', ('swimmer6', 'quadruped_escape'))
def test_three_steps_match_jax(scene):
  dj, d = start(scene, seed=5)
  _, _, m, step = case(scene)
  for _ in range(3):
    dj, d = step(dj), forward.step(m, d)
    check_state(m, d, dj)
  assert int(d.overflow.max()) == 0
