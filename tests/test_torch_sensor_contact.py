"""The RANGEFINDER, CONTACT and GEOMDIST / GEOMNORMAL / GEOMFROMTO sensors
of the general step against the JAX step's sensordata, one step from the
same seeded state at 8 worlds (``tests/test_torch_dmc_rest.py``).

- sensors.xml: its rangefinder (down from the swinging arm onto the
  floor), within atol 1e-4 + rtol 1e-4.
- contact_sensor.xml: its six contact sensors (found, force, torque,
  dist, pos, normal, tangent; none, mindist, maxforce and netforce; a
  site operand), at the world scale of ``parity.check_world_scale`` (the
  forces come from the solve), with lossless slots and with the contacts
  compacted into 3 slots, where a slot holds a different contact in each
  world and the sensor matches its operands per world.
- geomdist.xml: distance, normal and fromto between sphere, capsule and
  box operands and one body operand, within atol 1e-4 + rtol 1e-4, some
  within their cutoff and some past it.

``sensor.DEFERRED`` holds only TACTILE.
"""

import functools

import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import io as tio, parity, types
from mujoco_warp_tpu_torch.ops import forward, sensor
from tests.test_torch_classic_step import fast_compile
from tests.test_torch_dmc_rest import W, case, models, seeded, start
from tests.torch_threads import few_threads  # noqa: F401

_ST = types.SensorType
ATOL, RTOL = 1e-4, 1e-4


def columns(m, kind):
  """The sensordata columns of the sensors of type ``kind``."""
  ids = np.nonzero(np.asarray(m.sensor_type) == kind)[0]
  return np.concatenate([int(m.sensor_adr[i]) + np.arange(
      int(m.sensor_dim[i])) for i in ids])


def stepped(scene, seed=3):
  dj, d = start(scene, seed)
  _, _, m, step = case(scene)
  return m, forward.step(m, d), step(dj)


def test_deferred_holds_only_tactile():
  assert set(sensor.DEFERRED) == {int(_ST.TACTILE)}


def test_rangefinder_matches_jax():
  m, d, dj = stepped('sensors')
  c = columns(m, _ST.RANGEFINDER)
  got, want = d.sensordata[:, c].numpy(), np.asarray(dj.sensordata)[:, c]
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
  # every ray meets the floor
  assert np.all(got > 0.0)


def _contact_check(m, d, dj):
  c = columns(m, _ST.CONTACT)
  got = d.sensordata[:, c]
  want = torch.as_tensor(np.array(dj.sensordata)[:, c])
  agree = d.solver_niter == torch.as_tensor(np.array(dj.solver_niter))
  assert float(agree.float().mean()) >= parity.NITER_SHARE['contact']
  parity.check_world_scale(got[agree].T, want[agree].T, 'contact sensor')
  # found counts of the first sensor (the box's corners on the floor)
  # equal, with a box resting on three or four corners in some world
  np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0].numpy())
  assert float(got[:, 0].max()) >= 3.0


def test_contact_sensor_matches_jax():
  m, d, dj = stepped('contact_sensor')
  assert not m.con_compact
  _contact_check(m, d, dj)


@functools.lru_cache(maxsize=None)
def _compacted():
  mjm = mujoco.MjModel.from_xml_path(tio.FLUID_XML['contact_sensor'])
  mj = jio.put_model(mjm, nconmax={3: 3})
  m = tio.put_model(mjm, nconmax={3: 3}, device='cpu')
  return mj, m, fast_compile(lambda x: jfwd.step(mj, x),
                             jio.make_data(mj, nworld=W))


def test_contact_sensor_compacted_matches_jax():
  mj, m, step = _compacted()
  assert m.con_compact and m.ncon == 3
  qpos, qvel, ctrl = seeded(m, 'contact_sensor', W, 7)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  d1, dj1 = forward.step(m, d), step(dj)
  # the slots hold different candidates across worlds
  cand = d1.contact.cand.numpy()
  assert len({tuple(r) for r in cand}) > 1
  np.testing.assert_array_equal(cand, np.asarray(dj1.contact.cand))
  _contact_check(m, d1, dj1)


def test_geom_distance_matches_jax():
  m, d, dj = stepped('geomdist')
  cols = np.concatenate([columns(m, t) for t in
                         (_ST.GEOMDIST, _ST.GEOMNORMAL, _ST.GEOMFROMTO)])
  got = d.sensordata[:, cols].numpy()
  want = np.asarray(dj.sensordata)[:, cols]
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
  # some distances below their cutoff, some held to it
  dist = d.sensordata[:, columns(m, _ST.GEOMDIST)].numpy()
  cut = types.host(m.sensor_cutoff)[np.asarray(m.sensor_type) ==
                                    _ST.GEOMDIST]
  assert np.any(dist < cut) and np.any(np.isclose(dist, cut))


def test_fromto_and_normal_cutoff_follows_jax():
  """The JAX package clamps every sensor with a cutoff to it
  (``sensor.py:802``), GEOMNORMAL's and GEOMFROMTO's vectors among them;
  MuJoCo C leaves those two types unclamped.  The port follows JAX: at
  geomdist.xml's qpos0 the pill-rod normal (cutoff 0.5) and the
  brick-ball segment (cutoff 0.2) read clamped where C's do not, and
  every other value of those sensors equals C's."""
  _, _, m = models('geomdist')
  mjm = mujoco.MjModel.from_xml_path(tio.FLUID_XML['geomdist'])
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  d = tio.put_data(mjm, mjd, m)
  d = sensor.sensor_pos(m, forward.pre(m, d))
  cols = np.concatenate([columns(m, t) for t in
                         (_ST.GEOMNORMAL, _ST.GEOMFROMTO)])
  got, c = d.sensordata[0, cols].numpy(), mjd.sensordata[cols]
  cut = np.concatenate([np.full(int(m.sensor_dim[i]), float(
      m.sensor_cutoff[i])) for t in (_ST.GEOMNORMAL, _ST.GEOMFROMTO)
      for i in np.nonzero(np.asarray(m.sensor_type) == t)[0]])
  clamped = np.abs(c) > cut
  assert clamped.any()
  np.testing.assert_allclose(got[clamped], np.sign(c[clamped]) *
                             cut[clamped], atol=1e-6)
  np.testing.assert_allclose(got[~clamped], c[~clamped], atol=1e-4)
