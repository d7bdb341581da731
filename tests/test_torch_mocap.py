"""Mocap bodies in the port: kinematics, make_data / reset_data and the
public Data API.

- ``smooth.kinematics`` on mocap_arm at 8 worlds, each with its own
  seeded qpos, ``mocap_pos`` and (unnormalized) ``mocap_quat``, against
  the JAX ``kinematics`` under ``vmap``: every body, geom and site frame
  within atol 1e-6 + rtol 1e-4, and the mocap body at its world's mocap
  pose.
- A mocap body with a child body against MuJoCo C: the port places the
  child from the moved mocap frame, as ``mj_kinematics`` does, within
  1e-6.  The JAX ``kinematics`` applies the mocap override after every
  level (``smooth.py:101-106``), so its child stays where the un-moved
  frame puts it: that value is asserted as the reference's departure.
- ``make_data`` and ``reset_data`` take each mocap body's ``body_pos``
  and ``body_quat``, as C's ``mj_resetData`` does; the JAX ``make_data``
  gives zero ``mocap_pos`` (``io.py:1151``), asserted as the departure.
- ``put_data`` then ``get_data_into`` gives back MjData's mocap poses
  and its history (after C steps with a moving target) exactly.
"""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import smooth
from tests.oracle import assert_close
from tests.torch_threads import few_threads  # noqa: F401

W = 8
ATOL, RTOL = 1e-6, 1e-4
FRAMES = ('xpos', 'xquat', 'xmat', 'xipos', 'geom_xpos', 'geom_xmat',
          'site_xpos', 'site_xmat')
CHILD = """
<mujoco>
  <worldbody>
    <body name="target" mocap="true" pos="0.3 0 0.6">
      <geom type="sphere" size="0.05"/>
      <body name="child" pos="0.1 0 0">
        <joint type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.02"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""


@functools.lru_cache(maxsize=None)
def arm():
  mjm = mujoco.MjModel.from_xml_path(tio.ARM_XML['mocap_arm'])
  return mjm, jio.put_model(mjm), tio.put_model(mjm, device='cpu')


def seeded(m, seed=0):
  """World-major (qpos, mocap_pos, mocap_quat): qpos0 + 0.1 N on the
  arm's hinges, the mocap target moved by 0.1 N and turned by an
  unnormalized quaternion."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(types.host(m.qpos0, np.float32), (W, 1))
  qpos[:, :6] += 0.1 * rng.standard_normal((W, 6)).astype(np.float32)
  pos0, quat0 = (x.numpy() for x in tio.mocap_rest(m))
  mpos = (pos0 + 0.1 * rng.standard_normal((W, m.nmocap, 3))).astype(
      np.float32)
  mquat = (quat0 + 0.3 * rng.standard_normal((W, m.nmocap, 4))).astype(
      np.float32)
  return qpos, mpos, mquat


def test_kinematics_with_mocap_matches_jax():
  mjm, mj, m = arm()
  qpos, mpos, mquat = seeded(m)
  t = torch.as_tensor
  d = smooth.kinematics(m, tio.make_data(m, W, device='cpu').replace(
      qpos=t(qpos), mocap_pos=t(mpos), mocap_quat=t(mquat)))
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), mocap_pos=jnp.asarray(mpos),
      mocap_quat=jnp.asarray(mquat))
  dj = jax.jit(jax.vmap(lambda x: jsmooth.kinematics(mj, x)))(dj)
  for k in FRAMES:
    assert_close(getattr(d, k).numpy(), np.asarray(getattr(dj, k)), k,
                 ATOL, RTOL)
  b = int(np.nonzero(np.asarray(m.body_mocapid) >= 0)[0][0])
  np.testing.assert_allclose(d.xpos[:, b].numpy(), mpos[:, 0], atol=1e-7)
  unit = mquat[:, 0] / np.linalg.norm(mquat[:, 0], axis=-1, keepdims=True)
  np.testing.assert_allclose(d.xquat[:, b].numpy(), unit, atol=1e-6)


def test_mocap_child_follows_c():
  """The child of a moved mocap body: the port equals ``mj_kinematics``;
  the JAX value is the un-moved frame's (0.4, 0, 0.6)."""
  mjm = mujoco.MjModel.from_xml_string(CHILD)
  mjd = mujoco.MjData(mjm)
  mjd.mocap_pos[0] = (1.0, 0.5, 0.2)
  mjd.mocap_quat[0] = np.array([0.9, 0.1, 0.3, -0.2]) / np.linalg.norm(
      [0.9, 0.1, 0.3, -0.2])
  mjd.qpos[0] = 0.3
  mujoco.mj_kinematics(mjm, mjd)
  m = tio.put_model(mjm, device='cpu')
  d = smooth.kinematics(m, tio.put_data(mjm, mjd, m))
  for k in ('xpos', 'xquat', 'xmat', 'geom_xpos'):
    np.testing.assert_allclose(getattr(d, k)[0].numpy().reshape(-1),
                               getattr(mjd, k).reshape(-1), atol=1e-6,
                               err_msg=k)
  mj = jio.put_model(mjm)
  dj = jsmooth.kinematics(mj, jio.put_data(mjm, mjd, mj))
  np.testing.assert_allclose(np.asarray(dj.xpos[2]), (0.4, 0.0, 0.6),
                             atol=1e-6)
  assert np.abs(mjd.xpos[2] - (0.4, 0.0, 0.6)).max() > 0.5


def test_make_and_reset_data_mocap_follow_c():
  """make_data's and reset_data's mocap poses are mj_resetData's; the JAX
  make_data's mocap_pos is zero.  reset_data with a mask resets only the
  masked worlds' mocap poses and histories."""
  mjm, mj, m = arm()
  mjd = mujoco.MjData(mjm)
  mujoco.mj_resetData(mjm, mjd)
  d = tio.make_data(m, W, device='cpu')
  for k in ('mocap_pos', 'mocap_quat'):
    got = getattr(d, k).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(getattr(mjd, k),
                                                    got.shape),
                               atol=1e-7, err_msg=k)
  dj = jio.make_data(mj, nworld=W)
  assert float(np.abs(np.asarray(dj.mocap_pos)).max()) == 0.0
  assert float(np.abs(mjd.mocap_pos).max()) > 0.5
  qpos, mpos, mquat = seeded(m, 1)
  t = torch.as_tensor
  moved = d.replace(mocap_pos=t(mpos), mocap_quat=t(mquat),
                    history=d.history + 1.0)
  mask = torch.tensor([True, False] * (W // 2))
  r = tio.reset_data(m, moved, mask)
  for k in ('mocap_pos', 'mocap_quat', 'history'):
    np.testing.assert_array_equal(getattr(r, k)[mask].numpy(),
                                  getattr(d, k)[mask].numpy(), err_msg=k)
    np.testing.assert_array_equal(getattr(r, k)[~mask].numpy(),
                                  getattr(moved, k)[~mask].numpy(),
                                  err_msg=k)
  full = tio.reset_data(m, moved)
  np.testing.assert_array_equal(full.mocap_pos.numpy(), d.mocap_pos.numpy())


def test_put_data_get_data_round_trip():
  """C steps with a moving target fill mocap and history; put_data then
  get_data_into a fresh MjData gives back the same mocap poses and
  history (float32: to the float32 value), and put_data's history holds
  C's float cursors."""
  mjm, _, m = arm()
  mjd = mujoco.MjData(mjm)
  for k in range(5):
    mjd.mocap_pos[0] = (0.55 + 0.01 * k, 0.02 * k, 0.55)
    mjd.ctrl[:] = 0.1 * k
    mujoco.mj_step(mjm, mjd)
  d = tio.put_data(mjm, mjd, m, 3)
  f32 = lambda x: np.asarray(x, np.float32).astype(np.float64)
  for k in ('mocap_pos', 'mocap_quat', 'history'):
    np.testing.assert_array_equal(getattr(d, k)[2].numpy(),
                                  f32(getattr(mjd, k)), err_msg=k)
  out = mujoco.MjData(mjm)
  tio.get_data_into(out, mjm, d, world=1)
  for k in ('mocap_pos', 'mocap_quat', 'history', 'ctrl', 'qpos'):
    np.testing.assert_array_equal(getattr(out, k), f32(getattr(mjd, k)),
                                  err_msg=k)
  adr = int(mjm.actuator_historyadr[0])
  assert float(d.history[0, adr + 1]) == float(mjd.history[adr + 1]) > 0
