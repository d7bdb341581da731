"""The general step on the tendon scenes against the JAX ``forward.step``
(batched, jitted, its jnp path on the CPU), from the same seeded state of
``parity.general_state`` at 16 worlds.

One stage at a time (one step, each field the step computes before it
integrates, from the same state): the tendons' ten_length, ten_J and
ten_velocity; the constraint rows (efc_J, efc_pos, efc_aref, efc_D,
efc_active: tendon limits, tendon friction and the tendon equality among
them); actuator_length, actuator_moment (the tendon transmission) and the
clamped actuator_force; qfrc_passive (tendon springs with their deadband
and dampers); qM after ``tendon_armature``; qfrc_bias after
``tendon_bias`` (its forward-mode ten_J-dot against JAX's jvp).  Each
elementwise within atol 1e-5 + rtol 1e-4 of JAX (qM and qfrc_bias: 1e-5
+ 1e-4 of the world's largest entry); each scene shows the branch it is
there for (an active tendon limit, the clamp, a nonzero armature term
and bias).  Then three steps, each from the state of the step before:
qpos and qvel at the bars of tests/test_torch_step_small.py (qpos atol
2e-4 rtol 1e-3, qvel atol 5e-3 rtol 5e-3), sensordata by
``parity.check_sensors`` and energy within 1e-4 + 1e-4.  A planted fault,
a flipped tendon-limit J sign, fails the row bar.

The JAX rows read the tendon friction rows' velocity from the Data's
ten_velocity, which its step sets only after the rows
(``constraint.py:607-616``, ``forward.py:746-748``): the value the Data
carries in.  The port's rows read this step's ten_J qvel, as MuJoCo C's
do (``test_torch_tendon_mix.py`` holds tendon_mix's friction row to
MuJoCo C).  So before each JAX step the test sets the JAX Data's
ten_velocity to this step's ten_J qvel, which makes the two steps the
same function."""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.kernels import lanes
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import constraint, forward, smooth
from mujoco_warp_tpu_torch.ops.util import ix
from tests.oracle import assert_close
from tests.torch_threads import few_threads  # noqa: F401

W = 16
# tendon_mix's tests are in test_torch_tendon_mix.py, beside these on
# another worker: its compiles take most of a minute
SCENES = tio.TENDON_DMC + ('sensors2', 'tendon_wrap')
ATOL, RTOL = 1e-5, 1e-4
# the fields of one step checked elementwise against JAX
FIELDS = ('ten_length', 'ten_J', 'ten_velocity', 'efc_J', 'efc_pos',
          'efc_aref', 'efc_D', 'actuator_length', 'actuator_moment',
          'actuator_force', 'qfrc_actuator', 'qfrc_passive')


def fast_compile(fn, x):
  """``fn`` jitted for ``x`` with XLA's backend optimisations off: the
  compiles are most of this file's time, and the runs few."""
  return jax.jit(fn).lower(x).compile({'xla_backend_optimization_level': 0})


@functools.lru_cache(maxsize=None)
def case(scene):
  """(JAX Model, port Model, JAX step, JAX ten_velocity fn) of a scene."""
  if scene in tio.TENDON_DMC:
    pytest.importorskip('dm_control')
    mjm = tio.load_dmc(scene)
  else:
    mjm = mujoco.MjModel.from_xml_path(tio.TENDON_XML[scene])
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  dj = jio.make_data(mj, nworld=W)
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)

  def ten_vel(x):
    x = jsmooth.tendon(mj, jsmooth.com_pos(mj, jsmooth.kinematics(mj, x)))
    return x.ten_J @ x.qvel
  vel = fast_compile(jax.vmap(ten_vel), dj)
  return mjm, mj, m, step, vel


def start(scene, seed=3):
  """The seeded state on both sides: (JAX Data, port Data)."""
  mjm, mj, m, _, _ = case(scene)
  qpos, qvel, ctrl = parity.general_state(m, W, seed)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  return dj, d


def jax_step(scene, dj):
  """One JAX step, its Data's ten_velocity set to this step's first."""
  _, _, _, step, vel = case(scene)
  return step(dj.replace(ten_velocity=vel(dj)))


def world_scale(got, want, name):
  """Within ATOL + RTOL of each world's largest |JAX| entry."""
  want = np.asarray(want, np.float64)
  scale = np.abs(want).reshape(want.shape[0], -1).max(1)
  err = np.abs(got - want).reshape(want.shape[0], -1).max(1)
  assert np.all(err <= ATOL + RTOL * scale), (name, err.max())


def check_stage(scene, d, dj):
  m = case(scene)[2]
  for k in FIELDS:
    if getattr(d, k) is None or getattr(d, k).numel() == 0:
      continue
    assert_close(getattr(d, k).numpy(), np.asarray(getattr(dj, k)), k,
                 ATOL, RTOL)
  if m.nefc:
    np.testing.assert_array_equal(d.efc_active.numpy(),
                                  np.asarray(dj.efc_active))
  world_scale(d.qM.numpy(), dj.qM, 'qM')
  world_scale(d.qfrc_bias.numpy(), dj.qfrc_bias, 'qfrc_bias')


@pytest.mark.parametrize('scene', SCENES)
def test_one_step_stage_by_stage(scene):
  dj, d = start(scene)
  m = case(scene)[2]
  d1, dj1 = forward.step(m, d), jax_step(scene, dj)
  check_stage(scene, d1, dj1)
  lay = m.efc
  if len(lay.lim_ten_id):  # a tendon limit row is active in some world
    assert bool(d1.efc_active[:, ix(lay.lim_ten_adr, 'cpu')].any())
  if np.any(m.tendon_actfrclimited):  # the clamp engages
    u = np.nonzero(m.actuator_trntype == types.TrnType.TENDON)[0]
    tot = d1.actuator_force[:, u].sum(-1)
    hi = float(types.host(m.tendon_actfrcrange)[0, 1])
    assert bool((tot.abs() >= hi - 1e-5).any())
  if smooth._has_tendon_armature(m):
    # the armature term and its bias are there, and past the bar
    d0 = forward.pre(m, d)
    bare = kmass.mass_chain_plain(m, lanes(d0.cinert, 36 * m.nbody),
                                  lanes(d0.cdof, 6 * m.nv), lanes(d0.qvel))
    qM0, bias0 = bare[0].numpy(), bare[4].T.numpy()
    assert np.abs(d1.qM.numpy() - qM0).max() > 1e-3
    assert np.abs(d1.qfrc_bias.numpy() - bias0).max() > 1e-4


def test_planted_limit_sign_fault_fails_the_bar(monkeypatch):
  """A flipped J sign on the tendon limit rows moves ball_in_cup's efc_J
  past the bar: the bar can fail."""
  dj, d = start('ball_in_cup')
  m = case('ball_in_cup')[2]
  good = constraint._limit_tendon

  def flipped(m, d, rows):
    good(m, d, rows)
    adr = ix(m.efc.lim_ten_adr, 'cpu')
    rows.J[:, adr] = -rows.J[:, adr]
  monkeypatch.setattr(constraint, '_limit_tendon', flipped)
  d1, dj1 = forward.step(m, d), jax_step('ball_in_cup', dj)
  with pytest.raises(AssertionError, match='efc_J'):
    check_stage('ball_in_cup', d1, dj1)


@pytest.mark.parametrize('scene', SCENES)
def test_three_steps_match_jax(scene):
  dj, d = start(scene, seed=5)
  m = case(scene)[2]
  for _ in range(3):
    dj, d = jax_step(scene, dj), forward.step(m, d)
    if m.nsensor:
      parity.check_sensors(m, d.sensordata, np.asarray(dj.sensordata),
                           d.solver_niter, np.asarray(dj.solver_niter))
    if m.opt.enableflags & types.EnableBit.ENERGY:
      np.testing.assert_allclose(d.energy.numpy(), np.asarray(dj.energy),
                                 atol=1e-4, rtol=1e-4)
    assert_close(d.qpos.numpy(), np.asarray(dj.qpos), 'qpos', atol=2e-4,
                 rtol=1e-3)
    assert_close(d.qvel.numpy(), np.asarray(dj.qvel), 'qvel', atol=5e-3,
                 rtol=5e-3)


FREE_BALL = """
<mujoco>
  <worldbody>
    <site name="w0" pos="0 0 2"/>
    <site name="w1" pos="0.5 0 1.5"/>
    <body pos="0 0 1">
      <freejoint/>
      <geom type="box" size="0.1 0.05 0.05" mass="1"/>
      <site name="a" pos="0.1 0 0"/>
      <body pos="0.2 0 0">
        <joint type="ball"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
        <site name="b" pos="0.3 0 0.02"/>
        <body pos="0.3 0 0">
          <joint type="hinge" axis="0 1 0"/>
          <joint type="slide" axis="1 0 0"/>
          <geom type="sphere" size="0.03"/>
          <site name="c" pos="0.05 0.01 0"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial armature="0.1">
      <site site="w0"/><site site="a"/><site site="b"/>
    </spatial>
    <spatial armature="0.05">
      <site site="w1"/><site site="c"/><pulley divisor="3"/>
      <site site="a"/><site site="c"/>
    </spatial>
  </tendon>
</mujoco>"""


def test_tendon_bias_matches_jax_on_free_and_ball_joints():
  """The analytic ten_J-dot of ``smooth.tendon_bias`` against JAX's jvp
  where the tendons' sites ride free, ball, hinge and slide joints, two
  tendons with armature, one over a pulley: qM and qfrc_bias after the
  mass chain within 1e-5 + 1e-4 of each world's largest entry, and the
  bias term itself past that bar (the check has teeth)."""
  mjm = mujoco.MjModel.from_xml_string(FREE_BALL)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, qvel, _ = parity.general_state(m, W, 7)
  qvel = 5.0 * qvel
  dj = jio.make_data(mj, nworld=W).replace(qpos=jnp.asarray(qpos),
                                           qvel=jnp.asarray(qvel))

  def jax_side(x):
    x = jsmooth.tendon(mj, jsmooth.com_pos(mj, jsmooth.kinematics(mj, x)))
    x = jsmooth.tendon_armature(mj, jsmooth.crb(mj, x))
    x = jsmooth.rne(mj, jsmooth.com_vel(mj, x))
    return x.qM, x.qfrc_bias, jsmooth.tendon_bias(mj, x).qfrc_bias
  qM_j, bias0_j, bias_j = fast_compile(jax.vmap(jax_side), dj)(dj)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  d = forward.mass_chain(m, forward.pre(m, d))
  world_scale(d.qM.numpy(), qM_j, 'qM')
  world_scale(d.qfrc_bias.numpy(), bias_j, 'qfrc_bias')
  with pytest.raises(AssertionError, match='qfrc_bias'):
    world_scale(d.qfrc_bias.numpy(), bias0_j, 'qfrc_bias')
