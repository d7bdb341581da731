"""The delay histories (``ops/history.py``) against the JAX
``ops/history.py`` and MuJoCo C.

The six functions, each against the JAX function under ``vmap`` on the
same seeded inputs at 8 worlds, within atol 1e-6 + rtol 1e-4: a scene of
six actuators, zero-order hold, linear and cubic, each with a delay of a
whole number of timesteps (0.02 s of 0.01) and one that is not (0.015
s), and three sensors with delays in the three modes, one of them with
an interval of 0.03 s.  ``init_history`` fills every channel;
``insert_ctrl_history`` and ``apply_sensor_delay`` run a 12-step
sequence of seeded ctrl and sensordata at the float32 clock of a step
(t += h), their buffers equal to JAX's at every step, and
``read_ctrl_delayed`` reads each one; ``_read_channel`` and
``_insert_channel`` take times between samples, on them, before the
oldest and past the newest.

Then ``tests/test_history.py``'s scene (a delayed motor and a delayed
jointpos sensor) stepped 30 times from MuJoCo C's reset state
(``io.put_data``, C's history included) with the ctrl that test drives:
at float32 against the JAX step on identical inputs (qpos atol 1e-6,
sensordata and history atol 1e-5) and against ``mj_step`` within 5e-4,
and at float64 (``put_model(..., dtype=torch.float64)``) against
``mj_step`` step by step within 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu.ops import history as jhist
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward, history
from tests.oracle import assert_close
from tests.test_history import XML as STEP_XML
from tests.test_torch_classic_step import fast_compile
from tests.torch_threads import few_threads  # noqa: F401

W = 8
ATOL, RTOL = 1e-6, 1e-4
XML = """
<mujoco>
  <option timestep="0.01"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="a" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.4 0 0"/>
      <site name="tip" pos="0.4 0 0"/>
      <body pos="0.4 0 0">
        <joint name="b" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="a" delay="0.02" nsample="6"/>
    <motor joint="a" delay="0.02" nsample="6" interp="linear"/>
    <motor joint="b" delay="0.02" nsample="6" interp="cubic"/>
    <motor joint="a" delay="0.015" nsample="5"/>
    <motor joint="b" delay="0.015" nsample="5" interp="linear"/>
    <motor joint="b" delay="0.015" nsample="7" interp="cubic"/>
  </actuator>
  <sensor>
    <jointpos joint="a" delay="0.02" nsample="6" interp="cubic"/>
    <framepos objtype="site" objname="tip" delay="0.015" nsample="5"
              interp="linear"/>
    <jointvel joint="b" nsample="4" interval="0.03"/>
  </sensor>
</mujoco>"""
NSTEP = 12


@functools.lru_cache(maxsize=None)
def models():
  mjm = mujoco.MjModel.from_xml_string(XML)
  return mjm, jio.put_model(mjm), tio.put_model(mjm, device='cpu')


def _close(got, want, name):
  assert_close(got.numpy(), np.asarray(want), name, ATOL, RTOL)


def _vmapped(fn):
  return jax.jit(jax.vmap(fn))


@functools.lru_cache(maxsize=None)
def sequence():
  """Both sides through init_history and NSTEP steps of seeded ctrl and
  sensordata at the step's float32 clock: each step reads the delayed
  ctrl, applies the sensors' delays, then puts ctrl into the history, as
  the step orders them.  Returns the per-step outputs of each side."""
  mjm, mj, m = models()
  rng = np.random.default_rng(0)
  d = tio.make_data(m, W, device='cpu')
  dj = jio.make_data(mj, nworld=W)
  read_j = _vmapped(lambda x: jhist.read_ctrl_delayed(mj, x))
  sens_j = _vmapped(lambda x: jhist.apply_sensor_delay(mj, x))
  ins_j = _vmapped(lambda x: jhist.insert_ctrl_history(mj, x))
  h = np.float32(mjm.opt.timestep)
  out = [(d.history, np.asarray(dj.history))]
  for _ in range(NSTEP):
    ctrl = rng.standard_normal((W, m.nu)).astype(np.float32)
    sd = rng.standard_normal((W, m.nsensordata)).astype(np.float32)
    d = d.replace(ctrl=torch.as_tensor(ctrl), sensordata=torch.as_tensor(sd))
    dj = dj.replace(ctrl=jnp.asarray(ctrl), sensordata=jnp.asarray(sd))
    rc, rcj = history.read_ctrl_delayed(m, d), read_j(dj)
    d, dj = history.apply_sensor_delay(m, d), sens_j(dj)
    d, dj = history.insert_ctrl_history(m, d), ins_j(dj)
    out.append((rc, rcj, d.sensordata, dj.sensordata, d.history, dj.history))
    d = d.replace(time=d.time + h)
    dj = dj.replace(time=dj.time + h)
  return out


def test_init_history_matches_jax():
  """make_data fills every channel by init_history (the JAX make_data's
  prefill); from a seeded ctrl and sensordata both functions agree."""
  mjm, mj, m = models()
  assert m.nhistory == mjm.nhistory > 0
  d0, dj0 = sequence()[0]
  _close(d0, dj0, 'history of make_data')
  rng = np.random.default_rng(1)
  ctrl = rng.standard_normal((W, m.nu)).astype(np.float32)
  sd = rng.standard_normal((W, m.nsensordata)).astype(np.float32)
  d = tio.make_data(m, W, device='cpu').replace(
      ctrl=torch.as_tensor(ctrl), sensordata=torch.as_tensor(sd))
  dj = jio.make_data(mj, nworld=W).replace(ctrl=jnp.asarray(ctrl),
                                           sensordata=jnp.asarray(sd))
  _close(history.init_history(m, d).history,
         _vmapped(lambda x: jhist.init_history(mj, x))(dj).history,
         'init_history')


@pytest.mark.parametrize('fn', ['read_ctrl_delayed', 'apply_sensor_delay',
                                'insert_ctrl_history'])
def test_step_functions_match_jax(fn):
  """Each of the three step functions at every step of the sequence: the
  delayed ctrl of the six actuators (both delays, all three modes), the
  sensors' delayed readings and the history after their inserts (the
  interval sensor on and off its grid), and the history after the ctrl
  insert."""
  for k, (rc, rcj, sd, sdj, hist, histj) in enumerate(sequence()[1:]):
    if fn == 'read_ctrl_delayed':
      _close(rc, rcj, f'delayed ctrl, step {k}')
    elif fn == 'apply_sensor_delay':
      _close(sd, sdj, f'delayed sensordata, step {k}')
    else:
      _close(hist, histj, f'history, step {k}')
  # past the delays the reads hold the values put in before
  rc = sequence()[-1][0]
  assert float(rc.abs().min()) > 0.0


def test_channel_functions_match_jax():
  """``_read_channel`` of every actuator channel after the sequence, in
  each mode, at times between samples, on them, before the oldest and
  past the newest; ``_insert_channel`` of a value at a new time and at
  the newest sample's time (an overwrite)."""
  mjm, mj, m = models()
  hist = sequence()[-1][4]
  histj = jnp.asarray(hist.numpy())
  h = float(mjm.opt.timestep)
  t_end = float(NSTEP * np.float32(h))
  rng = np.random.default_rng(2)
  times = np.concatenate([[t_end - 0.5 * h, t_end - h, t_end - 3 * h,
                           -1.0, t_end + 1.0],
                          rng.uniform(t_end - 6 * h, t_end, 3)])
  tw = np.repeat(times.astype(np.float32)[:, None], W, 1)  # (T, W)
  for u in range(m.nu):
    n, interp = (int(x) for x in m.actuator_history[u])
    off = int(m.actuator_historyadr[u])
    for interp_u in (interp, (interp + 1) % 3, (interp + 2) % 3):
      got = torch.stack([history._read_channel(
          hist, off, n, 1, torch.as_tensor(t), interp_u) for t in tw])
      want = jax.jit(jax.vmap(jax.vmap(lambda x, tt: jhist._read_channel(
          x, off, n, 1, tt, interp_u)), in_axes=(None, 0)))(
              histj, jnp.asarray(tw))
      _close(got, want, f'read actuator {u} interp {interp_u} at {times}')
  s = 1  # the framepos channel: dim 3
  n, off = int(m.sensor_history[s, 0]), int(m.sensor_historyadr[s])
  val = rng.standard_normal((W, 3)).astype(np.float32)
  newest = float(NSTEP - 1) * np.float32(h)
  for t in (t_end + h, newest):
    tw = np.full(W, t, np.float32)
    got = history._insert_channel(hist, off, n, 3, torch.as_tensor(tw),
                                  torch.as_tensor(val))
    want = jax.vmap(lambda x, tt, v: jhist._insert_channel(
        x, off, n, 3, tt, v))(histj, jnp.asarray(tw), jnp.asarray(val))
    _close(got, want, f'insert at {t}')


def _step_case(dtype):
  mjm = mujoco.MjModel.from_xml_string(STEP_XML)
  m = tio.put_model(mjm, device='cpu', dtype=dtype)
  mjd = mujoco.MjData(mjm)
  return mjm, mjd, m, tio.put_data(mjm, mjd, m, W)


def test_history_scene_float32_matches_jax_and_c():
  """30 steps of the scene at float32 from C's reset state: the port
  against the JAX step on the same inputs, and against mj_step."""
  mjm, mjd, m, d = _step_case(torch.float32)
  mj = jio.put_model(mjm)
  dj = jio.put_data(mjm, mjd, mj, nworld=W)
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  for k in range(30):
    ctrl = np.float32(np.sin(0.7 * k) * 0.8)
    mjd.ctrl[:] = ctrl
    mujoco.mj_step(mjm, mjd)
    d = forward.step(m, d.replace(ctrl=torch.full_like(d.ctrl, ctrl)))
    dj = step(dj.replace(ctrl=jnp.full_like(dj.ctrl, ctrl)))
    assert_close(d.qpos.numpy(), np.asarray(dj.qpos), f'qpos {k}', 1e-6,
                 RTOL)
    assert_close(d.sensordata.numpy(), np.asarray(dj.sensordata),
                 f'sensordata {k}', 1e-5, RTOL)
    assert_close(d.history.numpy(), np.asarray(dj.history), f'history {k}',
                 1e-5, RTOL)
    for x, want in ((d.qpos, mjd.qpos), (d.sensordata, mjd.sensordata)):
      np.testing.assert_allclose(x.numpy(), np.broadcast_to(want, x.shape),
                                 atol=5e-4)


def test_history_scene_float64_matches_c_per_step():
  """The same 30 steps at float64 on the CPU path: qpos, qvel,
  sensordata and the whole history equal mj_step's within 1e-9 at every
  step (the delayed ctrl of C's own samples)."""
  mjm, mjd, m, d = _step_case(torch.float64)
  assert d.history.dtype == torch.float64
  for k in range(30):
    ctrl = np.sin(0.7 * k) * 0.8
    mjd.ctrl[:] = ctrl
    mujoco.mj_step(mjm, mjd)
    d = forward.step(m, d.replace(ctrl=torch.full_like(d.ctrl, ctrl)))
    for name in ('qpos', 'qvel', 'sensordata', 'history'):
      got, want = getattr(d, name).numpy(), getattr(mjd, name)
      np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                                 atol=1e-9, err_msg=f'{name} at step {k}')
