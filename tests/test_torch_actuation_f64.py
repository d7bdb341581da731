"""The port's float64 actuation against MuJoCo C, as
``tests/test_torch_f64.py`` holds the humanoid: dcmotor.xml,
actuator_mix.xml and transmission.xml from a seeded state with
activation (qpos0 + 0.05 N, qvel 0.1 N, act 0.05 N, ctrl U(-0.8, 0.8)),
``put_data`` into a float64 Model, then port steps (the general step
through the plain versions on the CPU) against ``mujoco.mj_step``:
qpos, qvel and act within 1e-12 after one step and 1e-10 after 100.

On actuator_mix two actuators idle (ctrl 0, and act 0 where they have
one), each where the JAX package, which the port follows, departs from
MuJoCo C: the site actuator with a reference site (see
``tests/test_torch_actuation.py``) and the FILTEREXACT actuator with
actearly, whose input the JAX package takes as the next activation by
Euler where MuJoCo C takes it by the exact exponential;
``test_filterexact_actearly_follows_jax`` pins both values (ROADMAP
queue 3)."""

import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.torch_threads import few_threads  # noqa: F401

# actuator_mix's site actuator with a reference site and its FILTEREXACT
# actuator with actearly
REFSITE, FEXACT = 1, 4
IDLE = {'dcmotor': (), 'transmission': (), 'actuator_mix': (REFSITE, FEXACT)}


def _state(name, idle):
  mjm = mujoco.MjModel.from_xml_path(tio.ACT_XML[name])
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(7)
  mjd.qpos[:] = mjm.qpos0 + 0.05 * rng.standard_normal(mjm.nq)
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  mjd.qvel[:] = 0.1 * rng.standard_normal(mjm.nv)
  mjd.act[:] = 0.05 * rng.standard_normal(mjm.na)
  mjd.ctrl[:] = rng.uniform(-0.8, 0.8, mjm.nu)
  for u in idle:
    mjd.ctrl[u] = 0.0
    if mjm.actuator_actadr[u] >= 0:
      mjd.act[mjm.actuator_actadr[u]] = 0.0
  mujoco.mj_forward(mjm, mjd)
  return mjm, mjd


@pytest.mark.parametrize('name', sorted(IDLE))
def test_f64_actuation_is_per_step_exact(name):
  mjm, mjd = _state(name, IDLE[name])
  m = tio.put_model(mjm, device='cpu', dtype=torch.float64)
  d = tio.put_data(mjm, mjd, m)
  assert d.qpos.dtype == torch.float64
  for k in range(1, 101):
    mujoco.mj_step(mjm, mjd)
    d = forward.step(m, d)
    if k in (1, 100):
      bar = 1e-12 if k == 1 else 1e-10
      for f in ('qpos', 'qvel', 'act'):
        got, want = getattr(d, f)[0].numpy(), getattr(mjd, f)
        if want.size:
          assert np.abs(got - want).max() < bar, (k, f)
  if mjm.na:
    assert np.abs(mjd.act).max() > 1e-3


def test_filterexact_actearly_follows_jax():
  """actearly on a FILTEREXACT actuator: the port's force is gain times
  the next activation by Euler (act + h act_dot, the JAX package's
  ``fwd_actuation``), MuJoCo C's gain times the exact one (act + act_dot
  tau (1 - exp(-h / tau))); the two part by ~1e-5 here."""
  mjm, mjd = _state('actuator_mix', (REFSITE,))
  m = tio.put_model(mjm, device='cpu', dtype=torch.float64)
  d = forward.step(m, tio.put_data(mjm, mjd, m))
  u, a = FEXACT, int(mjm.actuator_actadr[FEXACT])
  assert mjm.actuator_dyntype[u] == mujoco.mjtDyn.mjDYN_FILTEREXACT
  assert mjm.actuator_actearly[u]
  gain, tau, h = (mjm.actuator_gainprm[u, 0], mjm.actuator_dynprm[u, 0],
                  mjm.opt.timestep)
  act, act_dot = mjd.act[a], mjd.act_dot[a]
  euler = gain * (act + h * act_dot)
  exact = gain * (act + act_dot * tau * (1.0 - np.exp(-h / tau)))
  assert float(d.actuator_force[0, u]) == pytest.approx(euler, abs=1e-12)
  assert mjd.actuator_force[u] == pytest.approx(exact, abs=1e-12)
  assert abs(euler - exact) > 1e-6
