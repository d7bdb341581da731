"""The mocap slice as a whole: mocap_arm on the general step against the
JAX ``forward.step`` and MuJoCo C, and inverse dynamics on it.

mocap_arm (``assets/mocap_arm.xml``: a mocap target welded to the arm's
end-effector site, gravity compensation on every link and through the
shoulder's actuator, delayed position servos in all three interpolation
modes, a joint-in-parent actuator on the ball wrist, a tool hung from the
end effector by a site-anchored connect, a box on the floor, delayed
sensors and one sampled on an interval; IMPLICITFAST) at 8 worlds, each
from MuJoCo C's reset state (``io.put_data``: C's histories) moved to a
seeded pose, velocity, ctrl and mocap target.  20 steps, the target
driven along a seeded path and ctrl changed every step: against the JAX
step on the same inputs at parity's step bars (qpos, qvel and
sensordata), and world by world against ``mj_step`` within 5e-4 (qpos,
qvel, sensordata).  The sensor sampled on an interval without a delay
shows each new sample one step after C does (the JAX
``apply_sensor_delay`` reads its channel before it inserts, C shows the
fresh sample on its step): the port follows JAX there, and the test
asserts that lag against C.

Inverse dynamics on the same state at a seeded qacc against the JAX
``inverse`` under ``vmap``: qfrc_inverse and qfrc_constraint within 1e-5
+ 1e-4 of the world's largest entry.  ``seeded_c``, ``both`` and
``case`` serve ``tests/test_torch_gravcomp_site.py``.
"""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu.ops import inverse as jinv
from mujoco_warp_tpu.pallas import fused as jfused
from mujoco_warp_tpu_torch import benchmarks, fused, parity
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward, inverse
from tests.oracle import assert_close
from tests.test_torch_classic_step import fast_compile, world_scale
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

W = 8
NSTEP = 20
C_ATOL = 5e-4
# the state MjData carries that both sides take from it
_STATE = ('qpos', 'qvel', 'ctrl', 'mocap_pos', 'mocap_quat', 'history')


@functools.lru_cache(maxsize=None)
def case():
  """(MjModel, JAX Model, port Model); the port's is the committed
  snapshot of ``benchmarks.SCENES``, equal to ``put_model`` of the XML."""
  mjm = mujoco.MjModel.from_xml_path(tio.ARM_XML['mocap_arm'])
  m, w = benchmarks.load_scene('mocap_arm', device='cpu')
  assert w == 8192
  assert_models_equal(m, tio.put_model(mjm, device='cpu'))
  return mjm, jio.put_model(mjm), m


def seeded_c(seed=0):
  """W MjData, each from ``mj_resetData`` with the hinges moved by 0.2 N,
  the wrist turned, qvel 0.2 N on the arm, ctrl uniform in its range and
  the mocap target moved by 0.03 N, every value rounded to float32 so
  that all sides start from one state; then ``mj_forward``."""
  mjm, _, _ = case()
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(W):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:6] += 0.2 * rng.standard_normal(6)
    q = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.standard_normal(4)
    mjd.qpos[6:10] = q / np.linalg.norm(q)
    mjd.qvel[:9] = 0.2 * rng.standard_normal(9)
    lo, hi = mjm.actuator_ctrlrange.T
    mjd.ctrl[:] = rng.uniform(lo, hi)
    mjd.mocap_pos[:] += 0.03 * rng.standard_normal((mjm.nmocap, 3))
    for k in _STATE:
      getattr(mjd, k)[:] = np.float32(getattr(mjd, k))
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return out


def both(mjds):
  """(JAX Data, port Data) of the W MjData's states."""
  mjm, mj, m = case()
  kw = {k: np.stack([getattr(x, k) for x in mjds]).astype(np.float32)
        for k in _STATE}
  d = tio.put_data(mjm, mjds[0], m, W).replace(
      **{k: torch.as_tensor(v) for k, v in kw.items()})
  dj = jio.put_data(mjm, mjds[0], mj, nworld=W).replace(
      **{k: jnp.asarray(v) for k, v in kw.items()})
  return dj, d


def _interval_cols(m):
  """sensordata columns of the sensors sampled on an interval."""
  ids = np.nonzero(np.asarray(m.sensor_interval)[:, 0] > 0)[0]
  return np.concatenate([int(m.sensor_adr[s]) + np.arange(
      int(m.sensor_dim[s])) for s in ids])


def test_mocap_arm_steps_match_jax_and_c():
  mjm, mj, m = case()
  assert forward.unsupported(m) is None and forward.solve_kernel_runs(m)
  # the fused gate refuses it, as the JAX gate does
  assert fused.reason(m) is not None and not jfused.supported_features(mj)
  mjds = seeded_c()
  dj, d = both(mjds)
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  rng = np.random.default_rng(7)
  path = 0.02 * rng.standard_normal((NSTEP, W, m.nmocap, 3))
  ctrl_path = rng.uniform(-0.5, 0.5, (NSTEP, W, m.nu))
  icol = _interval_cols(m)
  keep = np.setdiff1d(np.arange(m.nsensordata), icol)
  lag = 0.0
  for k in range(NSTEP):
    mpos = (d.mocap_pos.numpy() + path[k]).astype(np.float32)
    ctrl = ctrl_path[k].astype(np.float32)
    d = forward.step(m, d.replace(mocap_pos=torch.as_tensor(mpos),
                                  ctrl=torch.as_tensor(ctrl)))
    dj = step(dj.replace(mocap_pos=jnp.asarray(mpos),
                         ctrl=jnp.asarray(ctrl)))
    for w, mjd in enumerate(mjds):
      mjd.mocap_pos[:] = mpos[w]
      mjd.ctrl[:] = ctrl[w]
      mujoco.mj_step(mjm, mjd)
    assert_close(d.qpos.numpy(), np.asarray(dj.qpos), f'qpos {k}',
                 parity.QPOS_ATOL, parity.QPOS_RTOL)
    assert_close(d.qvel.numpy(), np.asarray(dj.qvel), f'qvel {k}', 5e-3,
                 5e-3)
    parity.check_sensors(m, d.sensordata, np.asarray(dj.sensordata),
                         d.solver_niter, np.asarray(dj.solver_niter))
    np.testing.assert_array_equal(d.solver_niter.numpy() > 0, True)
    for name in ('qpos', 'qvel'):
      np.testing.assert_allclose(
          getattr(d, name).numpy(), np.stack([getattr(x, name)
                                              for x in mjds]),
          atol=C_ATOL, err_msg=f'{name} against C at step {k}')
    sc = np.stack([x.sensordata for x in mjds])
    np.testing.assert_allclose(d.sensordata.numpy()[:, keep], sc[:, keep],
                               atol=C_ATOL, err_msg=f'sensordata {k}')
    lag = max(lag, float(np.abs(d.sensordata.numpy()[:, icol] -
                                sc[:, icol]).max()))
  # the mocap body sits at each world's target; the arm followed it
  b = int(np.nonzero(np.asarray(m.body_mocapid) >= 0)[0][0])
  np.testing.assert_allclose(d.xpos[:, b].numpy(), d.mocap_pos[:, 0].numpy(),
                             atol=1e-7)
  assert lag > 1e-3
  assert int(d.overflow.max()) == 0


def test_inverse_on_mocap_arm_matches_jax():
  """qfrc_inverse and qfrc_constraint at a seeded qacc (0.5 N)."""
  _, mj, m = case()
  dj, d = both(seeded_c(3))
  qacc = (0.5 * np.random.default_rng(3).standard_normal(
      (W, m.nv))).astype(np.float32)
  dj = dj.replace(qacc=jnp.asarray(qacc))
  d = d.replace(qacc=torch.as_tensor(qacc))
  got = inverse.inverse(m, d)
  want = fast_compile(jax.vmap(lambda x: jinv.inverse(mj, x)), dj)(dj)
  for k in ('qfrc_inverse', 'qfrc_constraint'):
    world_scale(getattr(got, k).numpy(), getattr(want, k), k)
  assert float(got.qfrc_constraint.abs().max()) > 1e-3
