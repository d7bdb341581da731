"""RK4 on the general step against the JAX ``forward.step`` (its
``rungekutta4``, each stage a full forward): dm_control's cartpole and
acrobot (plane-cylinder) at 16 worlds of ``parity.general_state``, one
step stage by stage and three steps, and the repo's ``pendula.xml`` set
to RK4 as ``tests/test_integrators.py`` sets it, three steps.  Bars of
``tests/test_torch_classic_step.py``.  The step keeps the t0 forward's
sensordata and Newton counts and takes the last stage's qacc and
warmstart, as JAX's does."""

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
from tests.test_torch_classic_step import W, case, check_state, \
    fast_compile, one_step, three_steps
from tests.torch_threads import few_threads  # noqa: F401

SCENES = ('cartpole', 'acrobot')
PENDULA = tio._MODELS + '/pendula.xml'


@pytest.mark.parametrize('scene', SCENES)
def test_one_step_stage_by_stage(scene):
  m, d = one_step(scene)
  assert m.opt.integrator == types.IntegratorType.RK4
  assert forward.unsupported(m) is None


@pytest.mark.parametrize('scene', SCENES)
def test_three_steps_match_jax(scene):
  three_steps(scene)


def test_rk4_keeps_the_t0_forward():
  """The step's sensordata and qacc_smooth are the t0 forward's, its qacc
  the last stage's (and its warmstart the same), and qpos moves by the
  weighted stage velocities: the t0 forward alone does not give it."""
  _, _, m, _ = case('cartpole')
  qpos, qvel, ctrl = parity.general_state(m, W, 9)
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(qpos=t(qpos), qvel=t(qvel),
                                                ctrl=t(ctrl))
  d0 = forward._forward(m, d)
  d1 = forward.step(m, d)
  np.testing.assert_array_equal(d1.qacc_smooth.numpy(),
                                d0.qacc_smooth.numpy())
  np.testing.assert_array_equal(d1.qacc_warmstart.numpy(), d1.qacc.numpy())
  assert float((d1.qacc - d0.qacc).abs().max()) > 1e-4
  euler = forward._advance(m, d0, d0.qacc)
  assert float((d1.qpos - euler.qpos).abs().max()) > 1e-6


def test_pendula_rk4_matches_jax():
  mjm = mujoco.MjModel.from_xml_path(PENDULA)
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, qvel, ctrl = parity.general_state(m, W, 11)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(qpos=t(qpos), qvel=t(qvel),
                                                ctrl=t(ctrl))
  for _ in range(3):
    dj, d = step(dj), forward.step(m, d)
    check_state(m, d, dj)
  assert_close(d.qacc.numpy(), np.asarray(dj.qacc), 'qacc', atol=5e-3,
               rtol=5e-3)
