"""The general step on ``tendon_mix`` (every tendon feature the port
runs) against the JAX ``forward.step``: the tests of
``test_torch_tendon_step.py`` on this scene (one stage at a time, then
three steps, at the bars stated there), and its tendon friction row
against MuJoCo C."""

import mujoco
import numpy as np
import pytest

from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_tendon_step import case, start
from tests.test_torch_tendon_step import test_one_step_stage_by_stage as \
    one_step
from tests.test_torch_tendon_step import test_three_steps_match_jax as \
    three_steps
from tests.torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize('test', [one_step, three_steps],
                         ids=['one_step_stage_by_stage', 'three_steps'])
def test_tendon_mix_matches_jax(test):
  test('tendon_mix')


def test_tendon_friction_row_reads_this_steps_velocity():
  """tendon_mix's tendon friction row (on "bend") against MuJoCo C on one
  world: its aref = -b (ten_J qvel) of this step, as the port computes it,
  where the JAX row reads the Data's ten_velocity (zeros at the start)."""
  mjm, mj, m, _, _ = case('tendon_mix')
  dj, d = start('tendon_mix')
  d1 = forward.step(m, d)
  dj1 = case('tendon_mix')[3](dj)  # ten_velocity as make_data leaves it
  row = int(m.efc.fri_ten_adr[0])
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = (d.qpos[0].numpy(),
                                          d.qvel[0].numpy(),
                                          d.ctrl[0].numpy())
  mujoco.mj_forward(mjm, mjd)
  c_row = int(np.nonzero(mjd.efc_type ==
                         mujoco.mjtConstraint.mjCNSTR_FRICTION_TENDON)[0][0])
  np.testing.assert_allclose(float(d1.efc_aref[0, row]),
                             mjd.efc_aref[c_row], rtol=1e-4, atol=1e-5)
  assert abs(float(np.asarray(dj1.efc_aref)[0, row]) -
             mjd.efc_aref[c_row]) > 1e-3
