"""The port's fused step against the JAX fused step on the small gated
scenes of tests/test_fused.py: the implicitfast integrator (K4's damped
factor is the implicit solve) and JOINT equality rows (coupled
polynomial and constant target), 5 steps at 128 worlds at the bars of
test_fused.py (qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3 rtol 5e-3)."""

import mujoco
import numpy as np
import pytest

from tests.oracle import assert_close
from tests.test_fused import _EQJOINT, _IMPLICITFAST
from tests.test_torch_fused import run_steps
from tests.torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize('xml,seed,qpos_noise,ctrl_noise', [
    (_IMPLICITFAST, 5, 0.02, 0.5), (_EQJOINT, 9, 0.05, 0.3)],
                         ids=['implicitfast', 'eq_joint'])
def test_step_lane_small_scenes_match_jax(xml, seed, qpos_noise, ctrl_noise):
  st, sj = run_steps(mujoco.MjModel.from_xml_string(xml), None, 5, seed,
                     qpos_noise=qpos_noise, qvel_noise=0.3,
                     ctrl_noise=ctrl_noise)
  assert_close(st.qpos.numpy(), np.asarray(sj.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(st.qvel.numpy(), np.asarray(sj.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
