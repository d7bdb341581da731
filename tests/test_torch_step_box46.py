"""The port's fused step against the JAX fused step on the box scene of
tests/test_fused.py: plane-box, sphere-box and capsule-box colliders and
condim 4/6 rows, 3 steps at the bars of test_fused.py (qpos atol 2e-4
rtol 1e-3, qvel atol 5e-3 rtol 5e-3)."""

import mujoco
import numpy as np

from tests.oracle import assert_close
from tests.test_fused import _BOX46
from tests.test_torch_fused import run_steps
from tests.torch_threads import few_threads  # noqa: F401


def test_step_lane_box46_matches_jax():
  st, sj = run_steps(mujoco.MjModel.from_xml_string(_BOX46), None, 3, seed=0)
  assert_close(st.qpos.numpy(), np.asarray(sj.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(st.qvel.numpy(), np.asarray(sj.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
  assert int((st.solver_niter > 0).sum()) > 0
