"""The port's fused step against the JAX fused step on the benchmark
humanoid: 3 steps of ``step_lane`` at 128 worlds against
``fused.step_lane(..., interpret=True)``, at the bars of test_fused.py
(qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3 rtol 5e-3)."""

import numpy as np

from mujoco_warp_tpu import benchmarks
from mujoco_warp_tpu_torch import io as tio
from tests.oracle import assert_close
from tests.test_torch_fused import run_steps
from tests.torch_threads import few_threads  # noqa: F401


def test_step_lane_humanoid_matches_jax():
  st, sj = run_steps(benchmarks.load_humanoid_benchmark(),
                     tio.BENCH_NCONMAX, 3, seed=1)
  assert_close(st.qpos.numpy(), np.asarray(sj.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(st.qvel.numpy(), np.asarray(sj.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
  np.testing.assert_array_equal(st.overflow.numpy(), np.asarray(sj.overflow))
  np.testing.assert_array_equal(st.solver_niter.numpy(),
                                np.asarray(sj.solver_niter))
