"""The port's fused step on dm_control's walker, cheetah, hopper and
humanoid (humanoid_dmc at its {1: 16, 3: 32} contact budget) against the
JAX fused step (``step_lane(..., interpret=True)``): 5 steps at 64
worlds from qpos0 + 0.01 N, at the bars of tests/test_torch_step_small.py
(qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3 rtol 5e-3).  The sensors ride
along unevaluated on both sides."""

import numpy as np
import pytest

pytest.importorskip('dm_control')

from mujoco_warp_tpu_torch import io as tio  # noqa: E402
from tests.oracle import assert_close  # noqa: E402
from tests.test_torch_fused import run_steps  # noqa: E402
from tests.torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize('scene', sorted(tio.DMC_NCONMAX))
def test_fused_step_matches_jax(scene):
  st, sj = run_steps(tio.load_dmc(scene), tio.DMC_NCONMAX[scene], 5, 21,
                     nworld=64, jit=True)
  assert_close(st.qpos.numpy(), np.asarray(sj.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(st.qvel.numpy(), np.asarray(sj.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
  assert int(st.overflow.max()) == 0 and int(np.asarray(sj.overflow).max()) == 0
