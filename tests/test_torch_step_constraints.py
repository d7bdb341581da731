"""Three general steps of the port against the JAX ``forward.step`` on the
constraints scene at 128 worlds, on the CPU (the JAX step takes
``_step_batched``'s jnp branches there, the port the plain versions of
its four kernels).  The JAX Euler solves the damped system tree-blocked,
the port whole: equal in exact arithmetic.  Bars of
``tests/test_fused.py:138-139``: qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3
rtol 5e-3.
"""

import jax
import numpy as np
import torch

from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_smooth import states
from tests.torch_threads import few_threads  # noqa: F401


def test_three_steps_match_jax():
  mj, m, dj, d = states(128, 4)
  d = d.replace(qacc_warmstart=torch.zeros_like(d.qvel))
  step = jax.jit(lambda x: jfwd.step(mj, x))
  for _ in range(3):
    dj = step(dj)
    d = forward.step(m, d)
  assert_close(d.qpos.numpy(), np.asarray(dj.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(d.qvel.numpy(), np.asarray(dj.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
  np.testing.assert_allclose(d.time.numpy(), np.asarray(dj.time), rtol=1e-6)
  assert int(d.overflow.max()) == 0 and int(np.asarray(dj.overflow).max()) == 0
