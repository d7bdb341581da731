"""Three general steps of the port against the JAX ``forward.step`` on
clutter_arm_nosleep at 128 worlds of the contact-rich state, on the CPU
(the JAX step takes ``_step_batched``'s jnp branches there, the port the
plain versions of its kernels: the big-tree mass chain, ``chol_batched``,
``chol_solve`` and ``damped_solve``).  Each step starts from the JAX
state of the step before, so contact chaos does not compound.  Bars of
``tests/test_fused.py:138-139``: qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3
rtol 5e-3; no overflow on either side, the same live contacts.
"""

import jax
import numpy as np
import torch

from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_clutter_io import states
from tests.torch_threads import few_threads  # noqa: F401


def test_three_clutter_steps_match_jax():
  mj, m, dj, _ = states(128, 4)
  step = jax.jit(lambda x: jfwd.step(mj, x))
  for _ in range(3):
    d = tio.make_data(m, 128, device='cpu').replace(**{
        k: torch.as_tensor(np.array(getattr(dj, k))) for k in
        ('time', 'qpos', 'qvel', 'ctrl', 'qacc_warmstart')})
    dj, d = step(dj), forward.step(m, d)
    assert_close(d.qpos.numpy(), np.asarray(dj.qpos), 'qpos', atol=2e-4,
                 rtol=1e-3)
    assert_close(d.qvel.numpy(), np.asarray(dj.qvel), 'qvel', atol=5e-3,
                 rtol=5e-3)
    np.testing.assert_allclose(d.time.numpy(), np.asarray(dj.time),
                               rtol=1e-6)
    np.testing.assert_array_equal(d.ncon_active.numpy(),
                                  np.asarray(dj.ncon_active))
    assert int(d.overflow.max()) == 0
    assert int(np.asarray(dj.overflow).max()) == 0
  assert float(d.solver_niter.float().mean()) > 1.0
