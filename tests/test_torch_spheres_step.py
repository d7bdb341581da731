"""Three general steps of the port against the JAX ``forward.step`` on
the spheres scenes, pyramidal and elliptic, at 128 worlds of the seeded
contact state ``parity.spheres_state``, on the CPU.

The JAX step runs as it runs on the TPU for these scenes, its Newton
solve through the Pallas solver kernel (``ops/solver.py``
``solve_batched`` :704 takes it when ``psolver.supported``), here in
interpret mode; its other stages take ``_step_batched``'s jnp branches.
(Its jnp Newton, which a CPU would otherwise take, hits its iteration cap
in about one world in eight of the elliptic state: ``parity``.)  The port
runs the plain versions of its kernels.  Each step starts from the JAX
state of the step before, so contact chaos does not compound.  Bars of
``tests/test_fused.py:138-139``: qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3
rtol 5e-3; no overflow on either side, the same live contacts.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu.pallas import solver as psolver
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_spheres_io import CONES, states
from tests.torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize('scene', sorted(CONES))
def test_three_spheres_steps_match_jax(scene, monkeypatch):
  monkeypatch.setattr(psolver, 'supported', lambda m, d: True)
  monkeypatch.setattr(psolver, 'solve_batched', functools.partial(
      psolver.solve_batched, interpret=True))
  mj, m, dj, _ = states(scene, psolver.TILE_W, 4)
  W = dj.qpos.shape[0]
  step = jax.jit(lambda x: jfwd.step(mj, x))
  for _ in range(3):
    d = tio.make_data(m, W, device='cpu').replace(**{
        k: torch.as_tensor(np.array(getattr(dj, k))) for k in
        ('time', 'qpos', 'qvel', 'ctrl', 'qacc_warmstart')})
    dj, d = step(dj), forward.step(m, d)
    assert_close(d.qpos.numpy(), np.asarray(dj.qpos), 'qpos', atol=2e-4,
                 rtol=1e-3)
    assert_close(d.qvel.numpy(), np.asarray(dj.qvel), 'qvel', atol=5e-3,
                 rtol=5e-3)
    np.testing.assert_array_equal(d.ncon_active.numpy(),
                                  np.asarray(dj.ncon_active))
    assert int(d.overflow.max()) == 0
    assert int(np.asarray(dj.overflow).max()) == 0
  assert float(d.ncon_active.float().mean()) > 8.0
  assert float(d.solver_niter.float().mean()) > 2.0
