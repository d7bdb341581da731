"""The general step on dm_control's dog (nv 79, 62 bodies, 38 FILTER
actuators, 6273 contact candidates compacted into the default budget of
48 slots per condim class, nefc 793 x nv 79: the large-tree mass chain,
``chol_batched`` and the torch Newton) against the JAX ``forward.step``
from the seeded contact state of ``parity.dmc_state`` at 4 worlds (the
JAX step compiles once, ~1 min), with the helpers and bars of
``tests/test_torch_classic_step.py``: one step stage by stage (rows,
actuator forces, qfrc_passive, qM, qfrc_bias; act_dot and act within
1e-5 + 1e-5), qpos, qvel and sensordata after it."""

import numpy as np

from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_classic_step import case, check_stage, check_state, \
    start
from tests.torch_threads import few_threads  # noqa: F401

SCENE, W = 'dog', 4


def test_dog_one_step_matches_jax():
  dj, d = start(SCENE, nworld=W)
  _, mj, m, step = case(SCENE, W)
  assert (m.nv, m.nbody, m.na, m.ncand, m.ncon, m.nefc) == (
      79, 62, 38, 6273, 144, 793)
  assert m.con_compact and mj.ncon == m.ncon
  assert forward.large_system(m) and not kmass.factor_in_kernel(m)
  d1, dj1 = forward.step(m, d), step(dj)
  check_stage(m, d1, dj1)
  check_state(m, d1, dj1)
  for k in ('act_dot', 'act'):
    assert_close(getattr(d1, k).numpy(), np.asarray(getattr(dj1, k)), k,
                 1e-5, 1e-5)
  assert int((d1.ncon_active > 0).sum()) >= W - 1
  assert int(d1.overflow.max()) == 0
