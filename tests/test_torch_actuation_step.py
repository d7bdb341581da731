"""The general step on dm_control's quadruped (nv 22, 12 FILTER actuators
on tendons and joints, 4 tendon equalities, 175 contact candidates,
pyramidal rows through the solve kernel at nefc 300) against the JAX
``forward.step`` from the seeded contact state of ``parity.dmc_state``
(the root lowered by ``parity.DMC_DROP``) at 16 worlds, with the helpers
and bars of ``tests/test_torch_classic_step.py``: one step stage by stage
(rows, actuator forces, qfrc_passive, qM, qfrc_bias; act_dot and act
within 1e-5 + 1e-5), then three steps (qpos, qvel, act, sensordata)."""

import numpy as np

from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_classic_step import case, check_stage, check_state, \
    start
from tests.torch_threads import few_threads  # noqa: F401

SCENE = 'quadruped'


def test_quadruped_one_step_stage_by_stage():
  dj, d = start(SCENE)
  _, _, m, step = case(SCENE)
  assert (m.nv, m.nu, m.na, m.ncon, m.nefc) == (22, 12, 12, 175, 300)
  assert forward.solve_kernel_runs(m) and not m.con_compact
  d1, dj1 = forward.step(m, d), step(dj)
  check_stage(m, d1, dj1)
  check_state(m, d1, dj1)
  for k in ('act_dot', 'act'):
    assert_close(getattr(d1, k).numpy(), np.asarray(getattr(dj1, k)), k,
                 1e-5, 1e-5)
  # feet on the floor in every world, the FILTER activations moving
  assert bool((d1.ncon_active > 0).all())
  assert float(d1.act_dot.abs().max()) > 0.1
  assert np.all(m.actuator_dyntype == types.DynType.FILTER)


def test_quadruped_three_steps_match_jax():
  dj, d = start(SCENE, seed=5)
  _, _, m, step = case(SCENE)
  for _ in range(3):
    dj, d = step(dj), forward.step(m, d)
    check_state(m, d, dj)
    assert_close(d.act.numpy(), np.asarray(dj.act), 'act', 1e-5, 1e-5)
  assert int(d.overflow.max()) == 0
