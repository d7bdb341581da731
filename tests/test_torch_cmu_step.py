"""The general step on dm_control's humanoid_CMU (nv 62: the mass
chain's large-tree form, ``chol_batched`` at n 62 and the torch Newton,
nefc 248 x nv 62 beyond the solve kernel; ellipsoids; 1157 candidates
compacted into JAX's default budget of 48 slots) against the JAX
``forward.step`` at 64 worlds of ``parity.dmc_state`` (lying on the
floor, lowered 0.1 m: ~5 live contacts per world), one step stage by
stage and three steps, at the bars of
``tests/test_torch_classic_step.py``; the live contact slots hold the
same candidates in the same order as JAX's.  64 worlds, not the other
scenes' 16: ``parity.check_sensors`` holds the share of worlds whose
Newton counts agree (0.85 with contacts), and two correct Newtons differ
by an iteration in 4-13% of contact worlds (ROADMAP queue 3), one world
in 16 being 6%; at 16 worlds this state had 3 such worlds on the second
step, its qacc within 7.7e-5 of the world's scale."""

import numpy as np

from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_classic_step import case, one_step, start, \
    three_steps
from tests.torch_threads import few_threads  # noqa: F401

NWORLD = 64


def test_one_step_stage_by_stage():
  m, d = one_step('humanoid_CMU', NWORLD)
  assert (m.nv, m.ncand, m.ncon, m.nefc) == (62, 1157, 48, 248)
  assert m.con_compact and kmass.big_tree(m) and forward.large_system(m)
  assert float(d.ncon_active.float().mean()) > 2.0


def test_contact_slots_match_jax():
  _, _, m, step = case('humanoid_CMU', NWORLD)
  dj, d = start('humanoid_CMU', nworld=NWORLD)
  d1, dj1 = forward.step(m, d), step(dj)
  np.testing.assert_array_equal(d1.contact.cand.numpy(),
                                np.asarray(dj1.contact.cand))
  np.testing.assert_array_equal(d1.ncon_active.numpy(),
                                np.asarray(dj1.ncon_active))


def test_three_steps_match_jax():
  three_steps('humanoid_CMU', NWORLD)
