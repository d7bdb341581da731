"""The general step's collision against the JAX package on
clutter_arm_nosleep: each collider group of the candidate table (the
eight primitive colliders and box-box MPR with its 4-point manifold)
against JAX ``collision_driver._narrowphase_candidates`` under ``vmap``,
at 64 worlds of the contact-rich state, after the same position stages.

Bar: the same live slots, and dist, pos and frame within ``ATOL`` of the
JAX values elementwise: 1e-5 for the primitive colliders (the same
float32 geometry summed in another order; they agree to 5e-7 at this
state), 1e-4 for box-box, whose normal comes from MPR's polish, a pattern
search whose last probes step by 1e-5 rad, so one probe accepted on one
side and not the other moves the frame by ~1e-5 (seen in 4 of 13,824
frame entries at this state).
"""

import functools

import jax
import numpy as np
import pytest

from mujoco_warp_tpu.ops import collision_driver as jcd
from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu_torch.ops import collision_driver, forward
from tests.test_torch_clutter_io import states
from tests.torch_threads import few_threads  # noqa: F401

ATOL = {'box-box': 1e-4}
_GT = {0: 'plane', 2: 'sphere', 3: 'capsule', 6: 'box'}
# the scene's pair groups, in slot order
GROUPS = ['plane-sphere', 'plane-capsule', 'plane-box', 'sphere-sphere',
          'sphere-capsule', 'sphere-box', 'capsule-capsule', 'capsule-box',
          'box-box']


@functools.lru_cache(maxsize=None)
def candidates():
  mj, m, dj, d = states(64, 1)
  dj = jax.jit(jax.vmap(lambda x: jcd._narrowphase_candidates(
      mj, jsmooth.com_pos(mj, jsmooth.kinematics(mj, x)))))(dj)
  got = collision_driver._narrowphase_candidates(m, forward.pre(m, d))
  return m, [a.numpy() for a in got], [np.asarray(a) for a in dj]


@pytest.mark.parametrize('group', GROUPS)
def test_collider_group_matches_jax(group):
  m, got, want = candidates()
  assert [f'{_GT[g[0]]}-{_GT[g[1]]}' for g in m.pair_groups] == GROUPS
  t1, t2, idx, slot = m.pair_groups[GROUPS.index(group)]
  s = slice(slot, slot + collision_driver.group_ncon(t1, t2) * len(idx))
  im = m.cand_includemargin.numpy()[s]
  live_got, live_want = got[0][:, s] < im, want[0][:, s] < im
  assert live_want.any(axis=1).mean() > 0.9, 'group without contacts'
  np.testing.assert_array_equal(live_got, live_want, err_msg=group)
  for name, a, b in zip(('dist', 'pos', 'frame'), got, want):
    np.testing.assert_allclose(a[:, s], b[:, s], atol=ATOL.get(group, 1e-5),
                               rtol=0.0,
                               err_msg=f'{group} {name}')


def test_box_support_tie_takes_the_plus_corner():
  """A zero direction component picks the + face, as ``jnp.sign`` with
  its 0 -> 1 rule does in the JAX support; other components follow their
  sign."""
  import torch
  from mujoco_warp_tpu_torch.ops import collision_convex
  size = torch.tensor([[0.1, 0.2, 0.3]])
  d = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, -0.0]])
  got = collision_convex._support_local(6, size, d)
  want = np.asarray([[0.1, -0.2, 0.3], [0.1, 0.2, 0.3]], np.float32)
  np.testing.assert_array_equal(got.numpy(), want)
