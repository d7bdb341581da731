"""The port's constraint-island labeler (``ops/island.py``) against the
JAX ``island.island`` under ``vmap`` on the same ``efc_J``: nisland,
tree_island, dof_island and efc_island exactly equal.  Two scenes:
clutter_arm (sleep on) at 32 worlds of the seeded contact state of
``parity.clutter_state`` (every clutter body touching its neighbours and
the floor), and the five-body scene of ``tests/test_island.py`` (a
stack, a lone body, one in flight, a hinge at its limit) at 8 worlds of
seeded noise, with rows dropped at random so that islands split.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import island as jisland
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward, island
from tests.test_island import _XML as ISLAND_XML
from tests.torch_threads import few_threads  # noqa: F401

_FIELDS = ('nisland', 'tree_island', 'dof_island', 'efc_island')


def rows(m, qpos, qvel):
  """The port's efc_J at world-major state (qpos, qvel) (plain versions
  on the CPU)."""
  W = qpos.shape[0]
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  return forward.mid(m, kmass.mass_chain(m, forward.pre(m, d))).efc_J


def both(mjm, m, J):
  mj = jio.put_model(mjm, nconmax=None)
  W = J.shape[0]
  dj = jio.make_data(mj, nworld=W).replace(efc_J=jnp.asarray(J.numpy()))
  want = jax.jit(jax.vmap(lambda x: jisland.island(mj, x)))(dj)
  got = island.island(m, tio.make_data(m, W, device='cpu').replace(efc_J=J))
  return got, want


def test_island_matches_jax_on_clutter_arm():
  mjm = mujoco.MjModel.from_xml_path(tio.CLUTTER_XML)
  m = tio.put_model(mjm, nconmax=None, device='cpu')
  qpos, qvel, _ = parity.clutter_state(m, 32, 0)
  got, want = both(mjm, m, rows(m, qpos, qvel))
  for k in _FIELDS:
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)), err_msg=k)
  # the packed clutter is one island per world, the arm (on the floor
  # in some worlds) another or none
  assert int(got.nisland.min()) >= 1
  assert int((got.tree_island[:, 1:] >= 0).sum()) > 0.9 * 32 * 12


@pytest.mark.parametrize('seed', [0, 1])
def test_island_matches_jax_on_the_island_scene(seed):
  mjm = mujoco.MjModel.from_xml_string(ISLAND_XML)
  m = tio.put_model(mjm, device='cpu')
  rng = np.random.default_rng(seed)
  W = 8
  qpos = (np.asarray(mjm.qpos0, np.float32)[None] +
          0.02 * rng.standard_normal((W, m.nq))).astype(np.float32)
  qvel = np.zeros((W, m.nv), np.float32)
  J = rows(m, qpos, qvel)
  # drop rows at random: islands split and rows of no tree appear
  J = J * torch.as_tensor(rng.random((W, m.nefc, 1)) < 0.7)
  got, want = both(mjm, m, J)
  for k in _FIELDS:
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)), err_msg=k)
  assert len(np.unique(got.nisland.numpy())) > 1
