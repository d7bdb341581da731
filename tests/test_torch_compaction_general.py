"""Contact compaction on the general step (``ops/collision_driver.py``
``collision`` with ``con_compact``) against the JAX
``collision_driver.collision`` on the same geom frames: dm_control's
humanoid (177 candidates) with its feet in the floor, at its budget
{1: 16, 3: 32} and at {1: 4, 3: 8}, which overflows in both.  Per world:
the same selected candidate set (ties in depth may be ordered either
way, so the sets are compared, and each live slot's dist, pos and frame
by candidate id, to 1e-5), equal ncon_active and equal CONTACT bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip('dm_control')

from mujoco_warp_tpu import io as jio  # noqa: E402
from mujoco_warp_tpu.ops import collision_driver as jcd  # noqa: E402
from mujoco_warp_tpu_torch import io as tio  # noqa: E402
from mujoco_warp_tpu_torch import parity  # noqa: E402
from mujoco_warp_tpu_torch.ops import collision_driver, forward  # noqa: E402
from tests.torch_threads import few_threads  # noqa: F401

W = 32


@pytest.mark.parametrize('nconmax', [{1: 16, 3: 32}, {1: 4, 3: 8}],
                         ids=['budget', 'tight'])
def test_compaction_matches_jax(nconmax):
  mjm = tio.load_dmc('humanoid_dmc')
  mj = jio.put_model(mjm, nconmax=nconmax)
  m = tio.put_model(mjm, nconmax=nconmax, device='cpu')
  assert m.con_compact and m.ncon == sum(nconmax.values())
  qpos, _, _ = parity.dmc_state(m, 'humanoid_dmc', W, 6)
  d = forward.pre(m, tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos)))
  d = collision_driver.collision(m, d)
  dj = jio.make_data(mj, nworld=W).replace(
      geom_xpos=jnp.asarray(d.geom_xpos.numpy()),
      geom_xmat=jnp.asarray(d.geom_xmat.numpy()))
  dj = jax.jit(jax.vmap(lambda x: jcd.collision(mj, x)))(dj)
  cj = dj.contact
  np.testing.assert_array_equal(d.ncon_active.numpy(),
                                np.asarray(dj.ncon_active))
  np.testing.assert_array_equal(d.overflow.numpy(), np.asarray(dj.overflow))
  over = (d.overflow.numpy() & 1) != 0
  if nconmax[1] == 4:
    assert over.any()
  else:
    assert not over.any()
  assert d.ncon_active.numpy().min() > 0
  cand, candj = d.contact.cand.numpy(), np.asarray(cj.cand)
  for w in range(W):
    live, livej = cand[w] >= 0, candj[w] >= 0
    assert sorted(cand[w][live]) == sorted(candj[w][livej]), w
    order = np.argsort(cand[w][live])
    orderj = np.argsort(candj[w][livej])
    for name in ('dist', 'pos', 'frame', 'includemargin', 'friction',
                 'solref', 'solimp'):
      a = getattr(d.contact, name).numpy()[w][live][order]
      b = np.asarray(getattr(cj, name))[w][livej][orderj]
      np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                 err_msg=f'{name} world {w}')
    for name in ('geom1', 'geom2'):
      a = getattr(d.contact, name).numpy()[w][live][order]
      b = np.asarray(getattr(cj, name))[w][livej][orderj]
      np.testing.assert_array_equal(a, b, err_msg=f'{name} world {w}')
    # the empty slots: no live margin, dist 1e10
    assert (d.contact.dist.numpy()[w][~live] == collision_driver.BIG).all()
    assert (d.contact.includemargin.numpy()[w][~live] == 0).all()
