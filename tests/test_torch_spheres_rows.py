"""The general step's contact rows against the JAX ``make_constraint`` on
the spheres scenes, pyramidal (condim 3, 4 and 6: 4, 6 and 10 rows per
contact, built from ``friction[o // 2]``) and elliptic ([n, t1, t2, r1,
r2, r3][:dim] rows, friction-row invweights, ``solreffriction`` and zero
``pos_aref`` on the friction rows).

Two states at 16 worlds: the JAX fixture ``tests/test_pallas_solver.py``
solves (``spheres.xml``, qvel noise 0.5, 20 steps of MuJoCo, then 0.02 N
velocity noise per world) and the seeded contact state of
``parity.spheres_state`` (every body on the floor, live contacts in all
three condim classes).  The JAX side runs ``fwd_position`` under vmap,
the port its position stages, plain mass chain, collision and rows.
Bars: efc_J, efc_D, efc_aref and efc_pos within 1e-4 of each field's
largest magnitude (float32 Jacobians and reference accelerations summed
in another order; ``tests/test_torch_constraint.py``), the active mask
equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import models as jmodels
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_spheres_io import CONES, states
from tests.torch_threads import few_threads  # noqa: F401

RTOL = 1e-4
W = 16


def fixture_states(scene):
  """(JAX Model, port Model, JAX Data, port Data) at the JAX fixture state
  broadcast to W worlds with 0.02 N velocity noise."""
  ov = ('opt.cone=1',) if CONES[scene] == types.ConeType.ELLIPTIC else ()
  mjm, _, mj, d = jmodels.fixture('spheres.xml', qvel_noise=0.5, nstep=20,
                                  overrides=ov)
  db = jax.tree.map(lambda x: jnp.broadcast_to(x, (W,) + x.shape), d)
  rng = np.random.default_rng(0)
  db = db.replace(qvel=db.qvel + 0.02 * jnp.asarray(
      rng.standard_normal((W, mjm.nv)).astype(np.float32)))
  m = tio.put_model(mjm, device='cpu')
  dt = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(np.array(db.qpos)),
      qvel=torch.as_tensor(np.array(db.qvel)))
  return mj, m, db, dt


@functools.lru_cache(maxsize=None)
def rows(scene, state):
  """(port Model, port Data, JAX Data) after the rows."""
  if state == 'fixture':
    mj, m, dj, d = fixture_states(scene)
  else:
    mj, m, dj, d = states(scene, W, 0)
  dj = jax.jit(jax.vmap(lambda x: jfwd.fwd_position(mj, x)))(dj)
  d = forward.mid(m, kmass.mass_chain(m, forward.pre(m, d)))
  return m, d, dj


@pytest.mark.parametrize('state', ['fixture', 'spheres_state'])
@pytest.mark.parametrize('scene', sorted(CONES))
def test_contact_rows_match_jax(scene, state):
  m, d, dj = rows(scene, state)
  live = d.efc_active.numpy()
  np.testing.assert_array_equal(live, np.asarray(dj.efc_active))
  assert live.any()
  for name in ('efc_J', 'efc_D', 'efc_aref', 'efc_pos'):
    want = np.asarray(getattr(dj, name))
    np.testing.assert_allclose(
        getattr(d, name).numpy(), want, rtol=0.0,
        atol=RTOL * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize('scene', sorted(CONES))
def test_every_condim_has_live_rows(scene):
  """At the seeded state the rows of condim 3, 4 and 6 contacts are all
  live somewhere, so the comparison above covers each row form."""
  m, d, _ = rows(scene, 'spheres_state')
  live = d.efc_active.numpy().any(axis=0)
  for dim in (3, 4, 6):
    for c in np.nonzero(m.con_dim == dim)[0]:
      a = int(m.con_efc_address[c])
      n = dim if CONES[scene] == types.ConeType.ELLIPTIC else 2 * (dim - 1)
      if live[a]:
        assert live[a:a + n].all()
        break
    else:
      pytest.fail(f'no live condim-{dim} contact')
