"""The port's fluid forces against the JAX package and MuJoCo C.

- ``passive._fluid`` (the inertia box) and ``passive._fluid_ellipsoid``
  against the JAX functions (vmapped) on the same inputs: the port's
  position stages and mass chain at a seeded state of 8 worlds, copied
  into the JAX Data; on fluid_ellipsoid.xml (both models, viscosity,
  density and wind; a hinge chain) and swimmer6 (the inertia box alone),
  within atol 1e-6 + rtol 1e-4.
- qfrc_fluid of the port's general step at one world of fluid_ellipsoid
  against ``mujoco.mj_forward``'s, within atol 1e-5 + rtol 1e-4.
- The semiaxes of the ellipsoid model per geom type, and the inertia box
  skipped on the ellipsoid model's bodies.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import passive as jpassive
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward, passive
from tests.test_torch_dmc_rest import models, seeded
from tests.torch_threads import few_threads  # noqa: F401

W = 8
ATOL, RTOL = 1e-6, 1e-4
_FIELDS = ('xipos', 'ximat', 'subtree_com', 'cvel', 'cdof', 'geom_xpos',
           'geom_xmat')


def _inputs(scene, seed=2):
  """The port Data after the position stages and the mass chain at the
  seeded state, and the JAX Data holding the same fields."""
  _, mj, m = models(scene)
  qpos, qvel, _ = seeded(m, scene, W, seed)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  d = forward.mass_chain(m, forward.pre(m, d))
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
      **{k: jnp.asarray(getattr(d, k).numpy()) for k in _FIELDS})
  return mj, m, d, dj


def _close(got, want, name):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=RTOL, err_msg=name)


def test_inertia_box_matches_jax():
  for scene in ('fluid_ellipsoid', 'swimmer6'):
    mj, m, d, dj = _inputs(scene)
    want = jax.vmap(lambda x: jpassive._fluid(mj, x))(dj)
    got = passive._fluid(m, d)
    _close(got, want, scene)
    assert float(got.abs().max()) > 1e-3


def test_ellipsoid_model_matches_jax():
  mj, m, d, dj = _inputs('fluid_ellipsoid')
  want = jax.vmap(lambda x: jpassive._fluid_ellipsoid(mj, x))(dj)
  got = passive._fluid_ellipsoid(m, d)
  _close(got, want, 'fluid_ellipsoid')
  assert float(got.abs().max()) > 1e-3
  np.testing.assert_array_equal(passive.ellipsoid_bodies(m),
                                jpassive._ellipsoid_bodies(mj))


def test_semiaxes_by_geom_type():
  _, _, m = models('fluid_ellipsoid')
  t = passive.fluid_geoms(m, 'cpu')
  sel, gf, semi = (t[k].numpy() for k in ('geom', 'coef', 'semi'))
  size = np.asarray(m.geom_size.numpy(), np.float64)[sel]
  gt = m.geom_type[sel]
  for i, t in enumerate(gt):
    r, h = size[i, 0], size[i, 1]
    want = {2: (r, r, r), 3: (r, r, h + r), 5: (r, r, h)}.get(int(t),
                                                              size[i])
    np.testing.assert_allclose(semi[i], want)
  assert sorted(set(int(t) for t in gt)) == [2, 3, 4, 6]
  assert gf.shape == (4, 12)
  # the cylinder's body alone takes the inertia box
  assert passive.ellipsoid_bodies(m).tolist() == [False, True, True, True,
                                                  True, False]


def test_step_matches_mujoco():
  mjm = mujoco.MjModel.from_xml_path(tio.FLUID_XML['fluid_ellipsoid'])
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(4)
  mjd.qvel[:] = rng.standard_normal(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  m = tio.load_model_npz(tio.FLUID_SNAPSHOTS['fluid_ellipsoid'],
                         device='cpu')
  d = tio.put_data(mjm, mjd, m)
  d = forward.mid(m, forward.mass_chain(m, forward.pre(m, d)))
  np.testing.assert_allclose(d.qfrc_fluid[0].numpy(), mjd.qfrc_fluid,
                             atol=1e-5, rtol=1e-4)
  assert np.abs(mjd.qfrc_fluid).max() > 1e-2
