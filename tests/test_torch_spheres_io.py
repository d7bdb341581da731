"""Port io on the contact zoo ``spheres.xml`` in both cones: the
registered benchmarks ``spheres`` (pyramidal) and ``spheres_elliptic``
(``opt.cone=elliptic``), lossless contact slots.  Its Model against the
JAX put_model, its committed snapshots, the general step's gate, the
elliptic row groups against the JAX kernel's, and the seeded contact
state every spheres test uses.

``models`` and ``states`` are shared by the other ``test_torch_spheres_*``
files.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.pallas import solver as psolver
from mujoco_warp_tpu_torch import fused, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_io import assert_models_equal, jax_model_numpy
from tests.torch_threads import few_threads  # noqa: F401

CONES = {'spheres': types.ConeType.PYRAMIDAL,
         'spheres_elliptic': types.ConeType.ELLIPTIC}
SNAPSHOTS = {'spheres': tio.SPHERES_SNAPSHOT,
             'spheres_elliptic': tio.SPHERES_ELLIPTIC_SNAPSHOT}


@functools.lru_cache(maxsize=None)
def models(scene):
  """(JAX Model, port Model) of a spheres scene, as the JAX benchmark
  builds it (``opt.cone`` set before ``put_model``, ``nconmax=None``)."""
  mjm = tio.load_spheres(CONES[scene])
  return jio.put_model(mjm, nconmax=None), tio.put_model(mjm, device='cpu')


def states(scene, W, seed):
  """(JAX Model, port Model, JAX Data, port Data) at the seeded contact
  state of ``parity.spheres_state``."""
  mj, m = models(scene)
  qpos, qvel, ctrl = parity.spheres_state(m, W, seed)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  return mj, m, dj, d


@pytest.mark.parametrize('scene', sorted(CONES))
def test_put_model_matches_jax_on_spheres(scene):
  """Every field of the port's Model equals the JAX Model's (the contact
  layout, the row types and the mixed contact parameters among them);
  the general step takes the model, the fused gate does not."""
  mj, m = models(scene)
  ref = jax_model_numpy(mj)
  for k, v in tio.model_to_numpy(m).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
    elif k == 'pair_groups':
      assert [(a, b, list(i), s) for a, b, i, s in v] == \
          [(int(a), int(b), list(i), int(s)) for a, b, i, s in mj.pair_groups]
    elif k not in ('tree.body_levels', 'con_classes'):
      assert v == ref[k], k
  elliptic = CONES[scene] == types.ConeType.ELLIPTIC
  assert (m.nq, m.nv, m.nbody, m.ncand, m.ncon, m.nefc) == \
      (42, 36, 7, 33, 33, 129 if elliptic else 192)
  dims, counts = np.unique(m.con_dim, return_counts=True)
  assert dict(zip(dims.tolist(), counts.tolist())) == {3: 15, 4: 12, 6: 6}
  CT = types.ConstraintType
  assert set(m.efc.efc_type.tolist()) == {
      int(CT.CONTACT_ELLIPTIC if elliptic else CT.CONTACT_PYRAMIDAL)}
  # condim 6 mixes the sphere's torsion 0.02 and rolling 0.003 in
  fr6 = m.cand_friction.numpy()[m.con_dim == 6]
  np.testing.assert_array_equal(
      fr6[:, 2:], np.broadcast_to(np.float32([0.02, 0.003, 0.003]),
                                  (len(fr6), 3)))
  assert forward.unsupported(m) is None and not fused.supported(m)
  assert not forward.large_system(m)


@pytest.mark.parametrize('scene', sorted(CONES))
def test_spheres_snapshot_matches_fresh_put_model(scene, tmp_path):
  """The committed snapshot is what ``--snapshot`` writes today."""
  path = str(tmp_path / f'{scene}.npz')
  fresh = tio.make_spheres_snapshot(CONES[scene], path)
  assert_models_equal(tio.load_model_npz(SNAPSHOTS[scene], device='cpu'),
                      fresh)
  assert_models_equal(tio.load_model_npz(path, device='cpu'), fresh)


def test_elliptic_groups_match_the_jax_kernel():
  """The port's elliptic groups hold, condim by condim, the model rows
  that ``_ell_perm`` gathers into its contiguous blocks: (3, 0, 15),
  (4, 45, 12) and (6, 93, 6), no head rows."""
  mj, m = models('spheres_elliptic')
  perm, _, groups, nhead = psolver._ell_perm(mj)
  assert nhead == 0
  assert [(g[0], g[1], len(g[2])) for g in groups] == \
      [(3, 0, 15), (4, 45, 12), (6, 93, 6)]
  mine = solver_ref.ell_groups(m)
  for (d0, row0, ids), (dim, cids, rows) in zip(groups, mine):
    assert dim == d0
    np.testing.assert_array_equal(cids, ids)
    np.testing.assert_array_equal(rows.reshape(-1),
                                  perm[row0:row0 + len(ids) * d0])
  assert solver_ref.ell_groups(models('spheres')[1]) == []


@pytest.mark.parametrize('scene', sorted(CONES))
def test_spheres_state_has_contacts_in_every_condim(scene):
  """The seeded state puts every body on the floor: live contacts in all
  three condim classes in every world, through the port's collision."""
  from mujoco_warp_tpu_torch.ops import collision_driver
  _, m, _, d = states(scene, 32, 0)
  d = collision_driver.collision(m, forward.pre(m, d))
  live = (d.contact.dist < d.contact.includemargin).numpy()
  for dim in (3, 4, 6):
    assert live[:, m.con_dim == dim].any(axis=1).all(), dim
  # up to 13: sphere, sphere, capsule (2), box (4), sphere, box (4) on
  # the floor; a tilted box touches it with fewer corners
  assert int(d.ncon_active.min()) >= 6
  assert float(d.ncon_active.float().mean()) >= 9.0
