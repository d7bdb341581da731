"""The public Data API of ``io``: ``put_data``, ``get_data_into`` and
``reset_data`` (``mujoco_warp_tpu/io.py:1214, :1278, :1330``).

- The round trip: an MjData state through ``put_data`` (broadcast to 3
  worlds) and back through ``get_data_into`` on manipulator insert_peg
  and on clutter_arm, whose state has trees asleep: every copied field
  comes back as its float32 value, and ``tree_asleep`` as the same sleep
  cycles (the port holds group labels).
- ``get_data_into`` after one port step against the JAX
  ``get_data_into`` after one JAX step (batched, jitted, its jnp path on
  the CPU) from the same ``put_data`` state, on the constraints scene
  (equality, friction-loss and limit rows, actuators) at 4 worlds, field
  by field: qpos at the step bar (atol 2e-4, rtol 1e-3), qvel at its
  (5e-3, 5e-3), the frames within 2e-4 + 1e-3 of the field's largest
  entry and the forces and accelerations within 1e-3 + 1e-3 of it.
- ``reset_data`` against the JAX ``reset_data``: both sides step the same
  ``put_data`` state once and reset the same mask; every field of the
  port's Data and of its contact slots equals the JAX field in the reset
  worlds (the stage outputs at rest, the contacts as the JAX
  ``make_data`` sets them), and holds its own step's value in the others,
  where the state agrees with the JAX step at the step bars; on spheres
  (lossless contact slots) and, for the reset contact slots alone, on
  humanoid_dmc (slots compacted by condim class).  With no mask the port
  gives ``make_data``'s Data.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_classic_step import fast_compile
from tests.torch_threads import few_threads  # noqa: F401

# the MjData fields ``put_data`` copies, and eq_active
_PUT = tio.PUT_FIELDS + ('eq_active',)
_POS = ('qpos', 'xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'geom_xpos',
        'geom_xmat', 'site_xpos', 'site_xmat', 'subtree_com')


def load(scene):
  if scene == 'clutter_arm':
    return mujoco.MjModel.from_xml_path(tio.CLUTTER_XML)
  if scene == 'constraints':
    return mujoco.MjModel.from_xml_path(tio.CONSTRAINTS_XML)
  pytest.importorskip('dm_control')
  return tio.load_dmc(scene)


def random_state(mjm, seed):
  """An MjData with every field ``put_data`` copies set from ``seed``."""
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(seed)
  mjd.time = 1.25
  mjd.qpos[:] = mjm.qpos0 + 0.05 * rng.standard_normal(mjm.nq)
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  for name in ('qvel', 'ctrl', 'qfrc_applied', 'xfrc_applied',
               'qacc_warmstart', 'qacc'):
    x = getattr(mjd, name)
    x[:] = 0.1 * rng.standard_normal(x.shape)
  if mjm.neq:
    mjd.eq_active[:] = rng.random(mjm.neq) < 0.5
  return mjd


def sleeping_cycles(mjm):
  """MuJoCo C's tree_asleep of world 0 of clutter_arm's committed settled
  state (the port keeps group labels; C links each group into a cycle)."""
  labels = tio.load_state(tio.CLUTTER_ARM_SETTLED)['tree_asleep'][0]
  assert (labels >= 0).sum() >= 2
  return labels, tio._asleep_labels_to_cycles(labels)


@pytest.mark.parametrize('scene', ['manipulator_insert_peg', 'clutter_arm'])
def test_put_data_get_data_into_round_trip(scene):
  mjm = load(scene)
  m = tio.put_model(mjm, device='cpu')
  mjd = random_state(mjm, 1)
  labels = None
  if scene == 'clutter_arm':
    labels, cycles = sleeping_cycles(mjm)
    mjd.tree_asleep[:] = cycles
  d = tio.put_data(mjm, mjd, m, nworld=3)
  for k in _PUT:
    want = np.asarray(getattr(mjd, k))
    x = getattr(d, k)
    assert x.shape == (3,) + want.shape, k
    want = want.astype(bool) if k == 'eq_active' else want.astype(np.float32)
    for w in range(3):
      np.testing.assert_array_equal(x[w].numpy(), want, err_msg=k)
  if labels is not None:
    np.testing.assert_array_equal(d.tree_asleep[2].numpy(), labels)
  assert tio.put_data(mjm, mjd, m).qpos.shape == (1, mjm.nq)
  back = mujoco.MjData(mjm)
  tio.get_data_into(back, mjm, d, world=1)
  assert back.time == np.float32(mjd.time)
  for k in ('qpos', 'qvel', 'ctrl', 'qacc', 'qacc_warmstart'):
    np.testing.assert_array_equal(
        getattr(back, k), getattr(mjd, k).astype(np.float32), err_msg=k)
  np.testing.assert_array_equal(back.tree_asleep, mjd.tree_asleep)


@functools.lru_cache(maxsize=None)
def stepped(scene='constraints'):
  """(MjModel, the port's Data and the JAX Data after one step from the
  same put_data state, 4 worlds, and the port's and the JAX Model)."""
  mjm = tio.load_spheres() if scene == 'spheres' else load(scene)
  m, mj = tio.put_model(mjm, device='cpu'), jio.put_model(mjm)
  mjd = random_state(mjm, 2)
  d = tio.put_data(mjm, mjd, m, nworld=4)
  dj = jio.put_data(mjm, mjd, mj, nworld=4)
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  return mjm, forward.step(m, d), step(dj), m, mj


def test_get_data_into_matches_jax_after_a_step():
  mjm, d, dj, _, _ = stepped()
  got, want = mujoco.MjData(mjm), mujoco.MjData(mjm)
  tio.get_data_into(got, mjm, d, world=2)
  jio.get_data_into(want, mjm, dj, world=2)
  assert got.time == pytest.approx(want.time)
  seen = 0
  for name, size in tio.GET_FIELDS:
    if size is not None and not getattr(mjm, size):
      continue
    a, b = getattr(got, name), getattr(want, name)
    if name == 'qvel':
      tol = (5e-3, 5e-3)
    elif name == 'qpos':
      tol = (2e-4, 1e-3)
    else:
      scale = max(1.0, float(np.abs(b).max()))
      tol = ((2e-4 if name in _POS else 1e-3) + 1e-3 * scale, 0.0)
    assert_close(a, b, name, *tol)
    seen += 1
  assert seen >= 20 and np.abs(want.qfrc_constraint).max() > 1e-3


def test_reset_data_resets_the_masked_worlds():
  mjm, d, dj, m, mj = stepped('spheres')
  W = d.qpos.shape[0]
  mask = np.array([False, True, False, True])
  r = tio.reset_data(m, d, torch.as_tensor(mask))
  rj = jio.reset_data(mj, dj, jnp.asarray(mask))

  def held(obj, objj, was, wasj, where):
    """Every per-world tensor of the port's ``obj`` against the JAX
    ``objj``: equal in the reset worlds; in the others unchanged from
    ``was`` (and the JAX side from ``wasj``).  Returns the fields held
    and those JAX does not have."""
    seen, port_only = [], []
    for f in dataclasses.fields(obj):
      x = getattr(obj, f.name)
      if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] != W:
        continue
      name = where + f.name
      assert torch.equal(x[~mask], getattr(was, f.name)[~mask]), name
      if not hasattr(objj, f.name):
        port_only.append(f.name)
        assert not x[mask].any(), name
        continue
      y, y0 = np.asarray(getattr(objj, f.name)), \
          np.asarray(getattr(wasj, f.name))
      np.testing.assert_array_equal(y[~mask], y0[~mask], err_msg=name)
      got = x[mask].numpy()
      if got.shape == y[mask].shape:
        np.testing.assert_array_equal(got, y[mask].astype(got.dtype),
                                      err_msg=name)
      else:  # a layout the port keeps dense (qM, efc_J): both at rest
        assert not got.any() and not y[mask].any(), name
      seen.append(f.name)
    return seen, port_only

  seen, port_only = held(r, rj, d, dj, '')
  assert len(seen) > 40 and set(port_only) <= {
      'subtree_linvel', 'subtree_angmom'}, (seen, port_only)
  assert d.contact.dist.shape[1] == m.ncon > 0
  seen_c, _ = held(r.contact, rj.contact, d.contact, dj.contact, 'contact.')
  assert len(seen_c) == 11, seen_c
  # the kept worlds hold their own step, which agrees with the JAX step
  for name, tol in (('qpos', (2e-4, 1e-3)), ('qvel', (5e-3, 5e-3)),
                    ('time', (1e-6, 0.0))):
    assert_close(getattr(r, name)[~mask].numpy(),
                 np.asarray(getattr(rj, name))[~mask], name, *tol)
  fresh = tio.make_data(m, W, device='cpu')
  every = tio.reset_data(m, d)
  for f in ('qpos', 'qvel', 'tree_island', 'nisland', 'efc_island', 'time'):
    assert torch.equal(getattr(every, f), getattr(fresh, f)), f
  # a reset world steps as a fresh one
  np.testing.assert_allclose(forward.step(m, r).qpos[mask].numpy(),
                             forward.step(m, fresh).qpos[mask].numpy(),
                             rtol=0, atol=1e-6)


def test_reset_contact_slots_match_jax_make_data():
  """The compacted slots' reset values (each slot's first candidate of
  its class, cand -1) against the JAX ``make_data``, on humanoid_dmc."""
  mjm = load('humanoid_dmc')
  budget = tio.DMC_NCONMAX['humanoid_dmc']
  m = tio.put_model(mjm, nconmax=budget, device='cpu')
  mj = jio.put_model(mjm, nconmax=budget)
  assert m.con_compact and m.ncon < m.ncand
  W = 3
  d = tio.put_data(mjm, random_state(mjm, 3), m, nworld=W)
  d = d.replace(contact=forward.step(m, d).contact)
  r = tio.reset_data(m, d, torch.ones(W, dtype=torch.bool))
  want = jio.make_data(mj, nworld=W).contact
  for f in dataclasses.fields(r.contact):
    x = getattr(r.contact, f.name)
    y = np.asarray(getattr(want, f.name))
    np.testing.assert_array_equal(x.numpy(), y.astype(x.numpy().dtype),
                                  err_msg=f.name)
