"""The port's sleep functions (``ops/sleep.py``) against the JAX
``ops/sleep.py`` under ``vmap``, and the port's own sleeping behaviour.

Parity: each function on the same seeded state, its integer outputs
exactly equal and its float outputs bit for bit (both sides compare the
same float32 products).  The state is ``asleep_mix``: a seeded mix of
awake counters (``K_AWAKE`` to -1) and sleeping groups labelled by their
smallest tree, random island labels, velocities around the sleep
tolerance (exact zeros in sleeping trees) and sparse applied forces, on
top of real contacts and rows: the seeded contact state of
``parity.clutter_state`` (its bodies packed into touching rows) of
clutter_arm (lossless slots) and of clutter.xml (its contacts compacted
into {1: 24, 3: 48} slots, so ``wake_collision`` reads
``contact.cand``), and
the constraints scene with sleep on (connect, joint and weld equalities,
for ``wake_equality``).

Behaviour, on the committed settled clutter.xml state (every tree
asleep): awake trees at rest fall asleep after ``MJ_MINAWAKE`` quiescent
steps, a sleeping tree stays frozen to the last bit, and an applied force
wakes its tree's whole group and nothing else.
"""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import sleep as jsleep
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from mujoco_warp_tpu_torch.ops import sleep as osleep
from tests.torch_threads import few_threads  # noqa: F401

W = 16


def _mjm(scene):
  if scene == 'clutter_arm':
    return mujoco.MjModel.from_xml_path(tio.CLUTTER_XML), None
  if scene == 'clutter':
    return (mujoco.MjModel.from_xml_path(tio.CLUTTER_SLEEP_XML),
            tio.CLUTTER_SLEEP_NCONMAX)
  mjm = mujoco.MjModel.from_xml_path(tio.CONSTRAINTS_XML)
  mjm.opt.enableflags |= int(types.EnableBit.SLEEP)
  return mjm, None


@functools.lru_cache(maxsize=None)
def models(scene):
  mjm, nconmax = _mjm(scene)
  return (jio.put_model(mjm, nconmax=nconmax),
          tio.put_model(mjm, nconmax=nconmax, device='cpu'))


def asleep_mix(m, d, seed):
  """``d`` with a seeded sleep state: per world, the trees in four random
  groups, each group asleep (labelled by its smallest tree) with
  probability 0.4, else each tree awake with a counter of K_AWAKE, -5,
  -3, -2 or -1; island labels in -1..3; qvel at 0-2x the tolerance over
  each dof's length (0 in sleeping trees, 0 in a tenth of the others);
  qfrc_applied on 5% of dofs, xfrc_applied on 5% of bodies; qacc
  N(0, 1)."""
  rng = np.random.default_rng(seed)
  nt = m.ntree
  group = rng.integers(0, 4, size=(W, nt))
  gsleep = rng.random((W, 4)) < 0.4
  ids = np.arange(nt)
  label = np.stack([[ids[group[w] == group[w, t]].min() for t in range(nt)]
                    for w in range(W)])
  sleeping = np.take_along_axis(gsleep, group, axis=1)
  counter = rng.choice([types.K_AWAKE, -5, -3, -2, -1], size=(W, nt))
  asleep = np.where(sleeping, label, counter).astype(np.int32)
  tol = float(types.host(m.opt.sleep_tolerance))
  length = types.host(m.dof_length, np.float32)
  sign = np.where(rng.random((W, m.nv)) < 0.5, -1.0, 1.0)
  qvel = (sign * rng.uniform(0.0, 2.0, (W, m.nv)) * tol / length).astype(
      np.float32)
  qvel[sleeping[:, m.dof_treeid] | (rng.random((W, m.nv)) < 0.1)] = 0.0
  qfrc = np.where(rng.random((W, m.nv)) < 0.05, 1.0, 0.0).astype(np.float32)
  xfrc = np.zeros((W, m.nbody, 6), np.float32)
  xfrc[rng.random((W, m.nbody)) < 0.05, 2] = 1.0
  t = torch.as_tensor
  return d.replace(
      tree_asleep=t(asleep),
      tree_island=t(rng.integers(-1, 4, size=(W, nt)).astype(np.int32)),
      qvel=t(qvel), qfrc_applied=t(qfrc), xfrc_applied=t(xfrc),
      qacc=t(rng.standard_normal((W, m.nv)).astype(np.float32)))


def state(scene, seed):
  """(JAX Model, port Model, port Data with contacts and rows and the
  ``asleep_mix`` of ``seed``, the same as JAX Data)."""
  mj, m = models(scene)
  if scene.startswith('clutter'):
    qpos, qvel, _ = parity.clutter_state(m, W, seed)
  else:
    qpos, qvel, _ = parity.general_state(m, W, seed)
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  d = forward.mid(m, kmass.mass_chain(m, forward.pre(m, d)))
  d = asleep_mix(m, d, seed)
  return mj, m, d, to_jax(mj, d)


def to_jax(mj, d):
  j = lambda x: jnp.asarray(x.numpy())
  dj = jio.make_data(mj, nworld=W)
  kw = {k: j(getattr(d, k)) for k in (
      'qvel', 'qacc', 'qfrc_applied', 'xfrc_applied', 'tree_asleep',
      'tree_island', 'efc_J', 'efc_D', 'efc_active', 'eq_active')}
  if d.contact is not None:
    c = d.contact
    kw['contact'] = dj.contact.replace(
        dist=j(c.dist), includemargin=j(c.includemargin), cand=j(c.cand))
  return dj.replace(**kw)


def vmapped(fn, mj, dj):
  return jax.jit(jax.vmap(lambda x: fn(mj, x)))(dj)


def assert_same(got, want, names):
  for k in names:
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize('scene', ['clutter_arm', 'clutter', 'constraints'])
def test_sleep_functions_match_jax(scene):
  """wake, the collision wake (both branches), the equality wake,
  mask_sleeping, sleep, sleep_candidate and dof_awake_mask."""
  mj, m, d, dj = state(scene, 3)
  assert bool((d.tree_asleep >= 0).any()) and bool((d.tree_asleep < 0).any())
  assert_same(osleep.wake(m, d), vmapped(jsleep.wake, mj, dj),
              ('tree_asleep',))
  if scene != 'constraints':
    assert m.con_compact == (scene == 'clutter')
    got = osleep.wake_collision(m, d)
    assert_same(got, vmapped(jsleep.wake_collision, mj, dj),
                ('tree_asleep',))
    # contacts between awake and sleeping trees woke some group
    assert int((got.tree_asleep != d.tree_asleep).sum()) > 0
  else:
    got = osleep.wake_equality(m, d)
    assert_same(got, vmapped(jsleep.wake_equality, mj, dj),
                ('tree_asleep',))
    assert int((got.tree_asleep != d.tree_asleep).sum()) > 0
  got = osleep.mask_sleeping(m, d)
  assert_same(got, vmapped(jsleep.mask_sleeping, mj, dj),
              ('efc_D', 'efc_active'))
  assert int((got.efc_D != d.efc_D).sum()) > 0
  assert_same(osleep.sleep(m, d), vmapped(jsleep.sleep, mj, dj),
              ('tree_asleep', 'qvel', 'qacc'))
  np.testing.assert_array_equal(
      osleep.sleep_candidate(m, d).numpy(),
      np.asarray(jax.vmap(lambda x: jsleep.sleep_candidate(mj, x))(dj)))
  np.testing.assert_array_equal(
      osleep.dof_awake_mask(m, d).numpy(),
      np.asarray(jax.vmap(lambda x: jsleep.dof_awake_mask(mj, x))(dj)))


def test_sleep_candidate_reads_the_state_before_integration():
  """A tree whose counter is at -2 is a candidate only if it is quiescent
  in the state it is given: the labeler runs before the solve, so a tree
  that becomes quiescent only through this step's integration is no
  candidate, although ``sleep`` at the step's end would count it ready.
  That is exact for closed rollouts (nothing changes the state between
  the labeler and ``sleep`` but the step), as in the JAX package, which
  gives the same answer on both states."""
  mj, m, d, _ = state('clutter_arm', 4)
  asleep = torch.full_like(d.tree_asleep, types.K_AWAKE)
  asleep[:, 5] = -2
  tol = float(types.host(m.opt.sleep_tolerance))
  dofs = torch.as_tensor(np.nonzero(m.dof_treeid == 5)[0])
  still = torch.zeros_like(d.qvel)
  moving = still.clone()
  moving[:, dofs[0]] = 2.0 * tol / float(m.dof_length[dofs[0]])
  base = d.replace(tree_asleep=asleep, qfrc_applied=torch.zeros_like(d.qvel),
                   xfrc_applied=torch.zeros_like(d.xfrc_applied))
  for qvel, want in ((still, True), (moving, False)):
    dd = base.replace(qvel=qvel)
    got = osleep.sleep_candidate(m, dd)
    assert bool(got.all()) == want and bool(got.any()) == want
    jgot = jax.vmap(lambda x: jsleep.sleep_candidate(mj, x))(to_jax(mj, dd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
  # the moving tree's step brings it to rest: sleep() counts it ready
  # (-2 -> -1 with the island test passing), so the candidate test seen
  # before integration missed a tree that sleep() then readies
  out = osleep.sleep(m, base.replace(qvel=still,
                                     tree_island=torch.full_like(asleep, -1)))
  assert bool((out.tree_asleep[:, 5] == 5).all())


def settled(nworld):
  """The committed settled clutter.xml state (every tree asleep) on the
  CPU."""
  _, m = models('clutter')
  st = {k: torch.as_tensor(v[:nworld])
        for k, v in tio.load_state(tio.CLUTTER_SETTLED).items()}
  return m, tio.make_data(m, nworld, device='cpu').replace(**st)


def test_settled_state_sleeps():
  _, d = settled(64)
  assert bool((d.tree_asleep >= 0).all())
  assert float(d.qvel.abs().max()) == 0.0


def test_trees_fall_asleep():
  """Every tree woken at rest (counter K_AWAKE) sleeps again after
  MJ_MINAWAKE quiescent steps, not before; its qvel and qacc are then
  exactly zero."""
  m, d = settled(4)
  d = d.replace(tree_asleep=torch.full_like(d.tree_asleep, types.K_AWAKE))
  for i in range(types.MJ_MINAWAKE):
    assert bool((d.tree_asleep < 0).all()), i
    d = forward.step(m, d)
  assert bool((d.tree_asleep >= 0).all())
  assert float(d.qvel.abs().max()) == 0.0 and float(d.qacc.abs().max()) == 0.0


def test_sleeping_tree_stays_frozen():
  m, d = settled(4)
  qpos = d.qpos.clone()
  for _ in range(5):
    d = forward.step(m, d)
  assert bool((d.tree_asleep >= 0).all())
  assert torch.equal(d.qpos, qpos)
  assert float(d.qvel.abs().max()) == 0.0


def test_applied_force_wakes_its_group():
  """Trees 0 and 1 of world 0 share a sleep label; a push on tree 1's
  body wakes both, no other tree, and moves tree 1 on the next step."""
  m, d = settled(4)
  asleep = d.tree_asleep.clone()
  asleep[0, 1] = 0
  xfrc = torch.zeros_like(d.xfrc_applied)
  body = int(np.nonzero(m.body_treeid == 1)[0][0])
  xfrc[0, body, 2] = 5.0
  d = forward.step(m, d.replace(tree_asleep=asleep, xfrc_applied=xfrc))
  a = d.tree_asleep
  assert bool((a[0, :2] < 0).all())
  assert bool((a[0, 2:] >= 0).all()) and bool((a[1:] >= 0).all())
  d = forward.step(m, d.replace(xfrc_applied=xfrc))
  dofs = torch.as_tensor(np.nonzero(m.dof_treeid == 1)[0])
  assert float(d.qvel[0, dofs].abs().max()) > 0.0
  others = torch.as_tensor(np.nonzero(m.dof_treeid >= 2)[0])
  assert float(d.qvel[:, others].abs().max()) == 0.0
