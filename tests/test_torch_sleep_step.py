"""The general step with sleep on: clutter_arm against the JAX
``forward.step``, and the step that skips asleep worlds against the full
step.

Three steps on clutter_arm at 64 worlds (``clutter_arm_settled.npz``:
every clutter tree asleep, the arm awake; each world's trees then woken
at random with a counter of K_AWAKE to -1 and a velocity around the sleep
tolerance, so that trees count down, fall asleep and reset), each from
the JAX state of the step before with ``tree_asleep`` and the island
labels carried.  Bars of ``tests/test_torch_step_clutter.py``: qpos atol
2e-4 rtol 1e-3, qvel atol 5e-3 rtol 5e-3; the same live contacts, no
overflow.  ``tree_asleep`` and the island labels must be equal, but for
trees at the quiescence threshold: the test reads each tree's largest
|dof_length qvel| on both sides, and a tree whose reading lies within
1e-4 tol of ``sleep_tolerance`` may count down on one side and reset on
the other (float32 rounding of qvel moves it across).  Such trees are
counted and bounded (``NEAR_MAX``), and their dofs' qvel is left out of
the qvel bar (one side zeroed it).

The skip step (``forward._step_sleep_skip``, what ``forward.step`` takes
at 256 worlds and more) on the committed settled clutter.xml state at 64
worlds: with 5 worlds woken by ``qfrc_applied`` the awake worlds fit the
W // 4 pack and only they step; with 20 woken the whole batch steps.
Either way it must equal the full step (``_step_batched``):
``tree_asleep`` equal, qpos within 1e-6 and time within 1e-5, as the JAX
``tests/test_sleep_skip.py`` holds its skip step (on the card,
``tests/test_torch_cuda.py`` and chip_smoke phase 11 run it at 256
worlds, 20 steps).
"""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.ops import forward, util
from tests.oracle import assert_close
from tests.torch_threads import few_threads  # noqa: F401

W = 64
# trees of 64 x 13 per step that may sit at the quiescence threshold
NEAR_MAX = 8
_ISLAND = ('tree_asleep', 'nisland', 'tree_island', 'dof_island',
           'efc_island')
_CARRY = ('time', 'qpos', 'qvel', 'ctrl', 'qacc_warmstart') + _ISLAND


@functools.lru_cache(maxsize=None)
def models():
  mjm = mujoco.MjModel.from_xml_path(tio.CLUTTER_XML)
  return jio.put_model(mjm, nconmax=None), tio.put_model(mjm, device='cpu')


def start(m, seed=0):
  """The settled clutter_arm state with each clutter tree of each world
  woken with probability 0.5 (``parity.woken_state``: counter K_AWAKE,
  -3, -2 or -1, its dofs at 0-1.5 times the tolerance over their
  length), ctrl 0.3 N."""
  rng = np.random.default_rng(seed)
  st = parity.woken_state(m, tio.load_state(tio.CLUTTER_ARM_SETTLED), rng)
  st.update(ctrl=(0.3 * rng.standard_normal((W, m.nu))).astype(np.float32),
            time=np.zeros(W, np.float32))
  return st


@functools.lru_cache(maxsize=None)
def jax_states(n):
  mj, m = models()
  st = start(m)
  dj = jio.make_data(mj, nworld=W).replace(
      **{k: jnp.asarray(v) for k, v in st.items()})
  # XLA's backend optimisations off: the step's compile is most of this
  # file's time, and its runs are few
  step = jax.jit(lambda x: jfwd.step(mj, x)).lower(dj).compile(
      {'xla_backend_optimization_level': 0})
  out = [dj]
  for _ in range(n):
    out.append(step(out[-1]))
  return tuple(out)


def tree_speed(m, qvel):
  """(W, ntree): each tree's largest |dof_length qvel|, in float32."""
  v = (np.abs(types.host(m.dof_length, np.float32) * qvel)).astype(
      np.float32)
  return np.stack([v[:, m.dof_treeid == t].max(axis=1)
                   for t in range(m.ntree)], axis=1)


@pytest.mark.parametrize('k', range(3))
def test_sleep_step_matches_jax(k):
  """Step k + 1 of the port from the JAX state after step k."""
  _, m = models()
  before, after = jax_states(3)[k:k + 2]
  d = tio.make_data(m, W, device='cpu').replace(**{
      f: torch.as_tensor(np.array(getattr(before, f))) for f in _CARRY})
  got = forward.step(m, d)
  tol = float(types.host(m.opt.sleep_tolerance))
  a_got, a_want = got.tree_asleep.numpy(), np.asarray(after.tree_asleep)
  speed = np.maximum(tree_speed(m, got.qvel.numpy()),
                     tree_speed(m, np.asarray(after.qvel)))
  near = np.abs(speed - tol) <= 1e-4 * tol
  assert int(near.sum()) <= NEAR_MAX, int(near.sum())
  off = a_got != a_want
  assert not (off & ~near).any(), np.argwhere(off & ~near)
  # trees fall asleep on the first step (their counters start near -1),
  # and awake trees count on
  a0 = np.asarray(before.tree_asleep)
  assert (a_want < 0).any() and (k or ((a0 < 0) & (a_want >= 0)).any())
  for f in _ISLAND[1:]:
    np.testing.assert_array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(after, f)), err_msg=f)
  assert_close(got.qpos.numpy(), np.asarray(after.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  keep = ~off[:, m.dof_treeid]
  assert_close(got.qvel.numpy()[keep], np.asarray(after.qvel)[keep], 'qvel',
               atol=5e-3, rtol=5e-3)
  np.testing.assert_allclose(got.time.numpy(), np.asarray(after.time),
                             rtol=1e-6)
  np.testing.assert_array_equal(got.ncon_active.numpy(),
                                np.asarray(after.ncon_active))
  assert int(got.overflow.max()) == 0
  assert int(np.asarray(after.overflow).max()) == 0


def settled_clutter(nworld, nwake):
  """``parity.pushed_clutter`` on the CPU: the settled clutter.xml state
  at ``nworld`` worlds, ``nwake`` of them pushed awake."""
  return parity.pushed_clutter(nworld, nwake, device='cpu')


def test_the_step_reads_only_its_carry():
  """The general step with sleep on, from a state whose every field is
  set, equals the step from that state's ``types.CARRY`` alone (the
  other fields None), field for field: the skip step's pack gathers only
  the carry.  A field the step leaves None it does not compute here (no
  energy flag, no sensor, no site): the full step passes it through."""
  m, d = settled_clutter(16, 4)
  d = forward._step_batched(m, d)
  full = forward._step_batched(m, d)
  part = forward._step_batched(m, types.carried(d))
  got, want = vars(part), vars(full)
  assert sum(v is not None for v in vars(d).values()) > len(types.CARRY)
  for k, v in want.items():
    if got[k] is None:
      assert v is None or v is getattr(d, k), k
    elif isinstance(v, types.Contact):
      for f, x in vars(v).items():
        assert torch.equal(getattr(got[k], f), x), k + '.' + f
    elif isinstance(v, torch.Tensor):
      assert torch.equal(got[k], v), k
    else:
      assert got[k] == v, k


@pytest.mark.parametrize('nwake,packed', [(5, True), (20, False)])
def test_sleep_skip_matches_the_full_step(nwake, packed):
  """At 64 worlds (a pack of 16 slots): 5 awake worlds fit it, 20 do
  not.  Two steps of ``_step_sleep_skip`` against ``_step_batched``."""
  m, d0 = settled_clutter(64, nwake)
  assert bool((d0.tree_asleep >= 0).all())
  da = db = d0
  n = forward.packed_steps
  for _ in range(2):
    da = forward._step_sleep_skip(m, da)
    db = forward._step_batched(m, db)
  assert forward.packed_steps - n == (2 if packed else 0)
  assert int(torch.any(da.tree_asleep < 0, dim=1).sum()) == nwake
  # the packed step leaves the asleep worlds' computed fields as it found
  # them (zeros, from make_data); the full step fills them
  idle = ~torch.any(d0.qfrc_applied != 0, dim=1)
  assert bool((da.qacc_smooth[idle] == 0).all()) == packed
  assert bool((da.qacc_smooth[~idle] != 0).any())
  np.testing.assert_array_equal(da.tree_asleep.numpy(),
                                db.tree_asleep.numpy())
  assert float((da.qpos - db.qpos).abs().max()) < 1e-6
  assert float((da.time - db.time).abs().max()) < 1e-5


def test_step_takes_the_skip_step_from_256_worlds(monkeypatch):
  """``forward.step`` with sleep on takes the skip step at 256 worlds and
  more (``forward.py:674-675``), the full step below; one host read per
  step decides whether the awake worlds fit the pack."""
  m, d = settled_clutter(256, 20)
  took = []
  monkeypatch.setattr(forward, '_step_batched',
                      lambda m, d, run_wake=True: took.append(
                          ('full', d.qpos.shape[0], run_wake)) or d)
  n = util.host_reads['pack']
  forward.step(m, d)
  assert util.host_reads['pack'] == n + 1
  # the pack of 64 slots ran the step, without a second wake pass
  assert took == [('full', 64, False)]
  forward.step(m, types.map_worlds(d, lambda x: x[:255], 256))
  assert took[-1] == ('full', 255, True)
