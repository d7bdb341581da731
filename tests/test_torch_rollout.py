"""The port's rollout (``benchmarks.rollout``) sorts worlds only where
the JAX harness does, and then permutes every per-world field; its scene
table; and the import hygiene of the whole port.

The JAX general rollout sorts worlds by Newton count only where its
Pallas solve kernel runs (``mujoco_warp_tpu/benchmarks.py:250-251``) and
then gathers every field whose leading dimension is the world count
(:254-259).  The port's counterpart is ``forward.solve_kernel_runs``.
"""

import os
import re

import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import benchmarks, fused
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import forward
from tests.torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_sorted(m, d, monkeypatch):
  """The state the general rollout steps first, from ``d``, with the step
  itself replaced by the identity."""
  monkeypatch.setattr(benchmarks, 'build', lambda *a, **k: d)
  monkeypatch.setattr(forward, 'step', lambda m, d: d)
  return next(benchmarks.rollout(m, d.qpos.shape[0], device='cpu',
                                 general=True))


def fields(obj, prefix=''):
  out = {}
  for k, v in vars(obj).items():
    if isinstance(v, types.Contact):
      out.update(fields(v, k + '.'))
    else:
      out[prefix + k] = v
  return out


def test_sort_gathers_every_per_world_field(monkeypatch):
  """On spheres (the solve kernel runs), after one real step every field
  of Data is set; the rollout's sort leaves each per-world field equal to
  the unsorted one gathered by the stable argsort of solver_niter (ctrl:
  the OU noise sets it after the sort)."""
  m = tio.load_model_npz(tio.SPHERES_SNAPSHOT, device='cpu')
  assert benchmarks.sorts(m, False)
  W = 8
  d = forward.step(m, tio.make_data(m, W, device='cpu'))
  niter = torch.as_tensor(np.random.default_rng(0).integers(0, 3, W),
                          dtype=torch.int32)
  d = d.replace(solver_niter=niter)
  out = first_sorted(m, d, monkeypatch)
  perm = torch.argsort(niter, stable=True)
  assert not torch.equal(perm, torch.arange(W))
  before, after = fields(d), fields(out)
  assert before.keys() == after.keys()
  seen = 0
  for k, x in before.items():
    y = after[k]
    if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == W:
      seen += 1
      if k != 'ctrl':
        assert torch.equal(y, x[perm]), k
    else:
      assert y is x, k
  assert seen >= 60, seen


@pytest.mark.parametrize('scene,sorted_', [
    ('clutter_arm_nosleep', False), ('spheres_cg', False),
    ('clutter_arm', False), ('spheres', True), ('constraints', True)])
def test_general_rollout_sorts_only_where_the_solve_kernel_runs(
    scene, sorted_, monkeypatch):
  """clutter_arm_nosleep and clutter_arm (the torch Newton) and
  spheres_cg (CG) keep their world order; spheres and constraints (the
  solve kernel) are sorted."""
  m, _ = benchmarks.load_scene(scene, device='cpu')
  assert benchmarks.sorts(m, False) == sorted_
  assert forward.solve_kernel_runs(m) == sorted_
  W = 8
  d = tio.make_data(m, W, device='cpu')
  d = d.replace(solver_niter=torch.arange(W, 0, -1, dtype=torch.int32),
                qpos=d.qpos + torch.arange(W)[:, None])
  out = first_sorted(m, d, monkeypatch)
  order = out.qpos[:, 0] - d.qpos[0, 0]
  want = torch.arange(W - 1, -1, -1) if sorted_ else torch.arange(W)
  assert torch.equal(order.round().long(), want)


def test_the_new_scenes():
  """clutter_arm and spheres_cg take the general step (sleep and CG no
  longer refused), humanoid_implicitfast the fused step; the settled
  clutter_arm state tiles to the registered width."""
  for name in ('clutter_arm', 'spheres_cg'):
    m, w = benchmarks.load_scene(name, device='cpu')
    assert forward.unsupported(m) is None and not fused.supported(m), name
  m, w = benchmarks.load_scene('humanoid_implicitfast', device='cpu')
  assert w == 8192 and fused.supported(m)
  assert m.opt.integrator == types.IntegratorType.IMPLICITFAST
  m, w = benchmarks.load_scene('clutter_arm', device='cpu')
  st = tio.load_state(tio.CLUTTER_ARM_SETTLED)
  d = benchmarks.build(m, 128, device='cpu', init_state=st)
  assert torch.equal(d.qpos[64:], torch.as_tensor(st['qpos']))
  assert torch.equal(d.tree_asleep[:64], torch.as_tensor(st['tree_asleep']))
  # the clutter trees (all but the arm) asleep
  assert bool((d.tree_asleep[:, 1:] >= 0).all())


def test_replay_starts_from_its_recorded_state():
  """A replay's recorded qpos and qvel are the start state of every world
  (``build``'s ``init_state``); a second start state is refused."""
  m = tio.load_model_npz(device='cpu')
  rng = np.random.default_rng(0)
  rp = dict(ctrl=np.zeros((2, m.nu)),
            qpos=m.qpos0.numpy() + 0.1 * rng.standard_normal(m.nq),
            qvel=rng.standard_normal(m.nv))
  d = benchmarks.build(m, 4, device='cpu', init_state={
      'qpos': rp['qpos'][None].astype(np.float32),
      'qvel': rp['qvel'][None].astype(np.float32)})
  for k in ('qpos', 'qvel'):
    np.testing.assert_array_equal(
        getattr(d, k).numpy(), np.broadcast_to(
            rp[k].astype(np.float32), getattr(d, k).shape), err_msg=k)
  with pytest.raises(ValueError, match='replay'):
    benchmarks.rollout(m, 4, device='cpu', replay=rp,
                       init_state={'qpos': rp['qpos'][None]})


_IMPORT = re.compile(r'^\s*(?:from|import)\s+(jax|mujoco_warp_tpu)(?:[.\s]|$)',
                     re.M)


def test_port_sources_import_no_jax():
  """No source of the port, nor chip_smoke.py, imports jax or the JAX
  package (``mujoco_warp_tpu``; ``mujoco_warp_tpu_torch`` is the port)."""
  paths = [os.path.join(_REPO, 'chip_smoke.py')]
  for root, _, files in os.walk(os.path.join(_REPO, 'mujoco_warp_tpu_torch')):
    paths += [os.path.join(root, f) for f in files if f.endswith('.py')]
  assert len(paths) > 30
  bad = [(p, m.group(0).strip()) for p in paths
         for m in _IMPORT.finditer(open(p).read())]
  assert not bad, bad


@pytest.mark.parametrize('name', ['clutter_arm', 'clutter'])
def test_sleep_snapshots_match_fresh_put_model(name, tmp_path):
  """The committed snapshots are what ``--snapshot`` writes today."""
  from tests.test_torch_io import assert_models_equal
  make, path = {
      'clutter_arm': (tio.make_clutter_arm_snapshot,
                      tio.CLUTTER_ARM_SNAPSHOT),
      'clutter': (tio.make_clutter_sleep_snapshot,
                  tio.CLUTTER_SLEEP_SNAPSHOT)}[name]
  fresh = make(str(tmp_path / 'm.npz'))
  assert_models_equal(tio.load_model_npz(path, device='cpu'), fresh)
  assert fresh.opt.enableflags & types.EnableBit.SLEEP and fresh.ntree == 13 - (
      name == 'clutter')
