"""The general step on stack_4 (nefc 1025 x nv 20: the torch elliptic
Newton, its H factored by ``chol_batched`` and solved by ``chol_solve``)
and finger_cg (finger under CG with elliptic cones, M^-1 grad by
``chol_solve``) against the JAX ``forward.step`` in float64, one step and
then three, at the bars of ``tests/test_torch_task_step.py`` (its
docstring says how they were set)."""

import numpy as np
import pytest

from mujoco_warp_tpu_torch import io, types
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_task_step import case, one_step, three_steps
from tests.torch_threads import few_threads  # noqa: F401

SCENES = ('stack_4', 'finger_cg')


@pytest.mark.parametrize('scene', SCENES)
def test_torch_solver_scene_takes_it(scene):
  """These scenes take the torch solver: stack_4 beyond the solve kernel,
  finger_cg by its CG solver."""
  m = case(scene)[0]
  assert not forward.solve_kernel_runs(m) and forward.unsupported(m) is None
  assert m.opt.cone == types.ConeType.ELLIPTIC
  assert forward.large_system(m) == (scene == 'stack_4')


@pytest.mark.parametrize('scene', SCENES)
def test_one_step_matches_jax(scene):
  one_step(scene)


@pytest.mark.parametrize('scene', SCENES)
def test_three_steps_match_jax(scene):
  three_steps(scene)


@pytest.mark.parametrize('scene', sorted(io.TASK_STARTS))
def test_committed_start_state_is_its_makers(scene, tmp_path):
  """Each elliptic-cone task's committed start state (``io.TASK_STARTS``)
  is what ``io.make_task_start`` makes now, field by field."""
  path = str(tmp_path / 'start.npz')
  io.make_task_start(scene, path)
  got, want = io.load_state(io.TASK_STARTS[scene]), io.load_state(path)
  assert sorted(got) == sorted(want) == sorted(io.STATE_FIELDS)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
