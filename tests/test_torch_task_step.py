"""The general step on the elliptic-cone tasks against the JAX
``forward.step`` (batched, jitted, its jnp path on the CPU), from the same
seeded state at 16 worlds, both sides in float64 (the JAX side under
``jax.enable_x64``): manipulator insert_peg and stacker stack_2 here,
whose solve is the elliptic solve kernel's (on the CPU its plain version,
``fused/solver_ref.py``, in float64); stack_4 (the torch elliptic Newton)
and finger_cg (the torch CG with elliptic cones) in
``tests/test_torch_task_step_torch.py``.  float64 on both sides, not the
JAX Pallas solve in interpret mode: each JAX step compiles in 8-17 s at
optimisation level 0 and runs three steps in about a second, where the
interpret-mode solve would take minutes.

The seeded state is ``parity.task_state`` (finger: ``touching``), with
live contacts in all three elliptic zones.  One step: the constraint rows
(efc_J, efc_D, efc_aref) and qacc, qpos, qvel and sensordata; then three
steps, each side from its own state of the step before: qpos, qvel and
sensordata.  Each within ``BARS`` of max(1, the world's largest |JAX|
entry): for the Newton scenes 1e-9 on qpos, 1e-7 on qvel and 1e-6 on
qacc and the rest, about ten times the largest error seen (3.5e-11,
8.8e-9, 9.7e-8); for CG, whose trip counts part even in float64 (5
against 43 in one world), 1e-6, 1e-5 and 1e-4 (seen: 6.7e-8, 9.2e-7,
1.5e-6, sensordata 6.8e-6)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import benchmarks, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_classic_step import fast_compile, touching
from tests.torch_threads import few_threads  # noqa: F401

pytest.importorskip('dm_control')

W = 16
# (qpos, qvel, qacc and the rest) relative to max(1, the world's scale)
BARS = {'newton': (1e-9, 1e-7, 1e-6), 'cg': (1e-6, 1e-5, 1e-4)}
ROWS = ('efc_J', 'efc_D', 'efc_aref')


def load(scene):
  """The scene's MjModel (finger_cg: finger under CG)."""
  mjm = tio.load_dmc('finger' if scene == 'finger_cg' else scene)
  if scene == 'finger_cg':
    mjm.opt.solver = int(types.SolverType.CG)
  return mjm


@functools.lru_cache(maxsize=None)
def case(scene):
  """(port float64 Model, the seeded state, the JAX float64 states before
  the first of three steps and after each).  The registered scene is the
  float32 form of the same model."""
  mjm = load(scene)
  m32 = tio.put_model(mjm, device='cpu')
  got, nworld = benchmarks.load_scene(scene, device='cpu')
  assert nworld == 8192 and got.nefc == m32.nefc and \
      got.opt.solver == m32.opt.solver
  state = touching(m32, 3, W) if scene == 'finger_cg' else \
      parity.task_state(m32, W, 0)
  with jax.enable_x64(True):
    mj = jio.put_model(mjm, dtype=np.float64, m_blocked=False,
                       efc_compact=False)
    a = lambda x: jnp.asarray(x.astype(np.float64))
    dj = jio.make_data(mj, nworld=W).replace(
        qpos=a(state[0]), qvel=a(state[1]), ctrl=a(state[2]))
    step = fast_compile(lambda x: jfwd.step(mj, x), dj)
    i32 = lambda x: jax.tree.map(
        lambda v: v.astype(jnp.int32) if v.dtype == jnp.int64 else v, x)
    outs = [dj]
    for _ in range(3):
      outs.append(i32(step(outs[-1])))
    outs = [jax.tree.map(np.asarray, x) for x in outs]
  return tio.put_model(mjm, device='cpu', dtype=torch.float64), state, outs


def start(scene):
  m, state, _ = case(scene)
  t = lambda x: torch.as_tensor(x).double()
  return m, tio.make_data(m, W, device='cpu').replace(
      qpos=t(state[0]), qvel=t(state[1]), ctrl=t(state[2]))


def close(got, want, name, tol):
  """Within ``tol`` of max(1, the world's largest |want|)."""
  got = got.numpy().reshape(W, -1)
  want = np.asarray(want, np.float64).reshape(W, -1)
  if not want.size:
    return
  scale = np.maximum(1.0, np.abs(want).max(1))
  err = (np.abs(got - want).max(1) / scale).max()
  assert err <= tol, (name, err)


def one_step(scene):
  m, d = start(scene)
  qpos_b, qvel_b, rest = BARS['cg' if m.opt.solver == types.SolverType.CG
                              else 'newton']
  got, want = forward.step(m, d), case(scene)[2][1]
  assert got.qpos.dtype == torch.float64
  for k in ROWS + ('qacc', 'sensordata'):
    close(getattr(got, k), getattr(want, k), k, rest)
  close(got.qpos, want.qpos, 'qpos', qpos_b)
  close(got.qvel, want.qvel, 'qvel', qvel_b)
  assert int(got.overflow.max()) == 0
  # contacts live in every world
  assert bool((got.efc_D[:, m.con_efc_address] > 0).any(1).all())


def three_steps(scene):
  m, d = start(scene)
  qpos_b, qvel_b, rest = BARS['cg' if m.opt.solver == types.SolverType.CG
                              else 'newton']
  for k, want in enumerate(case(scene)[2][1:]):
    d = forward.step(m, d)
    close(d.qpos, want.qpos, f'qpos {k}', qpos_b)
    close(d.qvel, want.qvel, f'qvel {k}', qvel_b)
    close(d.sensordata, want.sensordata, f'sensordata {k}', rest)
  assert bool(torch.isfinite(d.qpos).all())


SCENES = ('manipulator_insert_peg', 'stack_2')


@pytest.mark.parametrize('scene', SCENES)
def test_solve_kernel_scene_runs_it(scene):
  """These scenes take the solve kernel's elliptic form."""
  m = case(scene)[0]
  assert forward.solve_kernel_runs(m) and forward.unsupported(m) is None
  assert m.opt.cone == types.ConeType.ELLIPTIC


@pytest.mark.parametrize('scene', SCENES)
def test_one_step_matches_jax(scene):
  one_step(scene)


@pytest.mark.parametrize('scene', SCENES)
def test_three_steps_match_jax(scene):
  three_steps(scene)
