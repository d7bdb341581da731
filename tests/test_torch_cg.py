"""The port's CG solver (``ops/solver.py`` with ``opt.solver=cg``) against
the JAX package on ``spheres_cg`` (``spheres.xml`` with the CG solver,
lossless slots).

The solve: the torch solver against the JAX ``ops/solver.solve`` under
``vmap`` on the same assembled system, the seeded contact state of
``parity.spheres_state`` at 128 worlds through the port's stages before
the solve (their ``qLD``, which CG's M^-1 grad reads, included; the
bar's own measurement, ``tests/measure_cg_bar.py``, assembles with the
JAX stages):
qacc, efc_force and qfrc_constraint at the K4 bars, efc_force with the
slack each row's D |J dqacc| allows, and trip counts at the 'cg' bar of
``mujoco_warp_tpu_torch.parity`` (measured there).  The step: three
general steps of the port against the JAX ``forward.step`` at 32 worlds,
each from the JAX state of the step before, at the bars of
``tests/test_fused.py`` (qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3 rtol
5e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu.ops import solver as jsolver
from mujoco_warp_tpu_torch import fused, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.kernels import lanes
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.kernels import solver as ksolver
from mujoco_warp_tpu_torch.ops import forward
from mujoco_warp_tpu_torch.ops import solver as osolver
from tests.oracle import assert_close
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

_FIELDS = ('efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qM', 'qLD',
           'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart', 'qpos')


@functools.lru_cache(maxsize=None)
def models():
  """(JAX Model, port Model) of spheres_cg, as the JAX benchmark builds
  it (``opt.solver`` set before ``put_model``, ``nconmax=None``)."""
  mjm = tio.load_spheres()
  mjm.opt.solver = int(types.SolverType.CG)
  return jio.put_model(mjm, nconmax=None), tio.put_model(mjm, device='cpu')


def fast_compile(fn, x):
  """``fn`` jitted for ``x``, with XLA's backend optimisations off: the
  compiles are most of this file's time, and the runs few."""
  return jax.jit(fn).lower(x).compile({'xla_backend_optimization_level': 0})


def start(W, seed):
  mj, m = models()
  qpos, qvel, ctrl = parity.spheres_state(m, W, seed)
  return mj, m, jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))


def test_spheres_cg_model():
  """The snapshot is what ``--snapshot`` writes today; the general step
  takes it with the torch solver (the solve kernel is Newton-only)."""
  mj, m = models()
  assert not mj.m_blocked
  assert_models_equal(tio.load_model_npz(tio.SPHERES_CG_SNAPSHOT,
                                         device='cpu'), m)
  assert forward.unsupported(m) is None and not fused.supported(m)
  assert not forward.large_system(m) and not forward.solve_kernel_runs(m)


@functools.lru_cache(maxsize=None)
def system():
  """(model, world-major Data before the solve, the JAX solve's lanes-last
  (qacc, efc_force, qfrc_constraint, niter), rows (J, D) lanes-last, the
  JAX solve's overflow) on the seeded state at 128 worlds."""
  mj, m, dj = start(128, 0)
  W = dj.qpos.shape[0]
  # the port's stages assemble the system; both solvers take it
  d = tio.make_data(m, W, device='cpu').replace(**{
      k: torch.as_tensor(np.array(getattr(dj, k)))
      for k in ('qpos', 'qvel', 'ctrl')})
  d = forward.mid(m, kmass.mass_chain(m, forward.pre(m, d)))
  d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m, d.qLD,
                                                       d.qfrc_smooth))
  db = dj.replace(**{k: jnp.asarray(getattr(d, k).numpy())
                     for k in _FIELDS})
  want = fast_compile(jax.vmap(lambda x: jsolver.solve(mj, x)), db)(db)
  return m, d, [torch.as_tensor(np.array(getattr(want, k))).T for k in
                ('qacc', 'efc_force', 'qfrc_constraint')] + [
                    np.asarray(want.solver_niter)], (
                        lanes(d.efc_J), lanes(d.efc_D)), np.asarray(
                            want.overflow)


def lanes_out(got):
  return [got.qacc.T, got.efc_force.T, got.qfrc_constraint.T,
          got.solver_niter]


def test_cg_solve_matches_jax():
  m, d, want, rows, overflow = system()
  trips, cs = osolver.trips, klinalg.launches['chol_solve']
  sv = ksolver.launches
  got = osolver.solve(m, d)
  assert ksolver.launches == sv and klinalg.launches['chol_solve'] == cs
  assert osolver.trips - trips == int(got.solver_niter.max())
  rs = parity.check_solve(lanes_out(got), want, 'cg', rows)
  np.testing.assert_array_equal(got.overflow.numpy(), overflow)
  assert rs['niter_mean'] > 10.0, 'CG should take many trips here'
  assert float(d.efc_D.count_nonzero()) > 0


@pytest.mark.parametrize('fault', ['beta 0', 'beta of the wrong sign'])
def test_cg_bar_rejects_a_planted_fault(fault, monkeypatch):
  """The 'cg' bar tells a CG that lost its conjugacy from a sound one:
  with beta forced to 0 (steepest descent in the M metric), or with the
  sign of beta flipped, the port's solve misses qacc's bar, and its trip
  counts alone miss theirs (most worlds run to the 100-trip cap)."""
  sound = osolver._polak_ribiere
  monkeypatch.setattr(osolver, '_polak_ribiere', {
      'beta 0': lambda g, *_: torch.zeros_like(g[:, 0]),
      'beta of the wrong sign': lambda *a: -sound(*a)}[fault])
  m, d, want, rows, _ = system()
  got = lanes_out(osolver.solve(m, d))
  with pytest.raises(AssertionError, match='qacc'):
    parity.check_solve(got, want, 'cg', rows)
  with pytest.raises(AssertionError, match='niter'):
    parity.check_niter(got[3], want[3], 'cg')


@functools.lru_cache(maxsize=None)
def jax_states(W, n):
  """The JAX state before each of n steps and after the last."""
  mj, _, dj = start(W, 1)
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  out = [dj]
  for _ in range(n):
    out.append(step(out[-1]))
  return tuple(out)


@pytest.mark.parametrize('k', range(3))
def test_cg_step_matches_jax(k):
  """Step k + 1 of the port from the JAX state after step k."""
  _, m = models()
  before, after = jax_states(32, 3)[k:k + 2]
  W = before.qpos.shape[0]
  d = tio.make_data(m, W, device='cpu').replace(**{
      f: torch.as_tensor(np.array(getattr(before, f))) for f in
      ('time', 'qpos', 'qvel', 'ctrl', 'qacc_warmstart')})
  got = forward.step(m, d)
  assert_close(got.qpos.numpy(), np.asarray(after.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(got.qvel.numpy(), np.asarray(after.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)
  np.testing.assert_array_equal(got.ncon_active.numpy(),
                                np.asarray(after.ncon_active))
  assert int(got.overflow.max()) == 0 and float(
      got.solver_niter.float().mean()) > 1.0
