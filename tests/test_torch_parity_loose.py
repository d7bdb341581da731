"""``parity.check_solve``'s loose worlds (``parity.TOL_FLOOR``): under the
'dmc' bar, given the system, a world whose own opt.tolerance lies above
the float32 floor holds qfrc_constraint at the K4 bar plus |J|^T of the
rows' D |J dqacc|, as the 'adhesion' bar does; the choice comes from the
Model's tolerances, not from a scene's name.

The state: quadruped_dr (``benchmarks.randomize_quadruped``, tolerances
log-uniform on [1e-6, 1e-4]) after 7 steps from ``parity.dmc_state`` at
64 worlds in float64 (3.3 live contacts and 12.4 live rows per world).
The plain Newton in float32 at each world's own tolerance against the
same Newton in float64 run to its optimum (tolerance 1e-14).  A fault of
twice the plain bar on any one dof still fails in every world (measured:
1.0 for each of the 22 dofs), and the slack widens the bar of a loose
world only."""

import functools

import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import benchmarks, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.kernels import lanes
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.ops import forward
from tests.torch_threads import few_threads  # noqa: F401

W = 64
# share of worlds in which a qfrc_constraint fault of twice the plain bar
# on one dof must fail (measured: 1.0 for every dof)
CAUGHT_SHARE = 0.99


def rows(system):
  """The rows (J, D) of ``system`` in float64, as the optimum's."""
  return tuple(x.double() for x in system[1:3])


def quadruped(dtype):
  return tio.load_model_npz(tio.ACT_SNAPSHOTS['quadruped'], device='cpu',
                            dtype=dtype)


@functools.lru_cache(maxsize=None)
def solves():
  """(float32 plain solve at each world's tolerance, float64 optimum,
  the float32 system), lanes-last."""
  m64 = benchmarks.randomize_quadruped(quadruped(torch.float64), W)
  qpos, qvel, _ = parity.dmc_state(m64, 'quadruped', W, 0)
  st = types.carried(benchmarks.run(
      m64, nworld=W, nstep=5, warmup_steps=2, device='cpu',
      init_state={'qpos': qpos.astype(np.float64),
                  'qvel': qvel.astype(np.float64)})['state'])
  d = forward.mid(m64, forward.mass_chain(m64, forward.pre(m64, st)))
  d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m64, d.qLD,
                                                       d.qfrc_smooth))
  args = (lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
          lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
          lanes(d.qacc_warmstart), None)
  exact = m64.replace(opt=m64.opt.replace(
      tolerance=torch.tensor(1e-14, dtype=torch.float64), iterations=200),
      batch_fields=tuple(n for n in m64.batch_fields
                         if n != 'opt.tolerance'))
  m32 = benchmarks.randomize_quadruped(quadruped(torch.float32), W)
  sys32 = (m32,) + tuple(None if x is None else x.float() for x in args)
  return (solver_ref.solve_tiles(*sys32),
          solver_ref.solve_tiles(exact, *args), sys32)


def test_loose_worlds_come_from_the_model():
  got, want, sys32 = solves()
  assert 'quadruped_dr' not in parity.SOLVE_BAR_OF
  r = parity.check_solve(got, want, 'dmc', rows(sys32), system=sys32)
  assert r['loose_worlds'] == W
  unbatched = (quadruped(torch.float32),) + sys32[1:]
  r = parity.check_solve(got, want, 'dmc', rows(sys32), system=unbatched)
  assert r['loose_worlds'] == 0


def test_slack_only_in_loose_worlds():
  """A qfrc_constraint error past the plain bar by half its slack passes
  in a loose world and fails where the world stops at the floor."""
  got, want, sys32 = solves()
  J, D = rows(sys32)
  dq = got[0].double() - want[0]
  q_slack = torch.einsum('rvw,rw->vw', J.abs(),
                         D * torch.einsum('rvw,vw->rw', J, dq).abs())
  dof, w = np.unravel_index(int(q_slack.argmax()), q_slack.shape)
  assert float(q_slack[dof, w]) > 0.0
  one = lambda x: x[..., w:w + 1]
  bar = parity.QACC_ATOL + parity.QACC_RTOL * float(want[2][:, w].abs().max())
  bad = one(want[2]).clone().float()
  bad[dof] += bar + 0.5 * float(q_slack[dof, w])
  outs = (one(got[0]), one(got[1]), bad, one(got[3]))
  for m, passes in ((types.map_model_worlds(sys32[0], one), True),
                    (quadruped(torch.float32), False)):
    system = (m,) + tuple(None if x is None else one(x) for x in sys32[1:])
    check = lambda: parity.check_solve(outs, [one(x) for x in want], 'dmc',
                                       rows(system), system=system)
    if passes:
      check()
    else:
      with pytest.raises(AssertionError, match='qfrc_constraint'):
        check()


@pytest.mark.parametrize('dof', range(22))
def test_qfrc_fault_of_two_bars_still_fails(dof):
  got, want, sys32 = solves()
  bar = parity.QACC_ATOL + parity.QACC_RTOL * want[2].abs().amax(0)
  caught = 0
  for w in range(W):
    one = lambda x: x[..., w:w + 1]
    bad = one(got[2]).clone()
    bad[dof] += 2.0 * bar[w]
    system = (types.map_model_worlds(sys32[0], one),) + tuple(
        None if x is None else one(x) for x in sys32[1:])
    try:
      parity.check_solve((one(got[0]), one(got[1]), bad, one(got[3])),
                         [one(x) for x in want], 'dmc', rows(system),
                         system=system)
    except AssertionError as e:
      caught += 'qfrc_constraint' in str(e)
  assert caught / W >= CAUGHT_SHARE, caught / W
