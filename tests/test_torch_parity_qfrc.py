"""``parity.check_solve``'s 'adhesion' bar, the solve's bar of the
transmission scene (``parity.SOLVE_BAR_OF``): the 'dmc' bar, whose
qfrc_constraint bar also carries |J|^T of the rows' D |J dqacc|, as its
efc_force bar does (qfrc_constraint is J^T efc_force).

The witness: the transmission scene (a box pressed into the floor by
adhesion) after 7 steps of the rollout at 1024 worlds, in float64.  The
plain Newton at the model's tolerance against the same Newton run to
its exact optimum (tolerance 1e-14): qacc within the bar in every world,
yet qfrc_constraint past the 'dmc' bar in some worlds; under 'adhesion'
every world passes.  A fault of twice the plain bar on any one dof is
still caught in nearly every world."""

import functools

import pytest
import torch

from mujoco_warp_tpu_torch import benchmarks, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.kernels import lanes
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.ops import forward
from tests.torch_threads import few_threads  # noqa: F401

W = 1024
# share of worlds in which a qfrc_constraint fault of twice the plain bar
# on one dof must fail the 'adhesion' bar (measured: 0.9912-1.0 by dof)
CAUGHT_SHARE = 0.99


@functools.lru_cache(maxsize=None)
def solves():
  """(stopped at the tolerance, exact, rows (J, D)), lanes-last."""
  m = tio.load_model_npz(tio.ACT_SNAPSHOTS['transmission'], device='cpu',
                         dtype=torch.float64)
  st = types.carried(benchmarks.run(m, nworld=W, nstep=5, warmup_steps=2,
                                    device='cpu')['state'])
  d = forward.mid(m, forward.mass_chain(m, forward.pre(m, st)))
  d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m, d.qLD,
                                                       d.qfrc_smooth))
  args = (lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
          lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
          lanes(d.qacc_warmstart), None)
  exact = m.replace(opt=m.opt.replace(
      tolerance=torch.tensor(1e-14, dtype=torch.float64), iterations=200))
  return (solver_ref.solve_tiles(m, *args),
          solver_ref.solve_tiles(exact, *args), args[:2])


def test_tolerance_stop_needs_the_qfrc_slack():
  got, want, rows = solves()
  parity.check_world_scale(got[0], want[0], 'qacc')
  with pytest.raises(AssertionError, match='qfrc_constraint'):
    parity.check_solve(got, want, 'dmc', rows)
  assert parity.SOLVE_BAR_OF['transmission'] == 'adhesion'
  r = parity.check_solve(got, want, 'adhesion', rows)
  assert r['qfrc_past_bar'] > 0.0 and len(r['qfrc_worlds_past_bar']) >= 1
  assert r['qacc_max_abs_err'] < 1e-2


@pytest.mark.parametrize('dof', range(7))
def test_qfrc_fault_of_two_bars_still_fails(dof):
  got, want, (J, D) = solves()
  bar = parity.QACC_ATOL + parity.QACC_RTOL * want[2].abs().amax(0)
  caught = 0
  for w in range(W):
    one = lambda x: x[..., w:w + 1]
    bad = one(got[2]).clone()
    bad[dof] += 2.0 * bar[w]
    try:
      parity.check_solve((one(got[0]), one(got[1]), bad, one(got[3])),
                         [one(x) for x in want], 'adhesion',
                         (one(J), one(D)))
    except AssertionError as e:
      caught += 'qfrc_constraint' in str(e)
  assert caught / W >= CAUGHT_SHARE, caught / W
