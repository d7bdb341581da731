"""``parity.check_solve``'s 'dmc' bar on a synthetic solve: a row's
efc_force may differ by what the two sides' own qacc difference moves it
by, D_r |J_r dqacc|, over the K4 bar (atol 1e-4 + rtol 1e-3 of the
world's largest |force|), and by no more."""

import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import parity
from tests.torch_threads import few_threads  # noqa: F401


def solve_pair():
  """Two solves of 4 worlds (6 rows, nv 3) whose qacc differ by 1e-3
  (within qacc's bar) and whose forces are exactly D (aref - J qacc); row
  0 is stiff (D 300) and near its boundary, so the qacc difference moves
  its force past the K4 bar."""
  rng = np.random.default_rng(0)
  nefc, nv, W = 6, 3, 4
  J = torch.as_tensor(rng.standard_normal((nefc, nv, W)), dtype=torch.float64)
  D = torch.ones((nefc, W), dtype=torch.float64)
  D[0] = 300.0
  qacc = torch.as_tensor(rng.standard_normal((nv, W)), dtype=torch.float64)
  Jq = torch.einsum('rvw,vw->rw', J, qacc)
  aref = Jq + 1.0
  aref[0] = Jq[0] + 1e-3
  dq = torch.full((nv, W), 1e-3, dtype=torch.float64)
  force = lambda q: D * (aref - torch.einsum('rvw,vw->rw', J, q))
  niter = torch.ones((1, W), dtype=torch.int32)
  want = (qacc, force(qacc), torch.zeros((nv, W)), niter)
  got = (qacc + dq, force(qacc + dq), torch.zeros((nv, W)), niter)
  return got, want, (J, D)


def test_dmc_force_bar_carries_the_qacc_difference():
  got, want, rows = solve_pair()
  with pytest.raises(AssertionError, match='efc_force'):
    parity.check_solve(got, want, 'contact')
  r = parity.check_solve(got, want, 'dmc', rows)
  assert r['force_past_bar'] > 0.0
  # a force error the qacc difference does not explain still fails
  bad = got[1].clone()
  bad[1, 2] += 0.05
  with pytest.raises(AssertionError, match='efc_force'):
    parity.check_solve((got[0], bad) + got[2:], want, 'dmc', rows)
