"""qacc past its bar, in a world whose solve has no live row, by each
side's gradient (``parity.check_solve`` with ``system``;
``parity.GRADIENT_BAR``).

swimmer15's solve sees no live row (contacts off), and its mass matrix
(cond ~1.8e5) is beyond what a float32 solve resolves at the K4 qacc bar
(atol 1e-4 + rtol 1e-3 of the world's largest |qacc|).  On the state of
a short rollout at 1024 worlds, with the plain solve on both sides:

- two float32 solves of one system, their qfrc_smooth and warmstart
  moved by 1e-7 of themselves (normal draws), part past the qacc bar in
  some world, so the qacc bar alone rejects valid answers;
- each one's own gradient stays within 1 tolerance, under the bar's 2;
- a fault of one qacc bar on one dof fails the gradient in every world
  (its gradient reads hundreds of tolerances);
- a world within the qacc bar passes, whatever its gradient, and a
  world with a live row keeps the qacc bar.
"""

import functools

import pytest
import torch

from mujoco_warp_tpu_torch import benchmarks, parity, types
from mujoco_warp_tpu_torch.fused import solver_ref
from tests.torch_threads import few_threads  # noqa: F401

W = 1024


@functools.lru_cache(maxsize=None)
def system(scene='swimmer15', nworld=W, nstep=6):
  m, _ = benchmarks.load_scene(scene, device='cpu')
  st = benchmarks.run(m, nworld=nworld, nstep=nstep, warmup_steps=2,
                      device='cpu')['state']
  args, _ = parity.solve_args(m, types.carried(st))
  return args


def moved(args, seed):
  g = torch.Generator().manual_seed(seed)
  out = list(args)
  for i in (6, 7):  # qfrc_smooth, warmstart
    out[i] = args[i] * (1 + 1e-7 * torch.randn(args[i].shape, generator=g))
  return out


def test_no_live_row():
  # the swimmers' solves see no live row; the choice of bar follows from
  # that, not from the scene's name
  for scene, nworld in (('swimmer15', W), ('swimmer6', 64)):
    args = system(scene, nworld, 2 if nworld < W else 6)
    assert float(args[2].abs().max()) == 0.0  # every row's D
    assert scene not in parity.SOLVE_BAR_OF


def test_valid_solves_part_past_the_qacc_bar_but_meet_the_gradient():
  args = system()
  a, b = (solver_ref.solve_tiles(*moved(args, s)) for s in (1, 2))
  with pytest.raises(AssertionError, match='qacc'):
    parity.check_solve(a, b, 'dmc', args[1:3])
  r = parity.check_solve(a, b, 'dmc', args[1:3], system=args)
  assert 0 < r['gradient_worlds'] < W
  for out in (a, b):
    assert float(parity.solve_gradient(args, out[0], out[1]).max()) <= 1.0


def test_one_bar_fault_fails_everywhere():
  args = system()
  want = solver_ref.solve_tiles(*args)
  bar = parity.QACC_ATOL + parity.QACC_RTOL * want[0].abs().amax(0)
  bad = want[0].clone()
  bad[3] = bad[3] + bar
  with pytest.raises(AssertionError, match='gradient'):
    parity.check_solve((bad,) + tuple(want[1:]), want, 'dmc', args[1:3],
                       system=args)
  gn = parity.solve_gradient(args, bad, want[1])
  assert float(gn.min()) > 100.0 * parity.GRADIENT_BAR


def test_the_qacc_bar_comes_first():
  args = system()
  want = solver_ref.solve_tiles(*args)
  bar = parity.QACC_ATOL + parity.QACC_RTOL * want[0].abs().amax(0)
  near = want[0].clone()
  near[3] = near[3] + 0.5 * bar
  assert float(parity.solve_gradient(args, near, want[1]).min()) > \
      parity.GRADIENT_BAR
  r = parity.check_solve((near,) + tuple(want[1:]), want, 'dmc', args[1:3],
                         system=args)
  assert r['gradient_worlds'] == 0


def test_live_worlds_keep_the_qacc_bar():
  args = list(system())
  # one live row in the first half of the worlds
  D = args[2].clone()
  D[0, :W // 2] = 1.0
  args[2] = D
  want = solver_ref.solve_tiles(*args)
  bar = parity.QACC_ATOL + parity.QACC_RTOL * want[0].abs().amax(0)
  # a fault of twice the bar on one dof: the rowless worlds are held by
  # the gradient (and fail it), a live world by the qacc bar
  bad = want[0].clone()
  bad[3] = bad[3] + 2.0 * bar
  with pytest.raises(AssertionError, match='gradient'):
    parity.check_solve((bad,) + tuple(want[1:]), want, 'dmc', args[1:3],
                       system=args)
  bad = want[0].clone()
  bad[3, 0] = bad[3, 0] + 2.0 * bar[0]
  with pytest.raises(AssertionError, match=r'^qacc: exceeds'):
    parity.check_solve((bad,) + tuple(want[1:]), want, 'dmc', args[1:3],
                       system=args)
