"""How far valid Newton stops at loose tolerances lie apart: the seeded
spheres_elliptic solve (``parity.spheres_state``, 1000 worlds, seed 3,
the system of ``tests/test_torch_cuda.py``'s solve tests) with each
world's opt.tolerance drawn log-uniform on [1e-6, 1e-3] and ls_tolerance
U(0.005, 0.05) (seed 18), solved by the plain version in float32 and in
float64 at those tolerances, and on a card by the solve kernel, each
against the float64 plain solve run to its optimum (tolerance 1e-14):

  python tests/measure_loose_stops.py

Runs on the card where there is one, else on the CPU without the
kernel.  Prints, per decade of tolerance, each side's distance to the
optimum in qacc bars (``parity.QACC_ATOL`` + ``QACC_RTOL`` of the
optimum's world scale), and the worlds where two sides part past the
qacc bar, with their tolerances, Newton counts and distances."""

import os
import sys

import numpy as np
import torch

# the checkout's package, ahead of any installed one
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mujoco_warp_tpu_torch import io, parity
from mujoco_warp_tpu_torch.fused import solver_ref

W, SEED, DRAW_SEED = 1000, 3, 18


def main():
  dev = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
  torch.set_num_threads(4)
  path = io.SPHERES_ELLIPTIC_SNAPSHOT
  m = io.load_model_npz(path, device=dev)
  qpos, qvel, ctrl = [torch.as_tensor(x, device=dev)
                      for x in parity.spheres_state(m, W, SEED)]
  ws = torch.as_tensor(0.1 * np.random.default_rng(SEED).standard_normal(
      (W, m.nv)), dtype=torch.float32, device=dev)
  d = io.make_data(m, W, device=dev).replace(qpos=qpos, qvel=qvel,
                                             ctrl=ctrl, qacc_warmstart=ws)
  args = parity.solve_args(m, d)[0][1:]
  rng = np.random.default_rng(DRAW_SEED)
  draws = {'opt.tolerance': 10.0 ** rng.uniform(-6.0, -3.0, (W,)),
           'opt.ls_tolerance': rng.uniform(0.005, 0.05, (W,))}
  mb = io.batch_model(m, W, draws)
  m64 = io.load_model_npz(path, device=dev, dtype=torch.float64)
  a64 = [None if x is None else x.double() for x in args]
  sides = {'plain': solver_ref.solve_tiles(mb, *args),
           'float64': solver_ref.solve_tiles(io.batch_model(m64, W, draws),
                                             *a64)}
  if dev.type == 'cuda':
    from mujoco_warp_tpu_torch.kernels import solver as ksolver
    sides['kernel'] = ksolver.solve_tiles(mb, *args)
  opt = solver_ref.solve_tiles(m64.replace(opt=m64.opt.replace(
      tolerance=torch.tensor(1e-14, dtype=torch.float64, device=dev),
      iterations=200)), *a64)
  bar = parity.QACC_ATOL + parity.QACC_RTOL * opt[0].abs().amax(0)
  far = {k: ((v[0].double() - opt[0]).abs().amax(0) / bar).cpu()
         for k, v in sides.items()}
  tol = torch.as_tensor(draws['opt.tolerance'])
  print(f'device {dev}; {W} worlds')
  for k in sides:
    for lo in (-6, -5, -4):
      sel = (tol >= 10.0 ** lo) & (tol < 10.0 ** (lo + 1))
      print(f'{k}: tolerance in [1e{lo}, 1e{lo + 1}), {int(sel.sum())} '
            f'worlds: distance to the optimum in qacc bars, median '
            f'{float(far[k][sel].median()):.3f}, max '
            f'{float(far[k][sel].max()):.3f}')
  names = list(sides)
  for i, a in enumerate(names):
    for b in names[i + 1:]:
      ga, gb = sides[a][0].double(), sides[b][0].double()
      gap = ((ga - gb).abs().amax(0) - (parity.QACC_ATOL + parity.QACC_RTOL *
                                        gb.abs().amax(0))).cpu()
      past = torch.nonzero(gap > 0).reshape(-1).tolist()
      print(f'{a} against {b}: past the qacc bar in {len(past)} worlds; '
            + '; '.join(
                f'world {w}: tolerance {float(tol[w]):.3e}, past by '
                f'{float(gap[w]):.4f}, Newton counts '
                + ', '.join(f'{k} {int(sides[k][3][0, w])}' for k in names)
                + f', optimum {int(opt[3][0, w])}; distance to the optimum '
                + ', '.join(f'{k} {float(far[k][w]):.3f}' for k in names)
                for w in past))


if __name__ == '__main__':
  main()
