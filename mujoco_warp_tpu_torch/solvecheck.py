"""The solve kernel against its plain version along a scene's rollout,
and the worlds where they part, with a float64 witness.

On the card::

  python -m mujoco_warp_tpu_torch.solvecheck --scene tendon_mix \\
      --steps 110 --every 5 --start 40 --out solvecheck.npz

``benchmarks.rollout`` of the scene at its registered width (seed 0, as
``chip_smoke.py`` runs it), and at every ``--every`` steps from
``--start``: the system each world hands the solve (the step's own
stages before it), the solve kernel (``kernels/solver.solve_tiles``) and
its plain version (``fused/solver_ref.solve_tiles``) on it, and
``parity.check_solve`` at the scene's bar ('elliptic' with elliptic
cones, else ``parity.SOLVE_BAR_OF``'s or 'dmc', as ``chip_smoke.py``
holds it).  One line per
checkpoint: the bar's verdict, the worlds whose qacc lies past the K4 bar
(atol ``QACC_ATOL`` + rtol ``QACC_RTOL`` of the world's largest |qacc|),
and the Newton counts of the kernel and the plain version there.  The
inputs and both outputs of those worlds, and of the ``--keep`` nearest
the bar at each checkpoint, go to ``--out``.

On the CPU::

  python -m mujoco_warp_tpu_torch.solvecheck --witness solvecheck.npz

For each kept world, the plain solve in float64 on the same inputs at
the Model's tolerance, and at tolerance 1e-14 (the optimum): Newton
counts, each qacc's distance to the optimum over the K4 bar, and the
first Newton trip's step and stop quantities (improvement, gradient and
model improvement over the tolerance) in float64 and in the plain
float32 version.
"""

import argparse

import numpy as np
import torch

from mujoco_warp_tpu_torch import benchmarks, io, parity, types
from mujoco_warp_tpu_torch.fused import solver_ref
from mujoco_warp_tpu_torch.kernels import lanes
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import solver as ksolver
from mujoco_warp_tpu_torch.ops import forward

# the lanes-last inputs of ``solve_tiles`` after the Model, by name
INPUTS = ('J', 'D', 'aref', 'fl', 'M', 'qfs', 'qacc0', 's')


def system(m: types.Model, d: types.Data) -> tuple:
  """``solve_tiles``'s arguments for world-major carried state ``d``:
  the step's stages before the solve, with their kernels."""
  d = forward.mid(m, forward.mass_chain(m, forward.pre(m, d)))
  d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m, d.qLD,
                                                       d.qfrc_smooth))
  ell = bool(solver_ref.ell_groups(m))
  return (m, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
          lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
          lanes(d.qacc_warmstart),
          solver_ref.ell_scales(m, d.contact.friction) if ell else None)


def past_bar(got, want) -> torch.Tensor:
  """(W,) how far each world's qacc lies past the K4 bar (> 0: past)."""
  err = (got - want).abs().amax(0)
  return err - (parity.QACC_ATOL + parity.QACC_RTOL *
                want.abs().amax(0))


def check(scene: str, steps: int, every: int, start: int, keep: int,
          out: str, nworld=None, device=None):
  """The card run of the module docstring; ``nworld`` and ``device``
  (default the registered width, the card) let a test run it small on
  the CPU, where the kernel's wrapper runs its plain version."""
  m, width = benchmarks.load_scene(scene, device=device)
  nworld = nworld or width
  bar = 'elliptic' if solver_ref.ell_groups(m) else (
      parity.SOLVE_BAR_OF.get(scene, 'dmc'))
  gen = benchmarks.rollout(m, nworld, 0, device,
                           init_state=benchmarks.start_state(scene))
  kept = {k: [] for k in INPUTS + (
      'step', 'world', 'qacc_kernel', 'qacc_plain', 'niter_kernel',
      'niter_plain', 'past')}
  for step in range(1, steps + 1):
    st = next(gen)
    if step < start or (step - start) % every:
      continue
    args = system(m, types.carried(st))
    got = ksolver.solve_tiles(*args)
    want = solver_ref.solve_tiles(*args)
    try:
      parity.check_solve(got, want, bar, args[1:3], system=args)
      verdict = 'within'
    except AssertionError as e:
      verdict = f'MISSED ({e})'
    past = past_bar(got[0], want[0])
    nk, npl = got[3].reshape(-1), want[3].reshape(-1)
    bad = torch.nonzero(past > 0).reshape(-1)
    near = torch.argsort(past, descending=True)[:keep]
    ids = torch.unique(torch.cat([bad, near]))
    print(f'step {step}: {bar} bar {verdict}; Newton counts equal in '
          f'{float((nk == npl).float().mean()):.4f} of worlds; worlds past '
          'the qacc bar: ' + (', '.join(
              f'{int(w)} (by {float(past[w]):.3g}, counts kernel '
              f'{int(nk[w])} plain {int(npl[w])})' for w in bad) or 'none')
          + f'; nearest {float(past.max()):.3g}', flush=True)
    for name, x in zip(INPUTS, args[1:]):
      kept[name] += [None if x is None else x[..., w].cpu().numpy()
                     for w in ids]
    for w in ids:
      kept['step'].append(step)
      kept['world'].append(int(w))
      kept['qacc_kernel'].append(got[0][:, w].cpu().numpy())
      kept['qacc_plain'].append(want[0][:, w].cpu().numpy())
      kept['niter_kernel'].append(int(nk[w]))
      kept['niter_plain'].append(int(npl[w]))
      kept['past'].append(float(past[w]))
  if kept['s'] and kept['s'][0] is None:
    kept.pop('s')
  np.savez_compressed(out, scene=scene, **{k: np.stack(v)
                                           for k, v in kept.items()})
  print(f'wrote {out}: {len(kept["step"])} worlds')


def witness(path: str):
  z = np.load(path)
  scene = str(z['scene'])
  m32, _ = benchmarks.load_scene(scene, device='cpu')
  m = io.load_model_npz(benchmarks.SCENES[scene][0], device='cpu',
                        dtype=torch.float64)
  f64 = lambda x: torch.as_tensor(x).double()
  opt = m.replace(opt=m.opt.replace(tolerance=f64(1e-14), iterations=1000))
  t = lambda k: f64(np.moveaxis(z[k], 0, -1)) if k in z.files else None
  args = [t(k) for k in INPUTS]
  best = solver_ref.solve_tiles(opt, *args)

  def traced(model, dtype):
    trace = []
    return solver_ref.solve_tiles(
        model, *[None if a is None else a.to(dtype) for a in args],
        trace=lambda niter, *q: trace.append(
            [x.reshape(-1).clone() for x in q[:4]])), trace

  (same, tr64), (plain32, tr32) = (traced(m, torch.float64),
                                   traced(m32, torch.float32))
  trips = {'float64': tr64, 'float32': tr32}
  bar = parity.QACC_ATOL + parity.QACC_RTOL * best[0].abs().amax(0)
  dist = lambda q: ((f64(q) - best[0]).abs().amax(0) / bar).numpy()
  kern, plain = dist(z['qacc_kernel'].T), dist(z['qacc_plain'].T)
  cpu32, f64same = dist(plain32[0]), dist(same[0])
  apart = ((f64(z['qacc_kernel'].T) - f64(z['qacc_plain'].T)).abs().amax(0)
           / bar).numpy()
  tol = float(m.opt.tolerance)
  print(f'{scene}: tolerance {tol:g}; distance of each '
        'qacc to the float64 optimum (tolerance 1e-14) over the K4 bar')
  for i in np.argsort(-z['past']):
    print(f"  step {int(z['step'][i])} world {int(z['world'][i])}: past "
          f"the bar by {float(z['past'][i]):.3g} (kernel to plain "
          f'{apart[i]:.3g} bars); Newton counts kernel '
          f"{int(z['niter_kernel'][i])}, plain {int(z['niter_plain'][i])}, "
          f'plain on the CPU {int(plain32[3][0, i])}, float64 '
          f'{int(same[3][0, i])}, optimum {int(best[3][0, i])}; to the '
          f'optimum: kernel {kern[i]:.3g}, plain {plain[i]:.3g}, plain on '
          f'the CPU {cpu32[i]:.3g}, float64 at the tolerance '
          f'{f64same[i]:.3g}')
    for name, tr in trips.items():
      alpha, impr, gnorm, model = (float(x[i]) for x in tr[0])
      print(f'    {name} trip 1: alpha {alpha:.6g}, improvement / tol '
            f'{impr / tol:.4g}, gradient / tol {gnorm / tol:.4g}, model '
            f'improvement / tol {model / tol:.4g}')


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--scene', default='tendon_mix')
  p.add_argument('--steps', type=int, default=110)
  p.add_argument('--every', type=int, default=5)
  p.add_argument('--start', type=int, default=40)
  p.add_argument('--keep', type=int, default=4)
  p.add_argument('--out', default='solvecheck.npz')
  p.add_argument('--witness', metavar='NPZ')
  args = p.parse_args()
  if args.witness:
    witness(args.witness)
  else:
    check(args.scene, args.steps, args.every, args.start, args.keep,
          args.out)


if __name__ == '__main__':
  main()
