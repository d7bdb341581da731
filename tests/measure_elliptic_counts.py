"""Measures where the float64 elliptic Newton counts of the port and of
the JAX package part (parity's 'elliptic64' bar), on the CPU.

  python -m tests.measure_elliptic_counts [--worlds 32] [--seeds 4]

For each seed of ``parity.task_state`` on stack_4 (float64 on both
sides, the port's system handed to the JAX solve as
``tests/test_torch_elliptic.py`` hands it), one line prints the share of
worlds whose Newton counts are equal:

- port against the JAX ``solver.solve`` (its ``while_loop``, under
  ``vmap``);
- the JAX ``solve`` against the same JAX functions run one Newton trip
  at a time (one jitted trip under ``vmap``, the loop in Python): the
  same code, compiled another way;
- the port against the port with ``torch.linalg.cholesky`` (LAPACK, as
  the JAX side factors H on a CPU) in place of the plain lane Cholesky.

Then, for each world whose counts differ, each side's trips: the step
alpha and the three stop quantities (improvement, gradient and model
improvement, each rescaled as the solver does) over the tolerance.

Last, ``first_linesearch``: the first trip of one world from the two
sides' search directions, which agree to rounding, through the port's
linesearch, with each bracket step.
"""

import argparse
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_warp_tpu.ops import solver as jsolver
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.kernels import linalg as klinalg
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import forward
from mujoco_warp_tpu_torch.ops import solver as osolver
from tests import test_torch_elliptic as te
from tests.test_torch_classic_step import fast_compile


def _patched(fn, anchor, line, **env):
  """``osolver.<fn>`` with ``line`` inserted after ``anchor``, run in the
  module's namespace plus ``env``."""
  src = inspect.getsource(getattr(osolver, fn))
  assert src.count(anchor) == 1, anchor
  ns = dict(vars(osolver), **env)
  exec(compile(src.replace(anchor, anchor + line), osolver.__file__,
               'exec'), ns)
  return ns[fn]


def system(seed: int, W: int):
  """The port's float64 Model and Data before the solve, at
  ``parity.task_state`` of ``seed`` on stack_4."""
  mjm = te.load('stack_4')
  m = tio.put_model(mjm, device='cpu', dtype=torch.float64)
  qpos, qvel, ctrl = parity.task_state(tio.put_model(mjm, device='cpu'), W,
                                       seed)
  t = lambda x: torch.as_tensor(x).double()
  d = tio.make_data(m, W, device='cpu').replace(qpos=t(qpos), qvel=t(qvel),
                                                ctrl=t(ctrl))
  d = forward.mid(m, kmass.mass_chain(m, forward.pre(m, d)))
  return m, d.replace(qacc_smooth=klinalg.chol_solve_batched(
      m, d.qLD, d.qfrc_smooth))


def port_trips(m, d):
  """The port's Newton counts and, per trip, (alpha, improvement,
  gradient, model improvement, live) of every world."""
  rec = []
  solve = _patched(
      'solve', '    converged = (impr < tol) | (grad_norm < tol) | '
      '(model_improvement < tol)\n',
      '    _REC.append([x.clone() for x in (alpha, impr, grad_norm, '
      'model_improvement, live)])\n', _REC=rec)
  niter = solve(m, d).solver_niter.numpy()
  return niter, [[x.numpy() for x in r] for r in rec]


def _jax_parts(d):
  """(JAX Model, JAX Data, static tables, mu scale) of the port's system
  ``d``; call under ``jax.enable_x64``."""
  te.W = d.qpos.shape[0]
  mj, dj = te.jax_system(d)
  mu_scale = 1.0 / jnp.sqrt(jnp.maximum(
      mj.opt.impratio.astype(jnp.float64), jsolver._MINVAL))
  return mj, dj, jsolver._static_tables(mj), mu_scale


def _jax_start(mj, st, mu_scale):
  def start(dd):
    qacc = dd.qacc_warmstart
    Jaref = jsolver._j_mul(mj, dd, qacc) - dd.efc_aref
    Ma = jsolver.smooth.mul_m(mj, dd, qacc)
    force, state, _ = jsolver._update_constraint(mj, dd, st, Jaref, mu_scale)
    _, Mgrad, _ = jsolver._gradient(mj, dd, st, Ma, force, state, Jaref,
                                    mu_scale)
    return qacc, Ma, Jaref, -Mgrad
  return start


def jax_trips(d):
  """The JAX ``solve``'s Newton counts; the counts of the same JAX
  functions run one trip at a time, and per trip (alpha, improvement,
  gradient, model improvement, live) of every world."""
  W = d.qpos.shape[0]
  with jax.enable_x64(True):
    mj, dj, st, mu_scale = _jax_parts(d)
    tol = float(mj.opt.tolerance)
    rescale = 1.0 / (float(mj.stat.meaninertia) * mj.nv)

    def trip(dd, qacc, Ma, Jaref, search):
      alpha, impr, jv, mv = jsolver._linesearch(mj, dd, st, qacc, Ma, Jaref,
                                                search, mu_scale)
      qacc, Ma, Jaref = qacc + alpha * search, Ma + alpha * mv, \
          Jaref + alpha * jv
      force, state, _ = jsolver._update_constraint(mj, dd, st, Jaref,
                                                   mu_scale)
      grad, Mgrad, _ = jsolver._gradient(mj, dd, st, Ma, force, state,
                                         Jaref, mu_scale)
      return (qacc, Ma, Jaref, -Mgrad, alpha, rescale * impr,
              rescale * jnp.sqrt(jnp.maximum(jnp.dot(grad, grad), 0.0)),
              rescale * 0.5 * jnp.dot(grad, Mgrad))

    carry = jax.jit(jax.vmap(_jax_start(mj, st, mu_scale)))(dj)
    step = jax.jit(jax.vmap(trip))
    done, niter, rec = np.zeros(W, bool), np.zeros(W, int), []
    while not done.all():
      out = step(dj, *carry)
      alpha, impr, gn, mi = (np.asarray(x) for x in out[4:])
      rec.append([alpha, impr, gn, mi, ~done])
      frozen = jnp.asarray(done)
      carry = tuple(jnp.where(frozen.reshape((-1,) + (1,) * (n.ndim - 1)),
                              o, n) for o, n in zip(carry, out[:4]))
      niter = np.where(done, niter, niter + 1)
      done = done | (impr < tol) | (gn < tol) | (mi < tol) | (
          niter >= mj.opt.iterations)
    whole = np.asarray(fast_compile(
        jax.vmap(lambda x: jsolver.solve(mj, x)), dj)(dj).solver_niter)
  return whole, niter, rec, tol


def _lapack_chol(m, A, jitter=0.0):
  n = A.shape[-1]
  return torch.linalg.cholesky(
      A + jitter * torch.eye(n, dtype=A.dtype)).contiguous()


def port_lapack_counts(m, d):
  """The port's Newton counts with H factored by LAPACK."""
  plain = klinalg.chol_batched
  klinalg.chol_batched = _lapack_chol
  try:
    return osolver.solve(m, d).solver_niter.numpy()
  finally:
    klinalg.chol_batched = plain


def first_linesearch(m, d, world: int):
  """The first Newton trip of ``world``: the port's search direction and
  the JAX one, their largest difference and scale, and the port's
  linesearch from each: (alpha, each bracket step's (lo alpha, lo
  slope, hi alpha, hi slope, swapped, done))."""
  W = d.qpos.shape[0]
  st = osolver._static_tables(m, d.qpos)
  qacc = d.qacc_warmstart
  Jaref = osolver._mv(d.efc_J, qacc) - d.efc_aref
  Ma = osolver._mv(d.qM, qacc)
  force, state = osolver._update_constraint(d, st, Jaref)
  _, Mgrad, _ = osolver._gradient(m, d, st, Ma, force, state, Jaref)
  with jax.enable_x64(True):
    mj, dj, jst, mu_scale = _jax_parts(d)
    jsearch = torch.as_tensor(np.array(jax.jit(jax.vmap(
        _jax_start(mj, jst, mu_scale)))(dj)[3]))
  out = {'search_diff': float((jsearch + Mgrad)[world].abs().max()),
         'search_scale': float(Mgrad[world].abs().max())}
  live = torch.ones(W, dtype=torch.bool)
  for name, search in (('port', -Mgrad), ('jax', jsearch)):
    steps = []
    ls = _patched(
        '_linesearch', '    ls_done = ls_done | (run & done_now)\n',
        '    _STEPS.append((float(lo_a3[_W]), float(lo3[_W, 1]), '
        'float(hi_a3[_W]), float(hi3[_W, 1]), bool((swap_lo | swap_hi)'
        '[_W]), bool(done_now[_W])))\n', _STEPS=steps, _W=world)
    alpha = ls(m, d, st, Ma, Jaref, search, live)[0]
    out[name] = (float(alpha[world]), steps)
  return out


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--worlds', type=int, default=32)
  p.add_argument('--seeds', type=int, default=4)
  p.add_argument('--trace', type=int, nargs=2, default=(3, 6),
                 metavar=('SEED', 'WORLD'),
                 help='the world whose first linesearch is printed')
  args = p.parse_args()
  for seed in range(args.seeds):
    m, d = system(seed, args.worlds)
    pn, prec = port_trips(m, d)
    jn, jtn, jrec, tol = jax_trips(d)
    ln = port_lapack_counts(m, d)
    print(f'seed {seed} (tolerance {tol:g}): port = JAX {np.mean(pn == jn)}'
          f', JAX = JAX by trip {np.mean(jn == jtn)}, port = port with '
          f'LAPACK {np.mean(pn == ln)}, port with LAPACK = JAX '
          f'{np.mean(ln == jn)}')
    for w in np.nonzero((pn != jn) | (jn != jtn))[0]:
      print(f'  world {w}: Newton counts port {pn[w]}, JAX {jn[w]}, JAX by '
            f'trip {jtn[w]}, port with LAPACK {ln[w]}')
      for name, rec in (('port', prec), ('JAX by trip', jrec)):
        for k, (alpha, impr, gn, mi, live) in enumerate(rec):
          if not live[w]:
            break
          print(f'    {name} trip {k + 1}: alpha {alpha[w]:.17g}, '
                f'improvement / tol {impr[w] / tol:.6g}, gradient / tol '
                f'{gn[w] / tol:.6g}, model improvement / tol '
                f'{mi[w] / tol:.6g}')
  seed, world = args.trace
  m, d = system(seed, args.worlds)
  out = first_linesearch(m, d, world)
  print(f'seed {seed} world {world}, first trip: search directions differ '
        f"by {out['search_diff']:.6g} of {out['search_scale']:.6g}")
  for name in ('port', 'jax'):
    alpha, steps = out[name]
    print(f'  the port\'s linesearch from the {name} search: alpha '
          f'{alpha:.17g}')
    for i, (la, ls, ha, hs, swapped, done) in enumerate(steps):
      print(f'    step {i}: lo alpha {la:.17g} slope {ls:.6g}, hi alpha '
            f'{ha:.17g} slope {hs:.6g}, swapped {swapped}, done {done}')
      if done:
        break


if __name__ == '__main__':
  main()
