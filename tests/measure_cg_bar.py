"""Measures parity's 'cg' bar: the port's CG solve against the JAX
package's on the same assembled systems, on the CPU.

  python -m tests.measure_cg_bar [--worlds 128] [--seeds 8]

For each seed of ``parity.spheres_state`` on ``spheres_cg``, the JAX
stages before the solve assemble the system, the JAX ``solver.solve``
(under ``vmap``) and the port's torch CG solve it, and one line prints
the share of worlds whose trip counts are equal, a histogram of the
differences, and for qacc, efc_force and qfrc_constraint how far past
the K4 bar they lie (<= 0: within it), also with the slack of
``parity.FORCE_THROUGH_QACC`` / ``QFRC_THROUGH_QACC``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu.ops import solver as jsolver
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.ops import solver as osolver

_FIELDS = ('efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qM', 'qLD',
           'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart', 'qpos')


def past(got, want, slack=0.0):
  """How far |got - want| lies past the K4 bar of each world's scale."""
  bar = parity.QACC_ATOL + parity.QACC_RTOL * np.abs(want).max(
      axis=1, keepdims=True)
  return float((np.abs(got - want) - bar - slack).max())


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--worlds', type=int, default=128)
  p.add_argument('--seeds', type=int, default=8)
  args = p.parse_args()
  jax.config.update('jax_platforms', 'cpu')
  mjm = tio.load_spheres()
  mjm.opt.solver = int(types.SolverType.CG)
  mj, m = jio.put_model(mjm, nconmax=None), tio.put_model(mjm, device='cpu')
  pre = jax.jit(jax.vmap(lambda x: jfwd.fwd_acceleration(mj, jfwd.fwd_actuation(
      mj, jfwd.fwd_velocity(mj, jfwd.fwd_position(mj, x))))))
  solve = jax.jit(jax.vmap(lambda x: jsolver.solve(mj, x)))
  W = args.worlds
  for seed in range(args.seeds):
    qpos, qvel, ctrl = parity.spheres_state(m, W, seed)
    db = pre(jio.make_data(mj, nworld=W).replace(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
        ctrl=jnp.asarray(ctrl)))
    ref = solve(db)
    d = types.Data(overflow=torch.zeros(W, dtype=torch.int32),
                   **{k: torch.as_tensor(np.array(getattr(db, k)))
                      for k in _FIELDS})
    out = osolver.solve(m, d)
    a, b = out.solver_niter.numpy(), np.asarray(ref.solver_niter)
    J, D = d.efc_J.numpy(), d.efc_D.numpy()
    dq = out.qacc.numpy() - np.asarray(ref.qacc)
    slack = D * np.abs(np.einsum('wrv,wv->wr', J, dq))
    row = {
        'qacc': past(out.qacc.numpy(), np.asarray(ref.qacc)),
        'efc_force': past(out.efc_force.numpy(), np.asarray(ref.efc_force)),
        'efc_force_slack': past(out.efc_force.numpy(),
                                np.asarray(ref.efc_force), slack),
        'qfrc': past(out.qfrc_constraint.numpy(),
                     np.asarray(ref.qfrc_constraint)),
        'qfrc_slack': past(out.qfrc_constraint.numpy(),
                           np.asarray(ref.qfrc_constraint),
                           np.einsum('wrv,wr->wv', np.abs(J), slack)),
    }
    print(f'seed {seed}: trips equal in {float((a == b).mean()):.4f}, '
          f'largest difference {int(np.abs(a - b).max())}, histogram '
          f'{np.bincount(np.abs(a - b)).tolist()}, mean {a.mean():.2f} / '
          f'{b.mean():.2f}; past the bar {row}', flush=True)


if __name__ == '__main__':
  main()
