"""Live contacts per world, Newton mean and trunk height, step by step,
of dm_control's quadruped and of ``quadruped_dr`` (its per-world draws,
``benchmarks.randomize_quadruped``), and of quadruped_dr with its hinge
springs at 0, each from ``parity.dmc_state`` through
``benchmarks.rollout`` on the CPU in float32:

  python tests/measure_dr_contacts.py [--nworld 128] [--nstep 30]
                                      [--every 5]

Prints one line per scene: (step, live contacts per world, Newton mean,
trunk height in m) every ``--every`` steps.  It shows whether the draws
keep the quadruped's feet on the floor, step for step against the
unrandomized scene."""

import argparse
import os
import sys

import torch

# the checkout's package, ahead of any installed one
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mujoco_warp_tpu_torch import benchmarks, io, parity, types


def trace(m, nworld, nstep, every, init):
  gen = benchmarks.rollout(m, nworld, 0, 'cpu', init_state=init)
  out = []
  for i in range(1, nstep + 1):
    st = next(gen)
    if i % every == 0:
      out.append((i, round(float(st.ncon_active.float().mean()), 3),
                  round(float(st.solver_niter.float().mean()), 3),
                  round(float(st.qpos[:, parity.DMC_ROOT['quadruped']]
                              .mean()), 4)))
  return out


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--nworld', type=int, default=128)
  ap.add_argument('--nstep', type=int, default=30)
  ap.add_argument('--every', type=int, default=5)
  a = ap.parse_args()
  torch.set_num_threads(4)
  m0 = io.load_model_npz(io.ACT_SNAPSHOTS['quadruped'], device='cpu')
  qpos, qvel, _ = parity.dmc_state(m0, 'quadruped', 64, 0)
  init = {'qpos': qpos, 'qvel': qvel}
  mdr = benchmarks.randomize_quadruped(m0, a.nworld)
  still = types.set_model_fields(mdr, {'jnt_stiffness': torch.zeros_like(
      types.get_model_field(mdr, 'jnt_stiffness'))})
  for name, m in (('quadruped', m0), ('quadruped_dr', mdr),
                  ('quadruped_dr, springs 0', still)):
    print(name, trace(m, a.nworld, a.nstep, a.every, init), flush=True)


if __name__ == '__main__':
  main()
