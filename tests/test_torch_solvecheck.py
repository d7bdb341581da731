"""``mujoco_warp_tpu_torch/solvecheck.py`` at 16 worlds of tendon_mix on
the CPU, where the solve kernel's wrapper runs its plain version: the
check finds no world past the bar, keeps the nearest, and the float64
witness reads the file back."""

import numpy as np

from mujoco_warp_tpu_torch import solvecheck
from tests.torch_threads import few_threads  # noqa: F401


def test_solvecheck_keeps_the_nearest_worlds(tmp_path, capsys):
  out = str(tmp_path / 'check.npz')
  solvecheck.check('tendon_mix', steps=4, every=1, start=3, keep=2,
                   out=out, nworld=16, device='cpu')
  z = np.load(out)
  assert list(z['step']) == [3, 3, 4, 4]
  assert (z['past'] < 0).all() and np.array_equal(z['qacc_kernel'],
                                                   z['qacc_plain'])
  assert z['J'].shape[0] == 4 and z['niter_kernel'].min() >= 1
  solvecheck.witness(out)
  lines = capsys.readouterr().out.splitlines()
  assert sum('worlds past the qacc bar: none' in x for x in lines) == 2
  assert sum(' to the optimum: kernel ' in x for x in lines) == 4
