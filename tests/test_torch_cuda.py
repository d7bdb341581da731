"""The port's CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one.  They import no
JAX, so they also run where only PyTorch is installed::

  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are those of ``mujoco_warp_tpu_torch.parity``, which
chip_smoke.py applies too.
"""

import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import fused, io, parity
from mujoco_warp_tpu_torch.fused import glue, k1_ref, k4_ref
from mujoco_warp_tpu_torch.kernels import k1 as kk1
from mujoco_warp_tpu_torch.kernels import k4 as kk4


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')


def state(m, W, seed, drop, device):
  return [torch.as_tensor(x, device=device)
          for x in parity.lane_state(m, W, seed, drop)]


@pytest.mark.cuda
@pytest.mark.parametrize('drop', [0.0, 0.28])
def test_k1_cuda_matches_plain(cuda, drop):
  m = io.load_model_npz()
  qpos, qvel, _, _ = state(m, 1000, 2, drop, cuda)  # W not a multiple of 128
  n = kk1.launches
  got = kk1.k1(m, qpos, qvel, need_qLD=True)
  assert kk1.launches == n + 1
  want = k1_ref.k1(m, qpos, qvel, need_qLD=True)
  assert all(a.device.type == 'cuda' for a in got)
  parity.check_k1(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('drop', [0.0, 0.28])
def test_k4_cuda_matches_plain(cuda, drop):
  m = io.load_model_npz()
  qpos, qvel, ctrl, ws = state(m, 1000, 5, drop, cuda)
  qM, _, bias, cdof, dist, cpos, cframe, stcom = k1_ref.k1(
      m, qpos, qvel, need_qLD=False)
  con, _ = glue.compact(m, dist, cpos, cframe, stcom)
  qfs = glue.middle(m, bias, qpos, qvel, ctrl)
  args = (m, qM, None, qfs, ws, qvel, qpos, cdof, con)
  n = kk4.launches
  got = kk4.k4(*args)
  assert kk4.launches == n + 1
  want = k4_ref.k4(*args)
  kind = 'rest' if drop == 0.0 else 'contact'
  parity.check_k4(got, want, qvel, float(k4_ref.scalars(m)[3]), kind)


@pytest.mark.cuda
def test_step_lane_cuda_matches_cpu(cuda):
  """Three fused steps through the kernels against the plain path."""
  m = io.load_model_npz()
  d = io.make_data(m, 256)
  rng = np.random.default_rng(9)
  d = d.replace(qpos=d.qpos + torch.as_tensor(
      0.01 * rng.standard_normal(d.qpos.shape), dtype=torch.float32))
  st_h = fused.to_lane(m, d)
  st_c = st_h.map(lambda x: x.to(cuda))
  for _ in range(3):
    st_h = fused.step_lane(m, st_h)
    st_c = fused.step_lane(m, st_c)
  np.testing.assert_allclose(st_c.qpos.cpu().numpy(), st_h.qpos.numpy(),
                             atol=2e-4, rtol=1e-3)
  np.testing.assert_allclose(st_c.qvel.cpu().numpy(), st_h.qvel.numpy(),
                             atol=5e-3, rtol=5e-3)
