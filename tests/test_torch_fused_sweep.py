"""The port's fused step against its own general step on the box scene
of ``tests/test_fused.py`` (box, sphere and capsule on a plane, condim
3/4/6 rows), fresh seeded states for seeds 11 and 23: the twin of the JAX
``test_fused_differential_sweep`` (``tests/test_fused.py:253``), 3 steps
at 128 worlds, at its bars (qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3
rtol 5e-3).  Both sides run their plain versions on the CPU.
"""

import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import fused
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_fused import _BOX46
from tests.torch_threads import few_threads  # noqa: F401

W = 128


@pytest.mark.parametrize('seed', [11, 23])
def test_fused_matches_general_on_box46(seed):
  m = tio.put_model(mujoco.MjModel.from_xml_string(_BOX46), device='cpu')
  assert fused.supported(m) and forward.unsupported(m) is None
  rng = np.random.default_rng(seed)
  d = tio.make_data(m, W, device='cpu')
  d = d.replace(
      qpos=d.qpos + 0.01 * torch.as_tensor(
          rng.standard_normal(tuple(d.qpos.shape)).astype(np.float32)),
      qvel=0.2 * torch.as_tensor(
          rng.standard_normal(tuple(d.qvel.shape)).astype(np.float32)))
  ref = d
  for _ in range(3):
    ref = forward.step(m, ref)
  st = fused.to_lane(m, d)
  for _ in range(3):
    st = fused.step_lane(m, st)
  assert_close(st.qpos.T.numpy(), ref.qpos.numpy(), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(st.qvel.T.numpy(), ref.qvel.numpy(), 'qvel', atol=5e-3,
               rtol=5e-3)
  assert int(ref.ncon_active.sum()) > 0
