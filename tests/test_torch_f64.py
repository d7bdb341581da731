"""The port's float64 path against MuJoCo C: the port's own form of the
JAX per-step exactness check (``tests/test_error_growth.py:57``, which
reads a humanoid from the upstream project's checkout and is red where
that is absent).

The scene is the dm_control humanoid that ``io.load_dmc`` reads (its
sensors, cameras and lights; every candidate in its own slot), qvel
0.05 N from seed 7 and ``mj_forward``, then ``put_data`` into a float64
Model and port steps (the general step through the plain versions of
the kernels, on the CPU) against ``mujoco.mj_step``.  The bars are the
JAX test's: qpos within 1e-12 after 1 step, 1e-10 after 100 and 1e-5
after 200 (chaos sets in there).  Measured on this tree: 1.2e-18,
6.1e-15 and 4.4e-14.

Also: put_data copies the host buffers; a float64 Model holds every float
field in float64 and keeps MuJoCo's tolerance, which a float32 Model
floors at 1e-6; the fused gate refuses a float64 Model."""

import functools

import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import fused, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.torch_threads import few_threads  # noqa: F401

pytest.importorskip('dm_control')


def humanoid():
  mjm = tio.load_dmc('humanoid_dmc')
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(7)
  mjd.qvel[:] = 0.05 * rng.standard_normal(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  return mjm, mjd


@functools.lru_cache(maxsize=None)
def trajectory():
  """qpos error against MuJoCo C after steps 1, 100 and 200."""
  mjm, mjd = humanoid()
  m = tio.put_model(mjm, device='cpu', dtype=torch.float64)
  d = tio.put_data(mjm, mjd, m)
  err = {}
  for k in range(1, 201):
    mujoco.mj_step(mjm, mjd)
    d = forward.step(m, d)
    if k in (1, 100, 200):
      err[k] = float(np.abs(d.qpos[0].numpy() - mjd.qpos).max())
  return err


def test_f64_is_per_step_exact():
  err = trajectory()
  assert err[1] < 1e-12, err
  assert err[100] < 1e-10, err
  assert err[200] < 1e-5, err


def test_put_data_does_not_alias_host_buffers():
  """Mutating the MjData after put_data leaves the port's Data as it
  was (``tests/test_error_growth.py:80``)."""
  mjm, mjd = humanoid()
  m = tio.put_model(mjm, device='cpu', dtype=torch.float64)
  d = tio.put_data(mjm, mjd, m)
  before = {k: getattr(d, k).clone() for k in tio.PUT_FIELDS}
  mjd.qvel[:] = 123.0
  mjd.qpos[:] = -7.0
  mujoco.mj_step(mjm, mjd)
  for k, v in before.items():
    assert torch.equal(getattr(d, k), v), k


def test_float64_model_and_data():
  mjm, _ = humanoid()
  m64 = tio.put_model(mjm, device='cpu', dtype=torch.float64)
  m32 = tio.put_model(mjm, device='cpu')
  for k, v in tio.model_to_numpy(m64).items():
    if isinstance(v, np.ndarray) and v.dtype.kind == 'f':
      assert v.dtype == np.float64, k
  assert types.dtype_of(m64) == torch.float64
  assert float(m64.opt.tolerance) == mjm.opt.tolerance == 1e-8
  assert float(m32.opt.tolerance) == pytest.approx(1e-6)
  d = tio.make_data(m64, 3, device='cpu')
  assert d.qpos.dtype == d.qvel.dtype == torch.float64
  assert tio.make_data(m64, 3, device='cpu',
                       dtype=torch.float32).qpos.dtype == torch.float32
  # the float64 tables equal the float32 ones where float32 holds them
  for k in ('cand_friction', 'cand_solref', 'geom_solmix', 'body_mass'):
    np.testing.assert_array_equal(
        getattr(m64, k).float().numpy(), getattr(m32, k).numpy(), err_msg=k)
  assert 'float64' in fused.reason(m64)
  assert fused.reason(m32) is None and forward.unsupported(m64) is None
