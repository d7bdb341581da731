"""Port io against the JAX package: Model fields, snapshot, import hygiene.

The port's Model (mujoco_warp_tpu_torch.types.Model) is the fused-gate
subset of the JAX Model; every field must equal the JAX value exactly
(float32 arrays bit for bit, index tables and static tuples equal).
"""

import os
import subprocess
import sys

import jax
import mujoco
import numpy as np
import pytest

from mujoco_warp_tpu import benchmarks
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import types as ttypes
from tests.test_fused import _BOX46
from tests.torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_model_numpy(mj) -> dict:
  """The JAX Model's fields, by the port's field names, as numpy."""
  out = {}

  def put(obj, cls, prefix):
    for name, kind in ttypes.field_kinds(cls).items():
      val = getattr(obj, name)
      if kind == 'node':
        put(val, tio._NESTED[name], name + '.')
      elif kind in ('array', 'static'):
        out[prefix + name] = np.asarray(jax.device_get(val))
      else:
        out[prefix + name] = val
  put(mj, ttypes.Model, '')
  return out


def assert_models_equal(a: ttypes.Model, b: ttypes.Model):
  fa, fb = tio.model_to_numpy(a), tio.model_to_numpy(b)
  assert fa.keys() == fb.keys()
  for k in fa:
    x, y = fa[k], fb[k]
    if k in ('pair_groups', 'con_classes'):
      assert len(x) == len(y), k
      for gx, gy in zip(x, y):
        assert (gx[0], gx[1], gx[3]) == (gy[0], gy[1], gy[3]), k
        np.testing.assert_array_equal(gx[2], gy[2], err_msg=k)
    elif k == 'tree.body_levels':
      assert len(x) == len(y)
      for lx, ly in zip(x, y):
        np.testing.assert_array_equal(lx, ly)
    elif isinstance(x, np.ndarray):
      np.testing.assert_array_equal(x, np.asarray(y), err_msg=k)
    else:
      assert x == y, k


def _scene(name):
  if name == 'humanoid':
    return benchmarks.load_humanoid_benchmark(), tio.BENCH_NCONMAX
  return mujoco.MjModel.from_xml_string(_BOX46), None


def test_model_from_numpy_of_jax_fields():
  """The JAX put_model's fields, carried across as numpy, give the port's
  Model exactly."""
  mjm, nconmax = _scene('humanoid')
  mj = jio.put_model(mjm, nconmax=nconmax)
  assert_models_equal(tio.model_from_numpy(jax_model_numpy(mj), device='cpu'),
                      tio.put_model(mjm, nconmax=nconmax,
                                    device='cpu'))


@pytest.mark.parametrize('scene', ['humanoid', 'box46'])
def test_put_model_matches_jax(scene):
  mjm, nconmax = _scene(scene)
  mj = jio.put_model(mjm, nconmax=nconmax)
  m = tio.put_model(mjm, nconmax=nconmax, device='cpu')
  ref = jax_model_numpy(mj)
  got = tio.model_to_numpy(m)
  for k, v in got.items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
  assert (m.nefc, m.ncon, m.ncand) == (mj.nefc, mj.ncon, mj.ncand)


def test_snapshot_matches_fresh_put_model(tmp_path):
  """The committed snapshot is what ``--snapshot`` writes today."""
  path = str(tmp_path / 'humanoid_bench.npz')
  fresh = tio.make_snapshot(path)
  assert_models_equal(tio.load_model_npz(tio.SNAPSHOT, device='cpu'), fresh)
  assert_models_equal(tio.load_model_npz(path, device='cpu'), fresh)
  # the port's loader builds the scene the JAX benchmark loads
  assert_models_equal(tio.put_model(benchmarks.load_humanoid_benchmark(),
                                    nconmax=tio.BENCH_NCONMAX,
                                    device='cpu'), fresh)
  m = tio.load_model_npz(device='cpu')
  assert (m.nq, m.nv, m.nbody, m.ncand, m.ncon, m.nefc) == \
      (28, 27, 17, 177, 36, 129)


def test_make_data_at_qpos0():
  m = tio.load_model_npz(device='cpu')
  d = tio.make_data(m, nworld=3, device='cpu')
  assert d.qpos.shape == (3, m.nq) and d.qvel.shape == (3, m.nv)
  np.testing.assert_array_equal(d.qpos.numpy()[1], m.qpos0.numpy())
  assert d.solver_niter.dtype.is_floating_point is False


def test_import_does_not_load_jax():
  """The port imports torch and never jax (checked in a fresh process,
  since this test process has jax loaded)."""
  code = ('import sys, mujoco_warp_tpu_torch, mujoco_warp_tpu_torch.io, '
          'mujoco_warp_tpu_torch.fused, mujoco_warp_tpu_torch.kernels.k1, '
          'mujoco_warp_tpu_torch.kernels.k4, '
          'mujoco_warp_tpu_torch.benchmarks; '
          'bad = [k for k in sys.modules if k == "jax" or '
          'k.startswith(("jax.", "mujoco_warp_tpu.")) or '
          'k == "mujoco_warp_tpu"]; '
          'print(bad); sys.exit(1 if bad else 0)')
  res = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
  assert res.returncode == 0, res.stdout + res.stderr
