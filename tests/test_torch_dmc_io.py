"""Port io on dm_control's walker, cheetah, hopper and humanoid
(humanoid_dmc, at its {1: 16, 3: 32} contact budget), with their sensors,
cameras and lights: each Model against the JAX put_model, the committed
snapshots, and the fused gate against the JAX gate over every registry
scene this image can load."""

import os

import jax
import mujoco
import numpy as np
import pytest

pytest.importorskip('dm_control')

from benchmarks import BENCHMARKS  # noqa: E402
from mujoco_warp_tpu import io as jio  # noqa: E402
from mujoco_warp_tpu.pallas import fused as jfused  # noqa: E402
from mujoco_warp_tpu_torch import fused  # noqa: E402
from mujoco_warp_tpu_torch import io as tio  # noqa: E402
from mujoco_warp_tpu_torch.ops import forward  # noqa: E402
from tests.test_torch_io import assert_models_equal, jax_model_numpy  # noqa: E402
from tests.torch_threads import few_threads  # noqa: F401

SIZES = {'walker': (9, 14, 14, 62), 'cheetah': (9, 35, 35, 146),
         'hopper': (7, 21, 21, 88), 'humanoid_dmc': (27, 177, 48, 165)}


@pytest.mark.parametrize('scene', sorted(tio.DMC_NCONMAX))
def test_dmc_model_matches_jax(scene):
  """Every field of the port's Model equals the JAX Model's (the sensor,
  site, camera and light tables among them); both the fused gate and the
  general step take the model."""
  mjm = tio.load_dmc(scene)
  nconmax = tio.DMC_NCONMAX[scene]
  mj, m = jio.put_model(mjm, nconmax=nconmax), tio.put_model(
      mjm, nconmax=nconmax, device='cpu')
  ref = jax_model_numpy(mj)
  for k, v in tio.model_to_numpy(m).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
    elif k not in ('tree.body_levels', 'con_classes', 'pair_groups'):
      assert v == ref[k], k
  assert (m.nv, m.ncand, m.ncon, m.nefc) == SIZES[scene]
  assert m.nsensor and m.ncam and m.nlight
  assert fused.reason(m) is None and forward.unsupported(m) is None
  assert m.con_compact == (scene == 'humanoid_dmc')


@pytest.mark.parametrize('scene', sorted(tio.DMC_NCONMAX))
def test_dmc_snapshot_matches_fresh_put_model(scene, tmp_path):
  """The committed snapshot is what ``--snapshot`` writes today."""
  path = str(tmp_path / f'{scene}.npz')
  fresh = tio.make_dmc_snapshot(scene, path)
  assert_models_equal(tio.load_model_npz(tio.DMC_SNAPSHOTS[scene],
                                         device='cpu'), fresh)
  assert_models_equal(tio.load_model_npz(path, device='cpu'), fresh)


def _registry_model(name):
  """The registry scene's MjModel with its overrides set, or None where
  its XML is not in this image."""
  path, _, _, overrides, nconmax = BENCHMARKS[name]
  if not os.path.exists(path):
    return None, nconmax
  mjm = mujoco.MjModel.from_xml_path(path)
  for ov in overrides:
    key, val = ov.split('=')
    field = key.split('.')[1]
    if not val.isdigit():
      val = jio._ENUM_VALUES[field][val.lower()]
    setattr(mjm.opt, field, int(val))
  return mjm, nconmax


@pytest.mark.parametrize('name', sorted(BENCHMARKS))
def test_fused_gate_matches_jax(name):
  """``fused.reason`` is None exactly where the JAX
  ``supported_features`` is True.  Where the port's ``put_model`` raises
  (a model outside both of its paths), the JAX gate must refuse too."""
  mjm, nconmax = _registry_model(name)
  if mjm is None:
    pytest.skip(f'{name}: XML not in this image')
  want = bool(jfused.supported_features(jio.put_model(mjm,
                                                      nconmax=nconmax)))
  try:
    m = tio.put_model(mjm, nconmax=nconmax, device='cpu')
  except NotImplementedError:
    assert not want, name
    return
  assert (fused.reason(m) is None) == want, (name, fused.reason(m))
