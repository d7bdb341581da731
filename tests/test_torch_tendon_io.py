"""Port io on the tendon scenes: dm_control's ball_in_cup and point_mass,
``mujoco_warp_tpu/models/sensors2.xml`` and the port's
``assets/tendon_wrap.xml`` and ``assets/tendon_mix.xml``.  Every field of
the port's Model (the tendon and wrap tables among them) equals the JAX
``put_model``'s; every committed snapshot, the earlier scenes' included,
is what ``--snapshot`` writes today; the general step takes the five
scenes and the fused gate refuses them, as the JAX gate does."""

import os

import mujoco
import numpy as np
import pytest

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.pallas import fused as jfused
from mujoco_warp_tpu_torch import benchmarks, fused
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import types as ttypes
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_io import assert_models_equal, jax_model_numpy
from tests.torch_threads import few_threads  # noqa: F401

SCENES = tio.TENDON_DMC + tuple(tio.TENDON_XML)
# (nv, ntendon, nefc, contact slots, nu, nsensor) of each scene
SIZES = {'ball_in_cup': (4, 1, 65, 16, 2, 0),
         'point_mass': (2, 2, 26, 6, 2, 0),
         'sensors2': (2, 1, 0, 0, 3, 9),
         'tendon_wrap': (2, 2, 0, 0, 1, 0),
         'tendon_mix': (5, 7, 4, 0, 3, 9)}
_TENDON_FIELDS = [n for n in ttypes.field_kinds(ttypes.Model)
                  if n.startswith(('tendon_', 'wrap_'))]


def load(scene):
  """The scene's MjModel (dm_control's needs ``dm_control``)."""
  if scene in tio.TENDON_DMC:
    pytest.importorskip('dm_control')
    return tio.load_dmc(scene)
  return mujoco.MjModel.from_xml_path(tio.TENDON_XML[scene])


@pytest.mark.parametrize('scene', SCENES)
def test_tendon_model_matches_jax(scene):
  """Every field of the port's Model equals the JAX Model's, float32
  arrays bit for bit; the tendon and wrap tables are there and non-empty;
  the general step takes the model, the fused gate refuses it as the JAX
  gate does."""
  mjm = load(scene)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  ref = jax_model_numpy(mj)
  for k, v in tio.model_to_numpy(m).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
    elif k not in ('tree.body_levels', 'con_classes', 'pair_groups'):
      assert v == ref[k], k
  assert len(_TENDON_FIELDS) == 21
  for k in _TENDON_FIELDS:
    assert ttypes.host(getattr(m, k)).shape[0] == (
        m.ntendon if k.startswith('tendon_') else len(m.wrap_type)) > 0, k
  assert (m.nv, m.ntendon, m.nefc, m.ncon, m.nu, m.nsensor) == SIZES[scene]
  assert forward.unsupported(m) is None
  assert fused.reason(m) is not None and not fused.supported(m)
  assert not jfused.supported_features(mj)


@pytest.mark.parametrize('path,make', tio.snapshot_makers(),
                         ids=[p.split('/')[-1] for p, _ in
                              tio.snapshot_makers()])
def test_every_snapshot_matches_fresh_put_model(path, make, tmp_path):
  """Each committed snapshot, the earlier scenes' among them, is what
  ``--snapshot`` writes today (a new Model field means regenerating them
  all), and loads with every field of the Model."""
  if any(n in path for n in tio.DMC_NCONMAX) or any(
      n in path for n in tio.TENDON_DMC):
    pytest.importorskip('dm_control')
  fresh = make(str(tmp_path / 'fresh.npz'))
  assert_models_equal(tio.load_model_npz(path, device='cpu'), fresh)
  assert_models_equal(tio.load_model_npz(str(tmp_path / 'fresh.npz'),
                                         device='cpu'), fresh)


@pytest.mark.parametrize('scene', SCENES)
def test_tendon_scenes_are_registered(scene):
  """benchmarks.SCENES runs each tendon scene at 8192 worlds from its
  snapshot, on the general step."""
  m, nworld = benchmarks.load_scene(scene, device='cpu')
  assert nworld == 8192 and benchmarks.SCENES[scene][0] == \
      tio.TENDON_SNAPSHOTS[scene]
  assert_models_equal(m, tio.put_model(load(scene), device='cpu'))
  assert not fused.supported(m) and forward.unsupported(m) is None


_JOINTINPARENT = """
<mujoco>
  <worldbody>
    <body pos="0 0 1">
      <joint name="b" type="ball"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
    </body>
  </worldbody>
  <actuator><general jointinparent="b" gear="1 0 0"/></actuator>
</mujoco>"""


def test_gate_still_refuses_other_transmissions():
  """The general step takes tendon transmissions and tendon equality,
  and since the actuation slice the slider-crank, site and body
  transmissions (transmission.xml); it still refuses the joint-in-parent
  transmission."""
  mjm = mujoco.MjModel.from_xml_path(os.path.join(tio._MODELS,
                                                  'transmission.xml'))
  assert forward.unsupported(tio.put_model(mjm, device='cpu')) is None
  mjm = mujoco.MjModel.from_xml_string(_JOINTINPARENT)
  with pytest.raises(NotImplementedError, match='joint in parent'):
    tio.put_model(mjm, device='cpu')
