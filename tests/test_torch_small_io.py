"""The committed snapshots of the fused step's small gated scenes,
``assets/eq_joint.npz`` (JOINT equality rows) and
``assets/implicitfast.npz`` (the implicitfast integrator), which the card
tests and chip_smoke.py load where ``mujoco`` is absent: each equals
``io.put_model`` of its scene in tests/test_fused.py, and the snapshot
writer reads the committed XML of the same scene."""

import mujoco
import pytest

from mujoco_warp_tpu_torch import io
from tests.test_fused import _EQJOINT, _IMPLICITFAST
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

SCENES = {'eq_joint': (_EQJOINT, io.EQ_JOINT_XML, io.EQ_JOINT_SNAPSHOT),
          'implicitfast': (_IMPLICITFAST, io.IMPLICITFAST_XML,
                           io.IMPLICITFAST_SNAPSHOT)}


@pytest.mark.parametrize('scene', sorted(SCENES))
def test_small_snapshot_matches_put_model(scene, tmp_path):
  xml, xml_path, snapshot = SCENES[scene]
  fresh = io.put_model(mujoco.MjModel.from_xml_string(xml), device='cpu')
  assert_models_equal(io.load_model_npz(snapshot, device='cpu'), fresh)
  written = io.make_xml_snapshot(xml_path, str(tmp_path / f'{scene}.npz'))
  assert_models_equal(written, fresh)
