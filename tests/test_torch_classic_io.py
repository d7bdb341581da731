"""Port io on dm_control's classic tasks (pendulum, reacher, finger,
cartpole, acrobot, humanoid_CMU) and the contact budget of ``put_model``.

Every field of the port's Model equals the JAX ``put_model``'s, float32
arrays bit for bit: on humanoid_CMU (1157 candidate pairs, more than
``io.LOSSLESS_MAX_CAND``) that is the default budget, 48 slots compacted
(ncon, nefc, con_classes, con_compact and con_dim among the fields); a
small MJCF's ``<numeric name="nconmax">`` sets the budget as it does in
JAX, and an explicit argument wins over it.  Each committed snapshot of
the six equals ``put_model`` of the installed XML (the regeneration of
every snapshot is ``tests/test_torch_tendon_io.py``'s), the general step
takes each and the fused gate refuses it, as the JAX gate does."""

import mujoco
import numpy as np
import pytest

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.pallas import fused as jfused
from mujoco_warp_tpu_torch import fused
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_io import assert_models_equal, jax_model_numpy
from tests.torch_threads import few_threads  # noqa: F401

# (nv, ncand, ncon, nefc, integrator) of each scene
SIZES = {'pendulum': (1, 6, 6, 24, 0), 'reacher': (2, 31, 31, 125, 0),
         'finger': (3, 26, 26, 81, 0), 'cartpole': (2, 12, 12, 49, 1),
         'acrobot': (2, 7, 7, 28, 1), 'humanoid_CMU': (62, 1157, 48, 248, 0)}

BUDGET_XML = """
<mujoco>
  <custom><numeric name="nconmax" data="{n}"/></custom>
  <worldbody>
    <geom type="plane" size="2 2 0.1"/>
    {bodies}
  </worldbody>
</mujoco>"""


def assert_matches_jax(mj, m):
  ref = jax_model_numpy(mj)
  for k, v in tio.model_to_numpy(m).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
    elif k in ('con_classes', 'pair_groups'):
      assert len(v) == len(ref[k]), k
      for a, b in zip(v, ref[k]):
        assert (a[0], a[1], a[3]) == (b[0], b[1], b[3]), k
        np.testing.assert_array_equal(a[2], b[2], err_msg=k)
    elif k != 'tree.body_levels':
      assert v == ref[k], k


@pytest.mark.parametrize('scene', tio.CLASSIC_DMC)
def test_classic_model_matches_jax(scene):
  pytest.importorskip('dm_control')
  mjm = tio.load_dmc(scene)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  assert_matches_jax(mj, m)
  assert (m.nv, m.ncand, m.ncon, m.nefc, m.opt.integrator) == SIZES[scene]
  assert forward.unsupported(m) is None
  assert fused.reason(m) is not None and not fused.supported(m)
  assert not jfused.supported_features(mj)
  assert_models_equal(tio.load_model_npz(tio.CLASSIC_SNAPSHOTS[scene],
                                         device='cpu'), m)


def test_humanoid_cmu_takes_the_default_budget():
  pytest.importorskip('dm_control')
  mjm = tio.load_dmc('humanoid_CMU')
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  assert m.ncand > tio.LOSSLESS_MAX_CAND
  assert tio._default_nconmax(mjm) == 48 == m.ncon == mj.ncon
  assert m.con_compact and mj.con_compact and m.nefc == mj.nefc == 248
  np.testing.assert_array_equal(m.con_dim, np.asarray(mj.con_dim))
  assert [(c[0], c[1], c[3]) for c in m.con_classes] == \
      [(c[0], c[1], c[3]) for c in mj.con_classes]
  # an explicit budget wins
  m2 = tio.put_model(mjm, nconmax={3: 64}, device='cpu')
  assert m2.ncon == 64 == jio.put_model(mjm, nconmax={3: 64}).ncon


@pytest.mark.parametrize('n', [3, 40])
def test_numeric_nconmax_sets_the_budget(n):
  """Ten spheres over a plane: 55 candidates of condim 3.  The numeric
  budget compacts them into n slots (40 of them too: any budget below
  the candidates compacts), as in JAX; an explicit argument wins."""
  bodies = ''.join(
      f'<body pos="{0.1 * i} 0 0.1"><freejoint/>'
      f'<geom type="sphere" size="0.05"/></body>' for i in range(10))
  mjm = mujoco.MjModel.from_xml_string(BUDGET_XML.format(n=n, bodies=bodies))
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  assert_matches_jax(mj, m)
  assert m.ncand == 55 and m.ncon == n and m.con_compact
  m2 = tio.put_model(mjm, nconmax=5, device='cpu')
  assert m2.ncon == 5 == jio.put_model(mjm, nconmax=5).ncon
