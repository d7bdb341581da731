"""The port's camera, light and site frames (``ops/smooth.py``
``camlight`` and the site frames of ``kinematics``) against the JAX
package's ``smooth.camlight`` and ``kinematics`` on the same seeded
states, to 1e-5: dm_control's humanoid (trackcom and fixed cameras, a
trackcom light, 25 sites) and hopper, and ``assets/camlight.xml``, which
has every mode (fixed, track, trackcom, targetbody, targetbodycom) for
cameras and lights."""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.ops import forward
from tests.torch_threads import few_threads  # noqa: F401

CAMLIGHT_XML = os.path.join(os.path.dirname(tio.__file__), 'assets',
                            'camlight.xml')
FIELDS = ('cam_xpos', 'cam_xmat', 'light_xpos', 'light_xdir', 'site_xpos',
          'site_xmat')


def _mjm(scene):
  if scene == 'camlight':
    return mujoco.MjModel.from_xml_path(CAMLIGHT_XML)
  pytest.importorskip('dm_control')
  return tio.load_dmc(scene)


@pytest.mark.parametrize('scene', ['camlight', 'humanoid_dmc', 'hopper'])
def test_camlight_and_site_frames_match_jax(scene):
  mjm = _mjm(scene)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, _, _ = parity.general_state(m, 32, 5)
  d = forward.pre(m, tio.make_data(m, 32, device='cpu').replace(
      qpos=torch.as_tensor(qpos)))

  def jpre(dd):
    dd = jsmooth.kinematics(mj, dd)
    return jsmooth.camlight(mj, jsmooth.com_pos(mj, dd))

  dj = jax.jit(jax.vmap(jpre))(jio.make_data(mj, nworld=32).replace(
      qpos=jnp.asarray(qpos)))
  seen = 0
  for k in FIELDS:
    want = np.asarray(getattr(dj, k))
    if want.shape[1] == 0:
      continue
    np.testing.assert_allclose(getattr(d, k).numpy(), want, atol=1e-5,
                               rtol=1e-5, err_msg=k)
    seen += 1
  assert seen == (6 if m.nsite else 4)
  if scene == 'camlight':
    assert set(m.cam_mode.tolist()) == set(m.light_mode.tolist()) == \
        {0, 1, 2, 3, 4}
