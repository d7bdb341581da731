"""Tendon lengths and Jacobians (``ops/smooth.py`` ``tendon``) against the
JAX ``smooth.tendon`` after kinematics and com_pos, on the same seeded
poses: the five tendon scenes, ``BARE`` (tendon_wrap's XML with the
sphere's sidesite taken away and the elbow site moved off the cylinder,
so that the cylinder wraps) and ``MOVING_SIDE`` (its sidesite on
another body than its sphere: outside or inside it by the pose), 16 worlds of ``parity.general_state`` with
its qpos noise scaled to 1 rad.  ten_length and ten_J within atol 1e-5 +
rtol 1e-4 elementwise.  Between them the poses reach both branches
(wrapped and straight) of every wrap group: spheres and cylinders, with
and without a sidesite, the side fixed on the geom's body or moving; tendon_mix's string takes a pulley's divisor of
2.  The inside wrap (a sidesite inside the cylinder) is held on the
poses of JAX ``tests/test_tendon.py::test_wrap_inside``, against JAX and
MuJoCo C, as that test holds JAX.  A planted fault, a pulley divisor of
1, fails the bar.  One departure from JAX, MuJoCo C's semantics, is
held against MuJoCo C: a wrap geom after two sites keeps the first
site's segment (the JAX function drops it)."""

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
from mujoco_warp_tpu_torch.ops import smooth
from tests.oracle import assert_close
from tests.test_tendon import XML as WRAP_XML
from tests.torch_threads import few_threads  # noqa: F401

W = 16
ATOL, RTOL = 1e-5, 1e-4
BARE = WRAP_XML.replace(
    '<geom geom="pulley_sphere" sidesite="side"/>',
    '<geom geom="pulley_sphere"/>').replace(
        '<site name="elbow_site" pos="0.33 0 0.02"/>',
        '<site name="elbow_site" pos="0.25 0 0.06"/>')
# tendon_wrap's XML with the sphere's sidesite on the world body, so
# that it lies outside the sphere or inside it by the pose
MOVING_SIDE = WRAP_XML.replace(
    '<site name="side" pos="0.18 0 0.14"/>', '').replace(
        '<site name="origin" pos="0 0 1.2"/>',
        '<site name="origin" pos="0 0 1.2"/>'
        '<site name="side" pos="0.18 0 1.14"/>')
# the wrap groups (sphere?, sidesite kind) whose poses must wrap and run
# straight, per scene
BOTH = {'tendon_wrap': [(True, 'outside')],
        'tendon_mix': [(False, 'outside'), (True, 'outside')],
        'bare': [(False, 'none'), (True, 'none')],
        'moving_side': [(True, 'either')]}
INSIDE_XML = """
<mujoco>
  <worldbody>
    <site name="a" pos="-0.5 0 0.22"/>
    <body pos="0 0 0">
      <geom name="wrap" type="cylinder" size="0.2 0.3" euler="90 0 0"
            contype="0" conaffinity="0"/>
      <site name="inside" pos="0 0 0.1"/>
    </body>
    <body pos="0.5 0 0">
      <joint name="h" type="slide" axis="0 0 1" range="-0.5 0.5"/>
      <geom type="sphere" size="0.05" mass="1"/>
      <site name="b" pos="0 0 0.22"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t">
      <site site="a"/>
      <geom geom="wrap" sidesite="inside"/>
      <site site="b"/>
    </spatial>
  </tendon>
</mujoco>"""


def mjmodel(scene):
  if scene in ('bare', 'moving_side'):
    return mujoco.MjModel.from_xml_string(
        BARE if scene == 'bare' else MOVING_SIDE)
  if scene in tio.TENDON_DMC:
    pytest.importorskip('dm_control')
    return tio.load_dmc(scene)
  return mujoco.MjModel.from_xml_path(tio.TENDON_XML[scene])


def poses(m, seed=3, scale=10.0):
  """qpos (W, nq) of ``parity.general_state`` with its noise scaled."""
  qpos, _, _ = parity.general_state(m, W, seed)
  q0 = tio.types.host(m.qpos0, np.float32)
  return (q0 + scale * (qpos - q0)).astype(np.float32)


def both_sides(mj, m, qpos):
  """(port Data after ``smooth.tendon``, JAX ten_length, JAX ten_J)."""
  dj = jio.make_data(mj, nworld=qpos.shape[0]).replace(
      qpos=jnp.asarray(qpos))
  g = jax.jit(jax.vmap(lambda x: jsmooth.tendon(
      mj, jsmooth.com_pos(mj, jsmooth.kinematics(mj, x)))))(dj)
  d = tio.make_data(m, qpos.shape[0], device='cpu').replace(
      qpos=torch.as_tensor(qpos))
  d = smooth.tendon(m, smooth.com_pos(m, smooth.kinematics(m, d)))
  return d, np.asarray(g.ten_length), np.asarray(g.ten_J)


@pytest.mark.parametrize('scene', tio.TENDON_DMC + tuple(tio.TENDON_XML) +
                         ('bare', 'moving_side'))
def test_tendon_geometry_matches_jax(scene):
  mjm = mjmodel(scene)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos = poses(m)
  d, L, J = both_sides(mj, m, qpos)
  assert d.ten_length.shape == (W, m.ntendon)
  assert d.ten_J.shape == (W, m.ntendon, m.nv)
  assert_close(d.ten_length.numpy(), L, 'ten_length', ATOL, RTOL)
  assert_close(d.ten_J.numpy(), J, 'ten_J', ATOL, RTOL)
  wraps = smooth.tendon_wraps(m, d)
  for key in BOTH.get(scene, []):
    w = wraps[key]
    assert bool(w.any()) and not bool(w.all()), (key, float(w.mean()))
  if scene == 'tendon_mix':  # the string's second branch over its pulley
    plan = smooth._tendon_plan(m)['seg']
    assert sorted(set(plan['div'].tolist())) == [1.0, 2.0]


def test_planted_divisor_fault_fails_the_bar(monkeypatch):
  """A pulley divisor of 1 in the port's plan moves tendon_mix's string
  length past the bar: the bar can fail."""
  mjm = mjmodel('tendon_mix')
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  plan = smooth._tendon_plan(m)
  plan['seg']['div'] = np.ones_like(plan['seg']['div'])
  monkeypatch.setattr(smooth, '_PLANS', smooth.TableCache(
      lambda mm, dev: plan))
  d, L, J = both_sides(mj, m, poses(m))
  with pytest.raises(AssertionError, match='ten_length'):
    assert_close(d.ten_length.numpy(), L, 'ten_length', ATOL, RTOL)


def test_inside_wrap_matches_jax_and_mujoco():
  """The sidesite inside the cylinder: the tendon touches it from within
  (the inside Newton) or, where the straight path crosses it, runs
  straight; over the nine poses of the JAX test, port and JAX within the
  bar of each other and 1e-4 of MuJoCo C."""
  mjm = mujoco.MjModel.from_xml_string(INSIDE_XML)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos = np.linspace(-0.35, 0.35, 9, dtype=np.float32)[:, None]
  d, L, J = both_sides(mj, m, qpos)
  wraps = smooth.tendon_wraps(m, d)[(False, 'inside')]
  assert bool(wraps.any()) and not bool(wraps.all())  # both branches
  assert_close(d.ten_length.numpy(), L, 'ten_length', ATOL, RTOL)
  assert_close(d.ten_J.numpy(), J, 'ten_J', ATOL, RTOL)
  mjd = mujoco.MjData(mjm)
  for k, q in enumerate(qpos[:, 0]):
    mjd.qpos[0] = q
    mujoco.mj_forward(mjm, mjd)
    assert_close(d.ten_length[k].numpy(), mjd.ten_length, f'q={q}',
                 atol=1e-4, rtol=1e-4)


def test_sites_before_a_wrap_keep_their_segment():
  """A wrap geom after two sites: the port keeps the first site's segment,
  as MuJoCo C does; the JAX function drops it (its chain is reset at the
  wrap without a flush), 0.28 short here."""
  xml = INSIDE_XML.replace(
      '<site name="a" pos="-0.5 0 0.22"/>',
      '<site name="a0" pos="-0.5 0 0.5"/><site name="a" pos="-0.5 0 0.22"/>'
  ).replace('<geom geom="wrap" sidesite="inside"/>', '<geom geom="wrap"/>'
            ).replace('<site site="a"/>', '<site site="a0"/><site site="a"/>')
  mjm = mujoco.MjModel.from_xml_string(xml)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos = np.zeros((1, 1), np.float32)
  d, L, _ = both_sides(mj, m, qpos)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  assert_close(d.ten_length[0].numpy(), mjd.ten_length, 'ten_length',
               atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(mjd.ten_length - L[0], 0.28, atol=1e-5)
