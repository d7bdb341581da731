"""The cylinder and ellipsoid colliders of the general step against the
JAX package: each pair group of a zoo scene (free bodies in touching
pairs on and above a plane) against JAX
``collision_driver._narrowphase_candidates`` under ``vmap``, at 64 worlds
of seeded poses, after the same position stages.

Every new group is live in nearly every world: plane-ellipsoid,
plane-cylinder (three rim points), sphere-cylinder (a sphere against a
cap and one against a side wall from outside, a small sphere inside a
cylinder), and by MPR sphere-ellipsoid, capsule-ellipsoid,
capsule-cylinder, ellipsoid-ellipsoid, ellipsoid-cylinder,
cylinder-cylinder and box-cylinder (the 4-point manifold of two flat
types).

In float64, on the same geom poses, every MPR group's dist, pos and frame
equal JAX's within 1e-9: the port's MPR is JAX's function.  In float32,
the production dtype: the same live slots; the primitive colliders' dist,
pos and frame within 1e-5 of JAX's (the bar of
``tests/test_torch_clutter_collision.py``); MPR's dist within 1e-5 (the
4-point manifold's, which reads the normal, within 2e-4) and its frame
within 2e-3.  MPR's normal is the argmin of the support distance over
directions, which between two curved surfaces is flat: float32 rounding
of ~1e-8 in that distance moves the argmin by ~sqrt(2e-8 / 0.05) = 6e-4
rad at these sizes, and the two sides' frames differ by up to 1.4e-3.
MPR's witness point is not held in float32: on a line contact (a capsule
lying on an ellipsoid or a cylinder) it sits at the capsule's end that
the normal's tilt picks, and the two sides pick different ends in some
worlds (0.16 apart).  A planted fault, the cylinder support's axial sign
flipped, fails the float32 bar."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import collision_convex as jcc
from mujoco_warp_tpu.ops import collision_driver as jcd
from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import types
from mujoco_warp_tpu_torch.ops import collision_convex, collision_driver, \
    collision_primitive, forward
from tests.torch_threads import few_threads  # noqa: F401

W = 64
# bodies in touching pairs, each pair 0.6 m from the next along x; a 5 mm
# overlap where two geoms meet
ZOO = """
<mujoco>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.045"><freejoint/>
      <geom type="ellipsoid" size="0.1 0.06 0.05"/></body>
    <body pos="0 0 0.14"><freejoint/>
      <geom type="sphere" size="0.05"/></body>
    <body pos="0.6 0 0.045"><freejoint/>
      <geom type="cylinder" size="0.06 0.05"/></body>
    <body pos="0.6 0 0.13"><freejoint/>
      <geom type="sphere" size="0.04"/></body>
    <body pos="1.2 0 0.3"><freejoint/>
      <geom type="cylinder" size="0.1 0.08"/></body>
    <body pos="1.2 0.09 0.3"><freejoint/>
      <geom type="sphere" size="0.02"/></body>
    <body pos="1.2 -0.125 0.3"><freejoint/>
      <geom type="sphere" size="0.03"/></body>
    <body pos="1.8 0 0.045"><freejoint/>
      <geom type="cylinder" size="0.06 0.05"/></body>
    <body pos="1.8 0.02 0.13"><freejoint/>
      <geom type="cylinder" size="0.05 0.04"/></body>
    <body pos="2.4 0 0.045"><freejoint/>
      <geom type="ellipsoid" size="0.08 0.05 0.05"/></body>
    <body pos="2.4 0 0.12" euler="0 90 0"><freejoint/>
      <geom type="capsule" size="0.03 0.08"/></body>
    <body pos="2.4 0.095 0.045"><freejoint/>
      <geom type="ellipsoid" size="0.05 0.05 0.04"/></body>
    <body pos="3.0 0 0.3"><freejoint/>
      <geom type="cylinder" size="0.05 0.06"/></body>
    <body pos="3.0 0 0.385" euler="0 90 0"><freejoint/>
      <geom type="capsule" size="0.03 0.06"/></body>
    <body pos="3.0 0.085 0.3"><freejoint/>
      <geom type="ellipsoid" size="0.04 0.04 0.06"/></body>
    <body pos="3.6 0 0.3"><freejoint/>
      <geom type="box" size="0.06 0.06 0.03"/></body>
    <body pos="3.6 0 0.355"><freejoint/>
      <geom type="cylinder" size="0.04 0.03"/></body>
  </worldbody>
</mujoco>"""
_GT = types.GeomType
_NAME = {0: 'plane', 2: 'sphere', 3: 'capsule', 4: 'ellipsoid',
         5: 'cylinder', 6: 'box'}
# the new groups, each live in nearly every world
NEW = ['plane-ellipsoid', 'plane-cylinder', 'sphere-ellipsoid',
       'sphere-cylinder', 'capsule-ellipsoid', 'capsule-cylinder',
       'ellipsoid-ellipsoid', 'ellipsoid-cylinder', 'cylinder-cylinder',
       'cylinder-box']


def poses(m, seed):
  """qpos0 with each free body moved by 1 mm N and turned by 0.03 N rad
  about each axis (quaternions renormalised)."""
  rng = np.random.default_rng(seed)
  qpos = np.broadcast_to(types.host(m.qpos0, np.float32), (W, m.nq)).copy()
  for j in range(m.njnt):
    a = int(m.jnt_qposadr[j])
    qpos[:, a:a + 3] += 0.001 * rng.standard_normal((W, 3))
    q = qpos[:, a + 3:a + 7] + 0.015 * rng.standard_normal((W, 4))
    qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
  return qpos.astype(np.float32)


@functools.lru_cache(maxsize=None)
def models():
  mjm = mujoco.MjModel.from_xml_string(ZOO)
  return jio.put_model(mjm), tio.put_model(mjm, device='cpu')


def port_candidates(m, qpos):
  d = tio.make_data(m, W, device='cpu').replace(qpos=torch.as_tensor(qpos))
  got = collision_driver._narrowphase_candidates(m, forward.pre(m, d))
  return [a.numpy() for a in got]


@functools.lru_cache(maxsize=None)
def candidates():
  """(qpos, port candidates, JAX candidates, JAX geom poses)."""
  mj, m = models()
  qpos = poses(m, 1)
  dj = jio.make_data(mj, nworld=W).replace(qpos=jnp.asarray(qpos))

  def one(x):
    x = jsmooth.com_pos(mj, jsmooth.kinematics(mj, x))
    return jcd._narrowphase_candidates(mj, x), (x.geom_xpos, x.geom_xmat)
  want, pose = jax.jit(jax.vmap(one))(dj)
  return qpos, port_candidates(m, qpos), [np.asarray(a) for a in want], \
      [np.asarray(a, np.float64) for a in pose]


def group_slice(m, group):
  names = [f'{_NAME[g[0]]}-{_NAME[g[1]]}' for g in m.pair_groups]
  t1, t2, idx, slot = m.pair_groups[names.index(group)]
  return slice(slot, slot + collision_driver.group_ncon(t1, t2) * len(idx)), \
      (int(t1), int(t2))


def check_group(m, got, want, group):
  """The float32 bars of the module's docstring."""
  s, key = group_slice(m, group)
  im = m.cand_includemargin.numpy()[s]
  np.testing.assert_array_equal(got[0][:, s] < im, want[0][:, s] < im,
                                err_msg=f'{group} live slots')
  if key in collision_primitive.COLLIDERS:
    atol = {'dist': 1e-5, 'pos': 1e-5, 'frame': 1e-5}
  else:
    atol = {'dist': 1e-5 if collision_convex.convex_ncon(*key) == 1
            else 2e-4, 'frame': 2e-3}
  hit = want[0][:, s] < 1.0
  for name, a, b in zip(('dist', 'pos', 'frame'), got, want):
    if name in atol:
      np.testing.assert_allclose(a[:, s][hit], b[:, s][hit],
                                 atol=atol[name], rtol=0.0,
                                 err_msg=f'{group} {name}')


def test_the_zoo_has_every_new_group():
  _, m = models()
  names = [f'{_NAME[g[0]]}-{_NAME[g[1]]}' for g in m.pair_groups]
  assert set(NEW) <= set(names)
  s, _ = group_slice(m, 'plane-cylinder')
  assert collision_driver.group_ncon(_GT.PLANE, _GT.CYLINDER) == 3
  assert collision_driver.group_ncon(_GT.CYLINDER, _GT.CYLINDER) == 4
  assert collision_driver.group_ncon(_GT.SPHERE, _GT.ELLIPSOID) == 1


@pytest.mark.parametrize('group', NEW)
def test_new_group_matches_jax(group):
  _, m = models()
  _, got, want, _ = candidates()
  s, _ = group_slice(m, group)
  im = m.cand_includemargin.numpy()[s]
  assert (want[0][:, s] < im).any(axis=1).mean() > 0.9, 'group not live'
  check_group(m, got, want, group)


MPR = [g for g in NEW if g not in ('plane-ellipsoid', 'plane-cylinder',
                                   'sphere-cylinder')]


@pytest.mark.parametrize('group', MPR)
def test_mpr_group_matches_jax_in_float64(group):
  """The MPR group on the JAX side's float32 geom poses, both sides in
  float64: dist, pos and frame within 1e-9."""
  mj, m = models()
  _, _, _, (xpos, xmat) = candidates()
  s, (t1, t2) = group_slice(m, group)
  idx = [g[2] for g in m.pair_groups if (int(g[0]), int(g[1])) == (t1, t2)]
  g1, g2 = m.pair_geom1[idx[0]], m.pair_geom2[idx[0]]
  k = collision_convex.convex_ncon(t1, t2)
  size, margin = types.host(m.geom_size), types.host(m.geom_margin)
  with jax.enable_x64(True):
    jm = SimpleNamespace(geom_size=jnp.asarray(size),
                         geom_margin=jnp.asarray(margin))
    want = jax.jit(jax.vmap(lambda p, r: jcc._collide(
        jm, SimpleNamespace(geom_xpos=p, geom_xmat=r), t1, t2, k, g1, g2,
        None, None)))(jnp.asarray(xpos), jnp.asarray(xmat))
    want = [np.asarray(a) for a in want]
  t = torch.as_tensor
  got = collision_convex._collide(
      SimpleNamespace(geom_size=t(size), geom_margin=t(margin)),
      SimpleNamespace(geom_xpos=t(xpos), geom_xmat=t(xmat)), t1, t2, k, g1,
      g2)
  hit = want[0] < 1.0
  assert hit.any() and got[0].dtype == torch.float64
  np.testing.assert_array_equal(got[0].numpy() < 1.0, hit)
  for name, a, b in zip(('dist', 'pos', 'normal'), got, want):
    np.testing.assert_allclose(a.numpy()[hit], b[hit], atol=1e-9, rtol=0.0,
                               err_msg=f'{group} {name}')


def test_sphere_cylinder_inside_outside_and_side():
  """The three spheres of the sphere-cylinder group: against the cap from
  outside, inside the large cylinder near its side wall (center 1 cm in,
  radius 2 cm), and against the side wall from outside; each live in
  every world."""
  _, m = models()
  qpos, got, _, _ = candidates()
  s, _ = group_slice(m, 'sphere-cylinder')
  g1 = m.pair_geom1[m.con_pair[s]]
  g2 = m.pair_geom2[m.con_pair[s]]
  size = types.host(m.geom_size)
  live = got[0][:, s] < m.cand_includemargin.numpy()[s]
  # the inside sphere (r 0.02) against the large cylinder (r 0.1)
  inside = [i for i in range(len(g1)) if size[g1[i], 0] == np.float32(0.02)
            and size[g2[i], 0] == np.float32(0.1)]
  assert len(inside) == 1 and live[:, inside[0]].all()
  assert live.sum(1).min() >= 3
  # JAX's inside case (``collision_primitive.py:221-233``), which the port
  # mirrors: the distance to the nearest face less the radius, -0.01 at
  # qpos0 (MuJoCo C gives -(0.01 + 0.02)); the poses move it by a few mm
  dist = got[0][:, s][:, inside[0]]
  assert (dist > -0.02).all() and (dist < 0.0).all()


def test_planted_cylinder_support_fault_fails_the_bar(monkeypatch):
  """The cylinder support with its axial sign flipped moves the
  cylinder-cylinder group past the MPR bar."""
  good = collision_convex._support_local

  def flipped(gtype, size, d):
    out = good(gtype, size, d)
    if gtype == _GT.CYLINDER:
      out = out * torch.tensor([1.0, 1.0, -1.0])
    return out
  monkeypatch.setattr(collision_convex, '_support_local', flipped)
  _, m = models()
  qpos, _, want, _ = candidates()
  got = port_candidates(m, qpos)
  with pytest.raises(AssertionError, match='cylinder-cylinder'):
    check_group(m, got, want, 'cylinder-cylinder')
