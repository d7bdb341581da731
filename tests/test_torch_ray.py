"""The port's ray casts against the JAX package and ``mujoco.mj_ray``.

- A scene of every primitive the port casts (a bounded and an unbounded
  plane, sphere, capsule, ellipsoid, cylinder, box, each on a free body
  at seeded poses) and a 10 x 12 height field (198 triangles: the JAX
  package walks its BVH), 48 rays per world at 8 worlds: the port's
  ``rays`` against the JAX ``rays`` (vmapped) on the same geom frames,
  the same geom ids and distances within atol 1e-4 + rtol 1e-4; world 0
  against ``mj_ray`` within 1e-4; ``bodyexclude`` and ``flg_static``.
  ``mj_ray`` also meets a height field's four sides and its base, where
  the JAX package, and the port with it, casts the top surface alone: a
  ray that C stops there is left out of the comparison with C (a few of
  each scene's rays) and counted.
- Quadruped escape's committed 201 x 201 terrain: its rangefinders'
  rays and 48 seeded rays per world from the torso against ``mj_ray`` (world 0)
  and against the JAX ``rays``, and the walk's trips within nrow + ncol -
  3.
- A mesh geom raises until the mesh slice.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import ray as jray
from mujoco_warp_tpu_torch import io as tio, parity, types
from mujoco_warp_tpu_torch.ops import forward, ray
from tests.test_torch_dmc_rest import models
from tests.torch_threads import few_threads  # noqa: F401

W, R = 8, 48
ATOL, RTOL = 1e-4, 1e-4

_XML = """
<mujoco>
  <asset>
    <hfield name="hf" nrow="10" ncol="12" size="1.5 1.2 0.5 0.1"
            elevation="{elev}"/>
  </asset>
  <worldbody>
    <geom type="plane" size="3 3 0.1" pos="0 0 -0.2"/>
    <geom type="plane" size="0 0 1" pos="0 0 4" euler="180 0 0"/>
    <geom type="hfield" hfield="hf" pos="0.2 0.1 0" euler="0 0 15"/>
    <body pos="-0.8 0.5 0.9"><freejoint/>
      <geom type="sphere" size="0.2"/></body>
    <body pos="0.6 -0.5 1.0"><freejoint/>
      <geom type="capsule" size="0.1 0.3"/></body>
    <body pos="0.0 0.8 1.1"><freejoint/>
      <geom type="ellipsoid" size="0.3 0.15 0.1"/></body>
    <body pos="0.9 0.6 0.8"><freejoint/>
      <geom type="cylinder" size="0.15 0.2"/></body>
    <body pos="-0.6 -0.7 1.0"><freejoint/>
      <geom type="box" size="0.2 0.1 0.15"/></body>
  </worldbody>
</mujoco>
"""


def _scene():
  rng = np.random.default_rng(0)
  elev = ' '.join(f'{x:.4f}' for x in rng.uniform(0.0, 1.0, 120))
  mjm = mujoco.MjModel.from_xml_string(_XML.format(elev=elev))
  return mjm, jio.put_model(mjm), tio.put_model(mjm, device='cpu')


def _poses(m, seed):
  rng = np.random.default_rng(seed)
  qpos = np.tile(types.host(m.qpos0, np.float32), (W, 1))
  qpos += 0.1 * rng.standard_normal(qpos.shape)
  for j in range(m.njnt):
    a = int(m.jnt_qposadr[j]) + 3
    qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                       keepdims=True)
  return qpos.astype(np.float32)


def _rays(seed, lo, hi, down=0.8):
  rng = np.random.default_rng(seed)
  pnt = rng.uniform(lo, hi, (W, R, 3)).astype(np.float32)
  vec = rng.standard_normal((W, R, 3))
  vec[..., 2] -= down
  vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
  return pnt, vec.astype(np.float32)


def _frames(m, mj, qpos):
  d = forward.pre(m, tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos)))
  dj = jio.make_data(mj, nworld=W).replace(
      geom_xpos=jnp.asarray(d.geom_xpos.numpy()),
      geom_xmat=jnp.asarray(d.geom_xmat.numpy()))
  return d, dj


def _against_jax(m, mj, d, dj, pnt, vec, **kw):
  got_d, got_g = ray.rays(m, d, torch.as_tensor(pnt), torch.as_tensor(vec),
                          **kw)
  want_d, want_g = jax.vmap(lambda x, p, v: jray.rays(mj, x, p, v, **kw))(
      dj, jnp.asarray(pnt), jnp.asarray(vec))
  np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
  np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=ATOL,
                             rtol=RTOL)
  return got_d.numpy(), got_g.numpy()


def _on_side(mjm, mjd, g, point):
  """Does ``point`` lie on a side or the base of height-field geom g (not
  on its top surface)?"""
  loc = mjd.geom_xmat[g].reshape(3, 3).T @ (point - mjd.geom_xpos[g])
  sx, sy = mjm.hfield_size[mjm.geom_dataid[g], :2]
  return abs(loc[0]) >= sx * (1 - 1e-5) or abs(loc[1]) >= sy * (1 - 1e-5) \
      or loc[2] < 0.0


def _against_c(mjm, qpos, dist, gid, pnt, vec, **kw):
  """World 0 against ``mj_ray`` (``bodyexclude`` and ``flg_static`` as
  given), but for the rays that C stops on a height field's side or base;
  returns their count."""
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = qpos[0]
  mujoco.mj_kinematics(mjm, mjd)
  geomid = np.zeros(1, np.int32)
  sides = 0
  for i in range(pnt.shape[1]):
    p, v = pnt[0, i].astype(np.float64), vec[0, i].astype(np.float64)
    ref = mujoco.mj_ray(mjm, mjd, p, v, None,
                        int(kw.get('flg_static', True)),
                        kw.get('bodyexclude', -1), geomid)
    if ref >= 0 and mjm.geom_type[geomid[0]] == mujoco.mjtGeom.mjGEOM_HFIELD \
        and _on_side(mjm, mjd, geomid[0], p + ref * v):
      sides += 1
      continue
    assert gid[0, i] == geomid[0], (i, gid[0, i], geomid[0])
    np.testing.assert_allclose(dist[0, i], ref, atol=ATOL, rtol=RTOL)
  return sides


@pytest.mark.parametrize('seed', [0, 1])
def test_primitives_and_hfield_match_jax_and_c(seed):
  mjm, mj, m = _scene()
  qpos = _poses(m, seed)
  d, dj = _frames(m, mj, qpos)
  pnt, vec = _rays(seed, (-1.5, -1.5, 0.3), (1.5, 1.5, 2.0))
  dist, gid = _against_jax(m, mj, d, dj, pnt, vec)
  assert _against_c(mjm, qpos, dist, gid, pnt, vec) <= 4
  # every type is hit somewhere, and some rays miss everything
  hit_types = set(np.asarray(m.geom_type)[gid[gid >= 0]].tolist())
  assert hit_types >= {0, 1}, hit_types
  assert len(hit_types) >= 5


def test_exclusion_matches_jax_and_c():
  mjm, mj, m = _scene()
  qpos = _poses(m, 2)
  d, dj = _frames(m, mj, qpos)
  pnt, vec = _rays(2, (-1.5, -1.5, 0.3), (1.5, 1.5, 2.0))
  for kw in ({'bodyexclude': 2}, {'flg_static': False}):
    dist, gid = _against_jax(m, mj, d, dj, pnt, vec, **kw)
    assert _against_c(mjm, qpos, dist, gid, pnt, vec, **kw) <= 4
  # without static geoms, no ray meets the planes or the height field
  assert not np.isin(gid, [0, 1, 2]).any()


def test_escape_terrain_matches_jax_and_c():
  mjm, mj, m = models('quadruped_escape')
  qpos, _, _ = parity.dmc_state(m, 'quadruped_escape', W, 0)
  d, dj = _frames(m, mj, qpos)
  # the rangefinders' rays, then rays from near the torso at large
  rf = np.nonzero(np.asarray(m.sensor_type) ==
                  types.SensorType.RANGEFINDER)[0]
  sites = np.asarray(m.sensor_objid)[rf]
  rng = np.random.default_rng(0)
  pnt = np.concatenate([d.site_xpos[:, sites].numpy(), d.xpos[:, 1:2].numpy()
                        + rng.uniform(-0.5, 0.5, (W, R, 3))], 1)
  vec = np.concatenate([d.site_xmat[:, sites, :, 2].numpy(),
                        rng.standard_normal((W, R, 3))], 1)
  vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
  pnt, vec = pnt.astype(np.float32), vec.astype(np.float32)
  trips = ray.trips
  dist, gid = _against_jax(m, mj, d, dj, pnt, vec, bodyexclude=1)
  walked = ray.trips - trips
  assert 0 < walked <= 201 + 201 - 3
  assert _against_c(mjm, qpos, dist, gid, pnt, vec, bodyexclude=1) <= 8
  hfield = int(np.nonzero(np.asarray(m.geom_type) == types.GeomType.HFIELD)
               [0][0])
  assert (gid == hfield).mean() > 0.3


def test_mesh_raises():
  mjm = mujoco.MjModel.from_xml_string("""
  <mujoco><asset><mesh name="tet" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/>
  </asset><worldbody><geom type="mesh" mesh="tet"/></worldbody></mujoco>""")
  m = tio.put_model(mjm, device='cpu')
  d = forward.pre(m, tio.make_data(m, 1, device='cpu'))
  with pytest.raises(NotImplementedError, match='mesh'):
    ray.rays(m, d, torch.zeros((1, 1, 3)), torch.ones((1, 1, 3)))
