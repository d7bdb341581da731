"""The port's height-field narrowphase against the JAX package.

- ``collision_hfield.surface``: exact heights and normals per triangle on
  a small bumpy field (9 rows, 13 columns, its geom moved and turned),
  against the JAX ``_surface`` at the same points, atol 1e-6.
- Every (HFIELD, t2) group of that scene (sphere, capsule, cylinder,
  ellipsoid, box) at 8 seeded worlds of poses near the surface: dist,
  pos and normal of the port's collider against the JAX collider (vmapped)
  on the same geom frames, atol 1e-5 + rtol 1e-4 where the point lies over
  the field; a box keeps its four deepest corners.
- The 19 height-field pairs of quadruped escape on its committed terrain
  at ``parity.dmc_state``: the same bar, and live contacts on the
  terrain.
- ``put_model`` refuses a height field against a mesh (no collider until
  the mesh slice) and accepts the five types above.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import collision_hfield as jhf
from mujoco_warp_tpu_torch import io as tio, parity, types
from mujoco_warp_tpu_torch.ops import collision_hfield, forward
from tests.test_torch_dmc_rest import models
from tests.torch_threads import few_threads  # noqa: F401

W = 8
_GT = types.GeomType

_XML = """
<mujoco>
  <asset>
    <hfield name="terrain" nrow="9" ncol="13" size="1.2 0.8 0.3 0.1"
            elevation="{elev}"/>
    {mesh_asset}
  </asset>
  <worldbody>
    <geom name="hf" type="hfield" hfield="terrain" pos="0.1 -0.05 0.02"
          euler="0 0 20" {hf_bits}/>
    <body name="b0" pos="0.1 0.05 0.25"><freejoint/>
      <geom type="sphere" size="0.1"/></body>
    <body name="b1" pos="-0.4 0.2 0.25"><freejoint/>
      <geom type="capsule" size="0.05 0.15" euler="0 90 0"/></body>
    <body name="b2" pos="0.5 -0.3 0.25"><freejoint/>
      <geom type="cylinder" size="0.07 0.1" euler="30 60 0"/></body>
    <body name="b3" pos="-0.5 -0.3 0.25"><freejoint/>
      <geom type="ellipsoid" size="0.08 0.12 0.05"/></body>
    <body name="b4" pos="0.3 0.4 0.25"><freejoint/>
      <geom type="box" size="0.08 0.06 0.05"/></body>
    {mesh_body}
  </worldbody>
</mujoco>
"""


def _mjm(mesh=False):
  rng = np.random.default_rng(0)
  elev = ' '.join(f'{x:.4f}' for x in rng.uniform(0.0, 1.0, 9 * 13))
  return mujoco.MjModel.from_xml_string(_XML.format(
      elev=elev,
      mesh_asset='<mesh name="tet" vertex="0 0 0 .1 0 0 0 .1 0 0 0 .1"/>'
      if mesh else '',
      # the mesh meets the height field alone (the field collides on
      # contype bits 1 and 2, every other geom on bit 1, the mesh on 2)
      hf_bits='contype="3" conaffinity="3"' if mesh else '',
      mesh_body='<body pos="0 0 .5"><freejoint/><geom type="mesh" '
      'mesh="tet" contype="2" conaffinity="2"/></body>' if mesh else ''))


def _state(m, seed):
  """Poses near the surface: each body's height 0.1-0.3, its x and y
  jittered by 0.1 and its orientation random."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(types.host(m.qpos0, np.float32), (W, 1))
  for j in range(m.njnt):
    a = int(m.jnt_qposadr[j])
    qpos[:, a:a + 2] += rng.uniform(-0.1, 0.1, (W, 2))
    qpos[:, a + 2] = rng.uniform(0.1, 0.3, W)
    q = rng.standard_normal((W, 4))
    qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
  return qpos.astype(np.float32)


def _frames(m, mj, qpos):
  """The port Data after the position stages at qpos, and a JAX Data
  holding its geom frames."""
  d = tio.make_data(m, W, device='cpu').replace(qpos=torch.as_tensor(qpos))
  d = forward.pre(m, d)
  dj = jio.make_data(mj, nworld=W).replace(
      geom_xpos=jnp.asarray(d.geom_xpos.numpy()),
      geom_xmat=jnp.asarray(d.geom_xmat.numpy()))
  return d, dj


def _check_groups(m, mj, d, dj):
  """Each height-field group of the port against the JAX collider; the
  number of live contacts."""
  live = 0
  groups = [g for g in m.pair_groups if g[0] == _GT.HFIELD]
  assert groups
  for t1, t2, idx, _ in groups:
    g1, g2 = m.pair_geom1[idx], m.pair_geom2[idx]
    got = collision_hfield.make_hfield_collider(t2)(m, d, g1, g2)
    want = jax.vmap(lambda x: jhf.make_hfield_collider(t2)(mj, x, g1, g2))(
        dj)
    assert got[0].shape == tuple(want[0].shape) == (
        W, collision_hfield.HFIELD_NCON[t2], len(idx))
    dist_w = np.asarray(want[0])
    over = dist_w < 1e9
    np.testing.assert_allclose(got[0].numpy(), dist_w, atol=1e-5, rtol=1e-4,
                               err_msg=f'dist {t2}')
    for k, name in ((1, 'pos'), (2, 'normal')):
      np.testing.assert_allclose(got[k].numpy()[over],
                                 np.asarray(want[k])[over], atol=1e-5,
                                 rtol=1e-4, err_msg=f'{name} {t2}')
    live += int((got[0] < 0).sum())
  return live


def test_surface_matches_jax():
  mjm = _mjm()
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  rng = np.random.default_rng(1)
  xy = rng.uniform(-1.3, 1.3, (256, 2)).astype(np.float32)
  h, nrm, inside = collision_hfield.surface(m, 0, torch.as_tensor(xy))
  hj, nj, ij = jhf._surface(mj, 0, jnp.asarray(xy))
  ins = np.asarray(ij)
  assert ins.any() and not ins.all()
  np.testing.assert_array_equal(inside.numpy(), ins)
  np.testing.assert_allclose(h.numpy()[ins], np.asarray(hj)[ins], atol=1e-6)
  np.testing.assert_allclose(nrm.numpy()[ins], np.asarray(nj)[ins],
                             atol=1e-6)


@pytest.mark.parametrize('seed', [0, 1])
def test_groups_match_jax(seed):
  mjm = _mjm()
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  assert sorted(int(g[1]) for g in m.pair_groups if g[0] == _GT.HFIELD) == \
      sorted(collision_hfield.HFIELD_NCON)
  d, dj = _frames(m, mj, _state(m, seed))
  assert _check_groups(m, mj, d, dj) > 0


def test_escape_terrain_matches_jax():
  _, mj, m = models('quadruped_escape')
  qpos, _, _ = parity.dmc_state(m, 'quadruped_escape', W, 0)
  d, dj = _frames(m, mj, qpos)
  assert sum(len(g[2]) for g in m.pair_groups if g[0] == _GT.HFIELD) == 19
  assert _check_groups(m, mj, d, dj) > 0


def test_put_model_refuses_mesh_on_hfield():
  with pytest.raises(NotImplementedError, match='HFIELD, MESH'):
    tio.put_model(_mjm(mesh=True), device='cpu')
