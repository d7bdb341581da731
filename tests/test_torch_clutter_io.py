"""Port io on the large-tree contact scene ``clutter_arm_nosleep``
(``clutter_arm.xml`` with ``opt.enableflags`` 0, lossless contact slots):
its Model against the JAX put_model, its committed snapshot, the general
step's gate, and the seeded contact-rich state every clutter test uses.

``states`` is shared by the other ``test_torch_clutter_*`` files.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu_torch import fused, parity
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_io import assert_models_equal, jax_model_numpy
from tests.torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def models():
  """(JAX Model, port Model) of clutter_arm_nosleep, as the JAX benchmark
  builds it (``benchmarks.build`` with the enableflags override and
  ``nconmax=None``)."""
  mjm = tio.load_clutter()
  return jio.put_model(mjm, nconmax=None), tio.put_model(mjm, device='cpu')


def states(W, seed):
  """(JAX Model, port Model, JAX Data, port Data) at the contact-rich
  clutter state of ``parity.clutter_state``."""
  mj, m = models()
  qpos, qvel, ctrl = parity.clutter_state(m, W, seed)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  return mj, m, dj, d


def test_put_model_matches_jax_on_clutter():
  """Every field of the port's Model equals the JAX Model's, the
  candidate table and its pair groups included (box-box takes MPR with
  four points per pair); the general step takes the model, the fused
  gate does not."""
  mj, m = models()
  ref = jax_model_numpy(mj)
  for k, v in tio.model_to_numpy(m).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
    elif k == 'pair_groups':
      assert [(a, b, list(i), s) for a, b, i, s in v] == \
          [(int(a), int(b), list(i), int(s)) for a, b, i, s in mj.pair_groups]
    elif k not in ('tree.body_levels', 'con_classes'):
      assert v == ref[k], k
  assert (m.nq, m.nv, m.nbody, m.nu, m.ncand, m.ncon, m.nefc) == \
      (87, 75, 16, 3, 183, 183, 732)
  assert not m.con_compact and (6, 6) in [(g[0], g[1]) for g in
                                          m.pair_groups]
  assert forward.unsupported(m) is None and not fused.supported(m)
  assert forward.large_system(m)


def test_clutter_snapshot_matches_fresh_put_model(tmp_path):
  """The committed snapshot is what ``--snapshot`` writes today."""
  path = str(tmp_path / 'clutter.npz')
  fresh = tio.make_clutter_snapshot(path)
  assert_models_equal(tio.load_model_npz(tio.CLUTTER_SNAPSHOT,
                                         device='cpu'), fresh)
  assert_models_equal(tio.load_model_npz(path, device='cpu'), fresh)


def test_clutter_state_is_contact_rich():
  """Every pair group of the seeded state has live contacts in most
  worlds (box-box included), through the port's collision."""
  from mujoco_warp_tpu_torch.ops import collision_driver
  _, m, _, d = states(32, 0)
  d = collision_driver.collision(m, forward.pre(m, d))
  live = (d.contact.dist < d.contact.includemargin).numpy()
  for t1, t2, idx, slot in m.pair_groups:
    k = collision_driver.group_ncon(t1, t2)
    per_world = live[:, slot:slot + k * len(idx)].any(axis=1)
    assert per_world.mean() > 0.9, (t1, t2, per_world.mean())
  assert int(d.ncon_active.min()) >= 40
  np.testing.assert_array_equal(d.ncon_active.numpy(), live.sum(axis=1))


def test_clutter_modules_import_no_jax():
  """The slice's new modules import torch and never jax."""
  code = ('import sys, mujoco_warp_tpu_torch.ops.collision_driver, '
          'mujoco_warp_tpu_torch.ops.collision_convex, '
          'mujoco_warp_tpu_torch.ops.solver, mujoco_warp_tpu_torch.parity; '
          'bad = [k for k in sys.modules if k == "jax" or '
          'k.startswith(("jax.", "mujoco_warp_tpu.")) or '
          'k == "mujoco_warp_tpu"]; '
          'print(bad); sys.exit(1 if bad else 0)')
  res = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
  assert res.returncode == 0, res.stdout + res.stderr


def test_put_model_refuses_unported_convex_geoms():
  """A convex pair without a ported support (mesh-box here; cylinder and
  ellipsoid supports are ported) makes ``put_model`` raise, naming the
  slice that brings it."""
  xml = """<mujoco><asset>
    <mesh name="tet" vertex="0 0 0  .1 0 0  0 .1 0  0 0 .1"/>
  </asset><worldbody>
    <body><freejoint/><geom type="mesh" mesh="tet"/></body>
    <body pos="0 0 .5"><freejoint/><geom type="box" size=".1 .1 .1"/></body>
  </worldbody></mujoco>"""
  mjm = mujoco.MjModel.from_xml_string(xml)
  with pytest.raises(NotImplementedError, match='MESH.*mesh slice'):
    tio.put_model(mjm, device='cpu')
