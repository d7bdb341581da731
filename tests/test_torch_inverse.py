"""Inverse dynamics (``ops/inverse.py``) against the JAX ``inverse``
under ``vmap`` (its jnp path on the CPU), at 16 worlds of a seeded state
with a seeded qacc (1.0 N): on constraints (equality, friction loss and
limit rows, joint damping) and spheres (pyramidal contacts), without and
with ``EnableBit.INVDISCRETE`` (damped Euler on constraints; IMPLICITFAST
through qDeriv on constraints_implicitfast).  qfrc_inverse and
qfrc_constraint within 1e-5 + 1e-4 of the world's largest entry.

The round trip: after a forward to the converged qacc (the step's stages
up to the solve), the inverse at that qacc gives back qfrc_applied +
qfrc_actuator within 1e-4 + 1e-4 of the world's largest entry of M qacc,
qfrc_bias and qfrc_constraint.  An elliptic model raises, naming the
roadmap item."""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import inverse as jinv
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.ops import forward, inverse
from tests.test_torch_classic_step import fast_compile, world_scale
from tests.torch_threads import few_threads  # noqa: F401

W = 16
_IT = mujoco.mjtIntegrator
# scene: (XML, integrator)
SCENES = {'constraints': (tio.CONSTRAINTS_XML, _IT.mjINT_EULER),
          'spheres': (tio.SPHERES_XML, _IT.mjINT_EULER),
          'constraints_implicitfast': (tio.CONSTRAINTS_XML,
                                       _IT.mjINT_IMPLICITFAST)}


@functools.lru_cache(maxsize=None)
def case(scene, discrete):
  path, integ = SCENES[scene]
  mjm = mujoco.MjModel.from_xml_path(path)
  mjm.opt.integrator = integ
  if discrete:
    mjm.opt.enableflags |= int(types.EnableBit.INVDISCRETE)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  dj = jio.make_data(mj, nworld=W)
  return mj, m, fast_compile(jax.vmap(lambda x: jinv.inverse(mj, x)), dj)


def state(m, scene, seed=2):
  """World-major (qpos, qvel, ctrl, qacc): the scene's seeded state
  (``parity.spheres_state`` with its contacts, else
  ``parity.general_state``) and qacc 1.0 N."""
  if scene == 'spheres':
    qpos, qvel, ctrl = parity.spheres_state(m, W, seed)
  else:
    qpos, qvel, ctrl = parity.general_state(m, W, seed)
  rng = np.random.default_rng(seed + 100)
  return qpos, qvel, ctrl, rng.standard_normal((W, m.nv)).astype(np.float32)


@pytest.mark.parametrize('scene,discrete', [
    ('constraints', False), ('constraints', True), ('spheres', False),
    ('spheres', True), ('constraints_implicitfast', True)])
def test_inverse_matches_jax(scene, discrete):
  mj, m, inv_j = case(scene, discrete)
  qpos, qvel, ctrl, qacc = state(m, scene)
  a = jnp.asarray
  dj = jio.make_data(mj, nworld=W).replace(qpos=a(qpos), qvel=a(qvel),
                                           ctrl=a(ctrl), qacc=a(qacc))
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl), qacc=t(qacc))
  got, want = inverse.inverse(m, d), inv_j(dj)
  world_scale(got.qfrc_inverse.numpy(), want.qfrc_inverse, 'qfrc_inverse')
  world_scale(got.qfrc_constraint.numpy(), want.qfrc_constraint,
              'qfrc_constraint')
  assert float(got.qfrc_constraint.abs().max()) > 1e-2
  if discrete and scene != 'spheres':
    # the discrete form changes the answer on a damped model
    plain = case(scene, False)[2](dj)
    assert np.abs(np.asarray(plain.qfrc_inverse) -
                  np.asarray(want.qfrc_inverse)).max() > 1e-3


@pytest.mark.parametrize('scene', ['constraints', 'spheres'])
def test_forward_inverse_round_trip(scene):
  m = case(scene, False)[1]
  qpos, qvel, ctrl, _ = state(m, scene, seed=6)
  t = torch.as_tensor
  rng = np.random.default_rng(6)
  applied = t((0.5 * rng.standard_normal((W, m.nv))).astype(np.float32))
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl), qfrc_applied=applied)
  fwd = forward._forward(m, d)
  assert bool((fwd.solver_niter < m.opt.iterations).all())
  inv = inverse.inverse(m, d.replace(qacc=fwd.qacc))
  want = (applied + fwd.qfrc_actuator).numpy()
  scale = np.maximum.reduce([
      np.abs(x.numpy()).max(1) for x in (
          torch.einsum('wij,wj->wi', fwd.qM, fwd.qacc), fwd.qfrc_bias,
          fwd.qfrc_constraint)])
  err = np.abs(inv.qfrc_inverse.numpy() - want).max(1)
  assert np.all(err <= 1e-4 + 1e-4 * scale), (err / scale).max()


def test_elliptic_cones_raise():
  mjm = tio.load_spheres(types.ConeType.ELLIPTIC)
  m = tio.put_model(mjm, device='cpu')
  qpos, qvel, _, _ = state(m, 'spheres')
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(qpos=t(qpos), qvel=t(qvel))
  with pytest.raises(NotImplementedError, match='queue 1: elliptic cones'):
    inverse.inverse(m, d)
