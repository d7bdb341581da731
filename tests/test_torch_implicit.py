"""IMPLICIT and IMPLICITFAST on the general step against the JAX package
(``derivative.implicit``, its jnp path on the CPU).

The scenes ``constraints_implicitfast`` (the constraints snapshot under
IMPLICITFAST: the AFFINE actuators' velocity gains put a term beside the
joint damping into qDeriv) and ``cheetah_implicit`` (the cheetah under
IMPLICIT: the RNE derivative of a planar floating base) at 16 worlds,
one step stage by stage and three steps, and ``pendula.xml`` under both
integrators, three steps, at the bars of
``tests/test_torch_classic_step.py``.  ``deriv_smooth_vel`` (with tendon
damping on tendon_mix) and ``deriv_rne_vel`` elementwise against JAX's
within 1e-5 + 1e-4 of the world's largest entry."""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import derivative as jderiv
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch.ops import derivative, forward
from tests.test_torch_classic_step import W, check_state, fast_compile, \
    one_step, three_steps, world_scale
from tests.torch_threads import few_threads  # noqa: F401

SCENES = ('constraints_implicitfast', 'cheetah_implicit')
PENDULA = tio._MODELS + '/pendula.xml'
_IT = mujoco.mjtIntegrator


@pytest.mark.parametrize('scene', SCENES)
def test_one_step_stage_by_stage(scene):
  m, _ = one_step(scene)
  assert m.opt.integrator in (types.IntegratorType.IMPLICIT,
                              types.IntegratorType.IMPLICITFAST)


@pytest.mark.parametrize('scene', SCENES)
def test_three_steps_match_jax(scene):
  three_steps(scene)


def _states(mjm, seed):
  """(JAX Model, port Model, JAX Data, port Data) after the position and
  velocity stages, at ``parity.general_state`` (qvel x 5)."""
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, qvel, ctrl = parity.general_state(m, W, seed)
  qvel = 5.0 * qvel
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(qpos=t(qpos), qvel=t(qvel),
                                                ctrl=t(ctrl))
  d = forward.mid(m, forward.mass_chain(m, forward.pre(m, d)))
  return mj, m, dj, d


@pytest.mark.parametrize('integrator', [_IT.mjINT_IMPLICIT,
                                        _IT.mjINT_IMPLICITFAST])
def test_pendula_matches_jax(integrator):
  mjm = mujoco.MjModel.from_xml_path(PENDULA)
  mjm.opt.integrator = integrator
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, qvel, ctrl = parity.general_state(m, W, 11)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(3.0 * qvel),
      ctrl=jnp.asarray(ctrl))
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  t = torch.as_tensor
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=t(qpos), qvel=t(3.0 * qvel), ctrl=t(ctrl))
  for _ in range(3):
    dj, d = step(dj), forward.step(m, d)
    check_state(m, d, dj)


def _jax_derivs(mj, dj):
  def one(x):
    x = jfwd.fwd_velocity(mj, jfwd.fwd_position(mj, x))
    return jderiv.deriv_smooth_vel(mj, x), jderiv.deriv_rne_vel(mj, x)
  return [np.asarray(a) for a in fast_compile(jax.vmap(one), dj)(dj)]


@pytest.mark.parametrize('scene', ['constraints', 'pendula', 'tendon_mix'])
def test_derivatives_match_jax(scene):
  """qDeriv's smooth part and the RNE part against JAX's; each scene shows
  the term it is there for (the actuators' velocity gains, Coriolis
  terms of a chain, tendon damping)."""
  path = {'constraints': tio.CONSTRAINTS_XML, 'pendula': PENDULA,
          'tendon_mix': tio.TENDON_XML['tendon_mix']}[scene]
  mjm = mujoco.MjModel.from_xml_path(path)
  mj, m, dj, d = _states(mjm, 4)
  smooth_j, rne_j = _jax_derivs(mj, dj)
  smooth_t = derivative.deriv_smooth_vel(m, d).numpy()
  rne_t = derivative.deriv_rne_vel(m, d).numpy()
  world_scale(smooth_t, smooth_j, 'deriv_smooth_vel')
  world_scale(rne_t, rne_j, 'deriv_rne_vel')
  assert np.abs(rne_t).max() > 1e-3
  diag = np.abs(np.diagonal(smooth_t, axis1=1, axis2=2))
  damping = types.host(m.dof_damping)
  if scene == 'constraints':  # velocity gains beyond the damping
    assert np.abs(diag - damping).max() > 0.1
  if scene == 'tendon_mix':  # tendon damping couples dofs
    off = smooth_t - np.einsum('wii->wi', smooth_t)[..., None] * np.eye(m.nv)
    assert np.abs(off).max() > 1e-3
