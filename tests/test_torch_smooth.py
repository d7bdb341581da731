"""The general step's position stages and plain mass chain against the
JAX package on the constraints scene (ball, free, hinge and slide joints).

``kinematics``, ``com_pos`` and ``transmission`` are held against the JAX
stages under ``vmap`` at 16 worlds, atol 1e-5 (the same float32
operations, some summed in another order); the plain mass chain against
``psmooth.mass_chain(m, d, interpret=True)`` at 128 worlds, rtol 1e-4 of
each output's largest magnitude (sums of up to nbody * 36 products).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import smooth as jsmooth
from mujoco_warp_tpu.pallas import smooth as psmooth
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
from mujoco_warp_tpu_torch.ops import smooth
from tests.torch_threads import few_threads  # noqa: F401

ATOL = 1e-5
RTOL = 1e-4


def states(W, seed):
  """(JAX Model, port Model, JAX Data, port Data) of the constraints
  scene at the parity state (qpos0 + 0.1 N, qvel 0.2 N, ctrl 0.3 N)."""
  mjm = mujoco.MjModel.from_xml_path(tio.CONSTRAINTS_XML)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, qvel, ctrl = parity.general_state(m, W, seed)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  d = tio.make_data(m, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  return mj, m, dj, d


def close(got, want, name, atol=ATOL):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                             rtol=0.0, err_msg=name)


def test_position_stages_match_jax():
  mj, m, dj, d = states(16, 0)
  assert set(int(t) for t in m.jnt_type) == {0, 1, 2, 3}
  dj = jax.jit(jax.vmap(lambda x: jsmooth.transmission(mj, jsmooth.com_pos(
      mj, jsmooth.kinematics(mj, x)))))(dj)
  d = smooth.transmission(m, smooth.com_pos(m, smooth.camlight(
      m, smooth.kinematics(m, d))))
  for name in ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'xanchor',
               'xaxis', 'geom_xpos', 'geom_xmat', 'subtree_com', 'cinert',
               'cdof', 'actuator_length', 'actuator_moment'):
    close(getattr(d, name), getattr(dj, name), name)


def test_plain_mass_chain_matches_pallas_interpret():
  mj, m, dj, d = states(128, 1)
  dj = jax.jit(jax.vmap(lambda x: jsmooth.com_pos(
      mj, jsmooth.kinematics(mj, x))))(dj)
  dj = psmooth.mass_chain(mj, dj, interpret=True)
  d = smooth.com_pos(m, smooth.kinematics(m, d))
  n = kmass.launches
  d = kmass.mass_chain(m, d)  # CPU tensors: the plain version
  assert kmass.launches == n
  for name in ('qM', 'qLD', 'cvel', 'cdof_dot', 'qfrc_bias'):
    want = np.asarray(getattr(dj, name))
    close(getattr(d, name), want, name,
          atol=RTOL * max(1.0, float(np.abs(want).max())))


def test_factor_solve_mul_and_jac_match_jax():
  """factor_m, solve_m, mul_m and support.jac against the JAX functions
  under vmap at 16 worlds (the port factors with its lane Cholesky, JAX
  with LAPACK's: rtol 1e-4 of each output's scale)."""
  from mujoco_warp_tpu.ops import support as jsupport
  from mujoco_warp_tpu_torch.ops import support
  mj, m, dj, d = states(16, 5)
  x = np.random.default_rng(6).standard_normal((16, m.nv)).astype(np.float32)
  body = int(m.nbody - 1)
  point = np.asarray([0.1, -0.2, 1.3], np.float32)

  def jax_side(dd, xx):
    dd = jsmooth.factor_m(mj, jsmooth.crb(mj, jsmooth.com_pos(
        mj, jsmooth.kinematics(mj, dd))))
    return (dd.qLD, jsmooth.solve_m(mj, dd, xx), jsmooth.mul_m(mj, dd, xx),
            *jsupport.jac(mj, dd, jnp.asarray(point), body))
  want = jax.jit(jax.vmap(jax_side))(dj, jnp.asarray(x))
  d = smooth.factor_m(m, kmass.mass_chain(m, smooth.com_pos(
      m, smooth.kinematics(m, d))))
  xt = torch.as_tensor(x)
  got = (d.qLD, smooth.solve_m(m, d, xt), smooth.mul_m(m, d, xt),
         *support.jac(m, d, torch.as_tensor(point).expand(16, 3), body))
  for name, a, b in zip(('qLD', 'solve_m', 'mul_m', 'jacp', 'jacr'), got,
                        want):
    b = np.asarray(b)
    close(a, b, name, atol=RTOL * max(1.0, float(np.abs(b).max())))
