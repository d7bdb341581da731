"""The contact override and ``io.override_model``
(``mujoco_warp_tpu/io.py:1498``; the ``EnableBit.OVERRIDE`` branch of
``collision_driver._mix_params`` :317-326) against the JAX package, on
spheres.xml (pyramidal, condim 3, 4 and 6 pairs of spheres, capsules,
boxes and planes).

- ``put_model`` of an MjModel with ``<flag override="enable"/>`` and its
  o_* values set: every field of the Model, the per-candidate tables
  among them, equals the JAX ``put_model``'s, float32 bit for bit.
- ``override_model`` of a Model without the override: the same o_*
  values and the flag by ``opt.*`` overrides (and the solver, iterations
  and timestep) give the JAX ``override_model``'s option fields and
  tables; ``opt.cone`` raises.
- One general step with the override on against the JAX ``forward.step``
  (batched, jitted, its jnp path on the CPU) at 16 worlds of
  ``parity.spheres_state``: the contact rows and qpos, qvel at the step
  bars of ``tests/test_torch_classic_step.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.oracle import assert_close
from tests.test_torch_classic_step import fast_compile, world_scale
from tests.test_torch_io import jax_model_numpy
from tests.torch_threads import few_threads  # noqa: F401

W = 16
O_MARGIN = 0.004
O_SOLREF = (0.03, 1.2)
O_SOLIMP = (0.8, 0.9, 0.002, 0.6, 3.0)
O_FRICTION = (0.7, 0.7, 0.01, 0.002, 0.002)
CAND = ('cand_friction', 'cand_solref', 'cand_solimp', 'cand_includemargin')


def overridden():
  mjm = tio.load_spheres()
  mjm.opt.enableflags |= int(types.EnableBit.OVERRIDE)
  mjm.opt.o_margin = O_MARGIN
  mjm.opt.o_solref[:] = O_SOLREF
  mjm.opt.o_solimp[:] = O_SOLIMP
  mjm.opt.o_friction[:] = O_FRICTION
  return mjm


@functools.lru_cache(maxsize=None)
def models():
  mjm = overridden()
  return jio.put_model(mjm), tio.put_model(mjm, device='cpu')


def test_put_model_takes_the_override():
  mj, m = models()
  ref = jax_model_numpy(mj)
  for k, v in tio.model_to_numpy(m).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
  np.testing.assert_array_equal(m.cand_friction.numpy(),
                                np.broadcast_to(np.float32(O_FRICTION),
                                                (m.ncand, 5)))
  plain = tio.put_model(tio.load_spheres(), device='cpu')
  assert not torch.equal(plain.cand_solref, m.cand_solref)
  assert forward.unsupported(m) is None


def test_override_model_matches_jax():
  mjm = tio.load_spheres()
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  ovs = ['opt.enableflags=1', f'opt.o_margin={O_MARGIN}',
         'opt.o_solref=0.05', 'opt.o_solimp=0.9', 'opt.o_friction=0.3',
         'opt.solver=cg', 'opt.iterations=20', 'opt.timestep=0.004']
  got, want = tio.override_model(m, ovs), jio.override_model(mj, ovs)
  for k in CAND:
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)), err_msg=k)
  assert (got.opt.solver, got.opt.iterations, got.opt.enableflags) == (
      int(types.SolverType.CG), 20, 1)
  assert float(got.opt.timestep) == float(want.opt.timestep)
  assert got.opt.o_solref.shape == (2,) and float(got.opt.o_solref[1]) == \
      np.float32(0.05)
  # off again: the tables mixed from the geoms, as put_model mixed them
  off = tio.override_model(got, ['opt.enableflags=0'])
  for k in CAND:
    assert torch.equal(getattr(off, k), getattr(m, k)), k
  with pytest.raises(ValueError, match='cone'):
    tio.override_model(m, ['opt.cone=elliptic'])
  with pytest.raises(NotImplementedError):
    tio.override_model(m, ['body_mass=1'])


def test_step_with_the_override_matches_jax():
  mj, m = models()
  qpos, qvel, ctrl = parity.spheres_state(m, W, 4)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  want = fast_compile(lambda x: jfwd.step(mj, x), dj)(dj)
  t = torch.as_tensor
  got = forward.step(m, tio.make_data(m, W, device='cpu').replace(
      qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl)))
  assert_close(got.efc_J.numpy(), np.asarray(want.efc_J), 'efc_J', 1e-5,
               1e-4)
  assert_close(got.efc_D.numpy(), np.asarray(want.efc_D), 'efc_D', 1e-5,
               1e-4)
  world_scale(got.efc_aref.numpy(), want.efc_aref, 'efc_aref')
  assert_close(got.qpos.numpy(), np.asarray(want.qpos), 'qpos', 2e-4, 1e-3)
  assert_close(got.qvel.numpy(), np.asarray(want.qvel), 'qvel', 5e-3, 5e-3)
  np.testing.assert_array_equal(got.ncon_active.numpy(),
                                np.asarray(want.ncon_active))
  assert int(got.ncon_active.min()) > 0
