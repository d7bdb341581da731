"""The port's fused step against the JAX fused step: glue, world sort,
and whole steps.

Glue (compaction, smooth forces) must match the JAX glue exactly: both
sides move the same float32 values (one-hot contraction there, prefix
sum and scatter here).  ``run_steps`` serves the whole-step tests
(test_torch_step_*.py), held to the bars of tests/test_fused.py: qpos
atol 2e-4 rtol 1e-3, qvel atol 5e-3 rtol 5e-3.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import benchmarks
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.pallas import fused as jfused
from mujoco_warp_tpu_torch import fused as tfused
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.fused import glue, k1_ref
from tests.test_fused import _BOX46
from tests.test_torch_k1 import lane_state
from tests.torch_threads import few_threads  # noqa: F401

W_STEP = 128  # the Pallas interpreter runs whole 128-world tiles


def k1_outputs(m, W, seed, drop):
  qpos, qvel = lane_state(m, W, seed)
  qpos[2] -= drop
  out = k1_ref.k1(m, torch.as_tensor(qpos), torch.as_tensor(qvel),
                  need_qLD=False)
  return qpos, qvel, out


@pytest.mark.parametrize('nconmax', [{1: 12, 3: 24}, {1: 2, 3: 3}])
def test_compact_matches_xla(nconmax):
  """Compaction of a contact-rich humanoid state, with the benchmark's
  slot budget and with one small enough to overflow."""
  mjm = benchmarks.load_humanoid_benchmark()
  mj, m = jio.put_model(mjm, nconmax=nconmax), tio.put_model(mjm, nconmax, device='cpu')
  _, _, (_, _, _, _, dist, cpos, cframe, stcom) = k1_outputs(m, 32, 11, 0.3)
  con_t, ov_t = glue.compact(m, dist, cpos, cframe, stcom)
  j = lambda x: jnp.asarray(x.numpy())
  con_j, ov_j = jfused._compact_xla(mj, j(dist), j(cpos), j(cframe),
                                    j(stcom), jnp.float32)
  assert con_t.keys() == con_j.keys()
  for k in con_t:
    np.testing.assert_array_equal(con_t[k].numpy(), np.asarray(con_j[k]),
                                  err_msg=k)
  np.testing.assert_array_equal(ov_t.numpy(), np.asarray(ov_j))
  assert bool((ov_t != 0).any()) == (nconmax[1] == 2)


def test_identity_con_and_middle_match_xla():
  """No-compaction contacts (box scene) and the smooth forces."""
  mjm = mujoco.MjModel.from_xml_string(_BOX46)
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, qvel, out = k1_outputs(m, 16, 12, 0.0)
  _, _, bias, _, dist, cpos, cframe, stcom = out
  con_t, _ = glue.identity_con(m, dist, cpos, cframe, stcom)
  j = lambda x: jnp.asarray(x.numpy())
  con_j, _ = jfused._identity_con_xla(mj, j(dist), j(cpos), j(cframe),
                                      j(stcom), jnp.float32)
  for k in con_t:
    np.testing.assert_array_equal(con_t[k].numpy(), np.asarray(con_j[k]),
                                  err_msg=k)

  mjm = benchmarks.load_humanoid_benchmark()
  mj, m = jio.put_model(mjm), tio.put_model(mjm, device='cpu')
  qpos, qvel, out = k1_outputs(m, 16, 13, 0.0)
  ctrl = np.random.default_rng(14).standard_normal((m.nu, 16)).astype(
      np.float32)
  t = torch.as_tensor
  got = glue.middle(m, out[2], t(qpos), t(qvel), t(ctrl))
  want = jfused._middle(mj, j(out[2]), jnp.asarray(qpos), jnp.asarray(qvel),
                        jnp.asarray(ctrl), jnp.float32)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)


def test_sort_worlds_matches_jax():
  """Same stable permutation (ties keep lane order), world_id undoes it."""
  m = tio.load_model_npz(device='cpu')
  W = 64
  rng = np.random.default_rng(15)
  niter = rng.integers(0, 4, size=(1, W)).astype(np.int32)
  qpos = rng.standard_normal((m.nq, W)).astype(np.float32)
  d = tio.make_data(m, W, device='cpu')
  st_t = tfused.to_lane(m, d).replace(
      qpos=torch.as_tensor(qpos), solver_niter=torch.as_tensor(niter))
  st_j = jfused.FusedState(
      qpos=jnp.asarray(qpos), qvel=jnp.zeros((m.nv, W)),
      ctrl=jnp.zeros((m.nu, W)), warmstart=jnp.zeros((m.nv, W)),
      qacc=jnp.zeros((m.nv, W)), time=jnp.zeros((1, W)),
      solver_niter=jnp.asarray(niter), overflow=jnp.zeros((1, W), jnp.int32),
      world_id=jnp.arange(W, dtype=jnp.int32).reshape(1, W))
  out_t, out_j = tfused.sort_worlds(st_t), jfused.sort_worlds(st_j)
  np.testing.assert_array_equal(out_t.world_id.numpy(),
                                np.asarray(out_j.world_id))
  np.testing.assert_array_equal(out_t.qpos.numpy(), np.asarray(out_j.qpos))
  back = tfused.from_lane(m, out_t, d)
  np.testing.assert_array_equal(back.qpos.numpy(), qpos.T)


def run_steps(mjm, nconmax, nstep, seed, qpos_noise=0.01, qvel_noise=0.2,
              ctrl_noise=0.0, nworld=W_STEP, jit=False):
  """nstep port steps and nstep JAX interpret steps from one state
  (``jit``: the JAX step traced once, not per step)."""
  mj, m = jio.put_model(mjm, nconmax=nconmax), tio.put_model(mjm, nconmax, device='cpu')
  assert tfused.supported_features(m)
  W = nworld
  rng = np.random.default_rng(seed)
  qpos = (m.qpos0.numpy()[None] + qpos_noise * rng.standard_normal(
      (W, m.nq))).astype(np.float32)
  qvel = (qvel_noise * rng.standard_normal((W, m.nv))).astype(
      np.float32)
  ctrl = (ctrl_noise * rng.standard_normal((W, m.nu))).astype(
      np.float32)
  d = tio.make_data(m, W, device='cpu')
  d = d.replace(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
                ctrl=torch.as_tensor(ctrl))
  st = tfused.to_lane(m, d)
  for _ in range(nstep):
    st = tfused.step_lane(m, st)
  dj = jio.make_data(mj, nworld=W).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  sj = jfused.to_lane(mj, dj)
  step = lambda s: jfused.step_lane(mj, s, interpret=True)
  if jit:
    step = jax.jit(step)
  for _ in range(nstep):
    sj = step(sj)
  return st, sj
