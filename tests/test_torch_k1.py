"""Plain K1 of the port (fused/k1_ref.py) against the JAX K1.

Stages are held against the JAX stage bodies called directly as jnp
functions (no Pallas) at W = 16; the whole plain K1 against
``fused._k1_call(..., interpret=True)`` at W = 128.  Tolerance: float32
atol 1e-5 on kinematics and contact geometry (both sides compute the
same float32 operations, summed in a different order), rtol 1e-4 on qM
and bias (sums of up to nbody * 36 products).  Contact geometry of the
whole kernel also gets rtol 1e-4: closest points of nearly parallel
capsule segments amplify rounding (the interpreter fuses multiply-adds
where the stage bodies do not); seen: 1.5e-5 on one of 68k positions.
"""

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import benchmarks
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.pallas import fused
from mujoco_warp_tpu.pallas import smooth as psmooth
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.fused import k1_ref
from mujoco_warp_tpu_torch.kernels import k1 as kk1
from tests.test_fused import _BOX46
from tests.torch_threads import few_threads  # noqa: F401

KIN_ATOL = 1e-5
MASS_RTOL = 1e-4


def models(scene):
  if scene == 'humanoid':
    mjm, nconmax = benchmarks.load_humanoid_benchmark(), tio.BENCH_NCONMAX
  else:
    mjm, nconmax = mujoco.MjModel.from_xml_string(_BOX46), None
  return jio.put_model(mjm, nconmax=nconmax), tio.put_model(
      mjm, nconmax=nconmax, device='cpu')


def lane_state(m, W, seed):
  """(qpos, qvel) lanes-last float32 numpy: qpos0 + 0.01 N, 0.2 N."""
  return parity.lane_state(m, W, seed)[:2]


def close(got, want, name, atol=KIN_ATOL, rtol=0.0):
  got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
  np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                             err_msg=name)


@pytest.mark.parametrize('scene', ['humanoid', 'box46'])
def test_k1_stages_match_jax(scene):
  mj, m = models(scene)
  qpos, qvel = lane_state(m, 16, seed=0)
  f32 = jnp.float32
  jx = fused._fk(mj, jnp.asarray(qpos), f32)
  tx = k1_ref.fk(m, torch.as_tensor(qpos))
  for name, a, b in zip(('xpos', 'xquat', 'xanchor', 'xaxis'), tx, jx):
    for i, (x, y) in enumerate(zip(a, b)):
      if y is not None:
        close(x, y, f'{name}[{i}]')
  jc = fused._com_quantities(mj, *jx, f32)
  tc = k1_ref.com_quantities(m, *tx)
  for name, a, b in zip(('subtree_com', 'cinert', 'cdof'), tc, jc):
    close(torch.cat(a), jnp.concatenate(b), name)

  gx_t, gmat_t = k1_ref.geom_frames(m, tx[0], tx[1])
  gp = np.asarray(mj.geom_pos, np.float64)
  gq = np.asarray(mj.geom_quat, np.float64)
  gx_j = [fused._add(jx[0][int(b)], fused._qrot_const(gp[g], jx[1][int(b)]))
          for g, b in enumerate(mj.geom_bodyid)]
  gmat_j = [fused._q2mat(fused._qmul_const(jx[1][int(b)], gq[g]))
            for g, b in enumerate(mj.geom_bodyid)]
  close(torch.cat(gx_t), jnp.concatenate(gx_j), 'geom_xpos')
  close(torch.cat(gmat_t), jnp.concatenate(gmat_j), 'geom_xmat')
  sizes = jnp.asarray(np.asarray(mj.geom_size, np.float32).reshape(-1, 1))
  jn = fused._narrowphase(mj, gx_j, gmat_j, sizes, f32)
  tn = k1_ref.narrowphase(m, gx_t, gmat_t, m.geom_size)
  for name, a, b in zip(('dist', 'pos', 'frame'), tn, jn):
    close(a, b, name)

  for need_L in (False, True):
    qM_j, L_j, cvel_j, cdd_j, bias_j = psmooth.mass_chain_core(
        mj, f32, jc[1], jc[2], [jnp.asarray(qvel[i:i + 1])
                                for i in range(m.nv)],
        mj.dof_armature[:, None], mj.opt.gravity[:, None], need_L=need_L)
    qM_t, L_t, cvel_t, cdd_t, bias_t = k1_ref.mass_chain(
        m, tc[1], tc[2], torch.as_tensor(qvel), m.dof_armature,
        m.opt.gravity, need_L=need_L)
    close(torch.cat(cvel_t), jnp.concatenate(cvel_j), 'cvel')
    close(torch.cat(cdd_t), jnp.concatenate(cdd_j), 'cdof_dot')
    scale = float(jnp.max(jnp.abs(qM_j)))
    close(qM_t, qM_j, 'qM', atol=MASS_RTOL * scale)
    close(bias_t, bias_j, 'bias', atol=MASS_RTOL * float(
        jnp.max(jnp.abs(bias_j))))
    if need_L:
      close(L_t, L_j, 'L', atol=MASS_RTOL * float(jnp.max(jnp.abs(L_j))))
    else:
      assert L_t is None and L_j is None


def test_k1_matches_pallas_interpret():
  """The whole plain K1 (through the wrapper, on CPU tensors) against the
  Pallas K1 under the interpreter, humanoid at W = 128."""
  mj, m = models('humanoid')
  qpos, qvel = lane_state(m, 128, seed=1)
  launches = kk1.launches
  out_t = kk1.k1(m, torch.as_tensor(qpos), torch.as_tensor(qvel),
                 need_qLD=False)
  assert kk1.launches == launches  # CPU tensors take the plain version
  out_j = fused._k1_call(mj, jnp.asarray(qpos), jnp.asarray(qvel),
                         interpret=True, need_qLD=False)
  qM_t, qLD_t, bias_t, cdof_t, dist_t, pos_t, frame_t, stcom_t = out_t
  qM_j, bias_j, cdof_j, dist_j, pos_j, frame_j, stcom_j = out_j
  assert qLD_t is None
  close(qM_t, qM_j, 'qM', atol=MASS_RTOL * float(jnp.max(jnp.abs(qM_j))))
  close(bias_t, bias_j, 'bias',
        atol=MASS_RTOL * float(jnp.max(jnp.abs(bias_j))))
  close(cdof_t, cdof_j, 'cdof')
  close(stcom_t, stcom_j, 'subtree_com')
  for name, a, b in (('dist', dist_t, dist_j), ('pos', pos_t, pos_j),
                     ('frame', frame_t, frame_j)):
    close(a, b, name, rtol=MASS_RTOL)

