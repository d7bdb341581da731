"""Plain K4 of the port (fused/k4_ref.py, fused/solver_ref.py) against
the JAX K4.

Inputs are the humanoid's K1 and glue outputs for two seeded states:
'rest' (qpos0 + 0.01 N, qvel 0.2 N: free fall, no contact) and 'contact'
(the same with the root lowered 0.28 m into the floor: 8-9 active
contacts per world).  ``solver_ref.solve_core`` is held against
``psolver.solve_core`` (jnp, no Pallas) on the same rows, and the whole
plain K4 against ``fused._k4_call(..., interpret=True)`` at W = 128, also
on the small gated scenes of ``parity.k4_case`` (joint equality rows,
implicitfast, no rows).

Tolerances are those of ``mujoco_warp_tpu_torch.parity``: qacc atol 1e-4
plus rtol 1e-3 of the world's largest |qacc| (the Newton stop is a norm
test, so agreement is relative to the world's scale; float32 sums run in
different orders on the two sides).  niter must be equal in at least 99%
of worlds at rest.  In contact the bracketed linesearch accepts or
rejects the exact minimizer on the SIGN of a slope that is zero up to
rounding (seen: +1.3e-9 against -1.7e-9 on terms of 1e7), so a world may
take one Newton iteration more on one side (2 of 128 worlds even in
float64), and from there a different path.  There the bar is 85% of
worlds equal and no world more than two iterations apart, and qacc still
meets its tolerance.
"""

import jax.numpy as jnp
import mujoco
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.pallas import fused
from mujoco_warp_tpu.pallas import solver as psolver
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch import parity
from mujoco_warp_tpu_torch.fused import glue, k1_ref, k4_ref, solver_ref
from mujoco_warp_tpu_torch.kernels import k4 as kk4
from tests.test_torch_k1 import models
from tests.torch_threads import few_threads  # noqa: F401


def k4_inputs(m, W, seed, state='contact'):
  """Port K1 + glue outputs as float32 numpy, in _k4_call's order."""
  qpos, qvel, ctrl, ws = parity.lane_state(m, W, seed, parity.DROP[state])
  t = torch.as_tensor
  qM, _, bias, cdof, dist, cpos, cframe, stcom = k1_ref.k1(
      m, t(qpos), t(qvel), need_qLD=False)
  con, _ = glue.compact(m, dist, cpos, cframe, stcom)
  qfs = glue.middle(m, bias, t(qpos), t(qvel), t(ctrl))
  n = lambda x: x.numpy()
  return dict(qM=n(qM), qfs=n(qfs), ws=ws, qvel=qvel, qpos=qpos,
              cdof=n(cdof), con={k: n(v) for k, v in con.items()})


@pytest.mark.parametrize('state', ['rest', 'contact'])
def test_solve_core_matches_jax(state):
  mj, m = models('humanoid')
  x = k4_inputs(m, 64, seed=3, state=state)
  t = lambda k: torch.as_tensor(x[k])
  con = {k: torch.as_tensor(v) for k, v in x['con'].items()}
  J, D, aref, diag, w_eq = k4_ref.rows(m, t('qpos'), t('qvel'), t('cdof'),
                                       con)
  assert w_eq is None and len(diag) == 21 and J.shape[0] == 108
  act = int((con['dist'] < con['im']).sum())
  assert (act > 64) == (state == 'contact')
  tol, lstol, mi, _, _ = k4_ref.scalars(m)
  W = x['qpos'].shape[-1]
  M = t('qM').reshape(m.nv, m.nv, W)
  qacc_t, _, niter_t = solver_ref.solve_core(
      m, J, D, aref, M, t('qfs'), t('ws'), None, tol, lstol, mi, diag=diag)
  j = lambda v: jnp.asarray(v.numpy())
  qacc_j, _, niter_j = psolver.solve_core(
      mj, jnp.float32, j(J), j(D), j(aref), jnp.zeros_like(j(D)), j(M),
      j(t('qfs')), j(t('ws')), None, None, jnp.float32(tol.item()),
      jnp.float32(lstol.item()), jnp.float32(mi.item()),
      lambda v, r: v, diag=[(dof, j(s)) for dof, s in diag])
  parity.check_world_scale(qacc_t, qacc_j, 'qacc')
  parity.check_niter(niter_t, niter_j, state)
  assert float(niter_t.mean()) >= 1.0, 'the solve should iterate'


def test_k4_matches_pallas_interpret():
  mj, m = models('humanoid')
  x = k4_inputs(m, 128, seed=4, state='contact')
  t = torch.as_tensor
  launches = kk4.launches
  got = kk4.k4(m, t(x['qM']), None, t(x['qfs']), t(x['ws']), t(x['qvel']),
               t(x['qpos']), t(x['cdof']),
               {k: t(v) for k, v in x['con'].items()})
  assert kk4.launches == launches  # CPU tensors take the plain version
  j = jnp.asarray
  con_j = {k: j(v) for k, v in x['con'].items()}
  sc = tuple(jnp.asarray(v.numpy()).reshape(1, 1) for v in k4_ref.scalars(m))
  want = fused._k4_call(mj, True, j(x['qM']), None, j(x['qfs']), j(x['ws']),
                        j(x['qvel']), j(x['qpos']), j(x['cdof']), con_j, sc,
                        interpret=True)
  h = float(k4_ref.scalars(m)[3])
  parity.check_k4(got, want, x['qvel'], h, 'contact')


@pytest.mark.parametrize('scene,state', [
    ('eq_joint', 'contact'), ('implicitfast', 'contact'),
    ('implicitfast_no_rows', 'rest')])
def test_k4_forms_match_pallas_interpret(scene, state):
  """K4's other forms, plain, against the JAX K4 at W = 128: JOINT
  equality rows and contacts (eq_joint, its box lowered into the floor),
  the implicitfast factor with contacts (implicitfast, its sphere
  lowered), and no rows (implicitfast with collision off: qacc from K1's
  qLD), on the port's inputs of ``parity.k4_case``."""
  m, args = parity.k4_case(scene, state, 128, 6, 'cpu')
  xml = tio.EQ_JOINT_XML if scene == 'eq_joint' else tio.IMPLICITFAST_XML
  mj = jio.put_model(mujoco.MjModel.from_xml_path(xml))
  if scene.endswith('_no_rows'):
    mj = mj.replace(opt=mj.opt.replace(run_collision_detection=False))
  got = kk4.k4(*args)
  _, qM, qLD, qfs, ws, qvel, qpos, cdof, con = args
  j = lambda x: None if x is None else jnp.asarray(x.numpy())
  con_j = None if con is None else {k: j(v) for k, v in con.items()}
  sc = tuple(jnp.asarray(v.numpy()).reshape(1, 1) for v in k4_ref.scalars(m))
  want = fused._k4_call(mj, k4_ref.damped(m), j(qM), j(qLD), j(qfs), j(ws),
                        j(qvel), j(qpos), j(cdof), con_j, sc, interpret=True)
  parity.check_k4(got, want, qvel, float(k4_ref.scalars(m)[3]), state)
  if con is not None:
    assert int((con['dist'] < con['im']).sum()) > 0
