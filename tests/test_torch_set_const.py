"""``io.set_const`` of the port (``mujoco_warp_tpu/io.py:1360``).

- Against MuJoCo's ``mj_setConst``, at the JAX test's tolerances
  (``tests/test_set_const.py``: body_subtreemass rtol 1e-5, the
  invweights and actuator_acc0 rtol 2e-4, body_invweight0 also atol 1e-7,
  tendon_length0 atol 1e-5): masses and inertias scaled, qpos0 shifted,
  tendons (``tendon_mix.xml``, the port's tendon zoo; the JAX test's
  ``transmission.xml`` has a slider-crank the port does not run), and the
  connect anchors of the constraints scene, which hold at qpos0 to 1e-5.
  The port's Model is put from the unedited model and given the edited
  fields, so set_const must derive the rest.
- Against the JAX ``set_const`` on the same float32 Model: every output
  to 1e-5 of the field's largest entry, on pendula, the constraints
  scene, sensors2 (a tendon) and dm_control's humanoid.  Not on
  tendon_mix: its tendons' armature is part of M, as in ``mj_setConst``
  (held above), and the JAX set_const leaves it out of M^-1.
- float64 against ``mj_setConst`` to 1e-9 of the field's largest entry
  on those and tendon_mix.  (The JAX set_const in float64 averages the
  dof blocks through a float32 matrix, so it is off by 3e-8.)
- Batched: each world of a batched Model (masses per world, qpos0 per
  world) equals set_const of the unbatched Model with that world's values
  to the bit, the outputs that depend on no batched field stay unbatched,
  and the batched ones join ``batch_fields``.  And ``humanoid_dmc_dr``'s
  draws at 4 worlds against the JAX batch_model, set_const per world and
  batched step (``test_torch_batch_model._against_jax``: set_const's
  outputs to 1e-5 of the field's largest entry, those through M^-1 on
  both sides against the port's float64 set_const; qacc and qpos at
  parity's bars).
"""

import jax
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.models import load_mjm
from mujoco_warp_tpu_torch import benchmarks, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_batch_model import _against_jax, _drawn
from tests.test_torch_classic_step import fast_compile
from tests.torch_threads import few_threads  # noqa: F401

_FIELDS = ('body_subtreemass', 'dof_invweight0', 'body_invweight0',
           'tendon_length0', 'tendon_invweight0', 'tendon_lengthspring',
           'eq_data', 'actuator_acc0', 'actuator_biasprm')


def _load(scene):
  if scene in tio.TENDON_XML:
    return mujoco.MjModel.from_xml_path(tio.TENDON_XML[scene])
  if scene == 'humanoid_dmc':
    pytest.importorskip('dm_control')
    return tio.load_dmc('humanoid_dmc')
  return load_mjm(scene + '.xml')


def _stale(scene, mjm_edit, fields, dtype=torch.float32):
  """The port's Model of the unedited scene with ``fields`` of the
  edited MjModel copied in."""
  m = tio.put_model(_load(scene), device='cpu', dtype=dtype)
  return m.replace(**{k: torch.as_tensor(np.asarray(getattr(mjm_edit, k)),
                                         dtype=dtype) for k in fields})


def _against_mujoco(mjm, m_new, tendons=False):
  mujoco.mj_setConst(mjm, mujoco.MjData(mjm))
  got = lambda k: getattr(m_new, k).numpy()
  np.testing.assert_allclose(got('body_subtreemass'), mjm.body_subtreemass,
                             rtol=1e-5)
  np.testing.assert_allclose(got('dof_invweight0'), mjm.dof_invweight0,
                             rtol=2e-4)
  np.testing.assert_allclose(got('body_invweight0'), mjm.body_invweight0,
                             rtol=2e-4, atol=1e-7)
  if tendons:
    np.testing.assert_allclose(got('tendon_length0'), mjm.tendon_length0,
                               atol=1e-5)
    np.testing.assert_allclose(got('tendon_invweight0'),
                               mjm.tendon_invweight0, rtol=2e-4)
  if mjm.nu:
    np.testing.assert_allclose(got('actuator_acc0'), mjm.actuator_acc0,
                               rtol=2e-4)


@pytest.mark.parametrize('scene,tendons', [('pendula', False),
                                           ('tendon_mix', True)])
def test_mass_scaling_against_mj_setconst(scene, tendons):
  mjm = _load(scene)
  mjm.body_mass[:] *= 1.7
  mjm.body_inertia[:] *= 1.7
  m = _stale(scene, mjm, ('body_mass', 'body_inertia'))
  _against_mujoco(mjm, tio.set_const(m), tendons)


def test_qpos0_shift_against_mj_setconst():
  mjm = _load('pendula')
  mjm.qpos0[:] += 0.05
  m = _stale('pendula', mjm, ('qpos0',))
  _against_mujoco(mjm, tio.set_const(m))


def test_connect_anchor_holds_at_qpos0():
  """The anchors set_const computes satisfy each body connect at qpos0."""
  mjm = _load('constraints')
  conn = np.nonzero((mjm.eq_type == mujoco.mjtEq.mjEQ_CONNECT) &
                    (mjm.eq_objtype == mujoco.mjtObj.mjOBJ_BODY))[0]
  assert len(conn)
  m_new = tio.set_const(tio.put_model(mjm, device='cpu'))
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  for e in conn:
    o1, o2 = int(mjm.eq_obj1id[e]), int(mjm.eq_obj2id[e])
    dat = m_new.eq_data[e].numpy()
    p1 = mjd.xpos[o1] + mjd.xmat[o1].reshape(3, 3) @ dat[0:3]
    p2 = mjd.xpos[o2] + mjd.xmat[o2].reshape(3, 3) @ dat[3:6]
    np.testing.assert_allclose(p1, p2, atol=1e-5)


@pytest.mark.parametrize('scene', ['pendula', 'constraints', 'sensors2',
                                   'humanoid_dmc'])
def test_against_jax_set_const(scene):
  """Every output against the JAX set_const of the same model, masses
  scaled, in float32: within 1e-5 of the field's largest entry."""
  mjm = _load(scene)
  mjm.body_mass[:] *= 1.3
  mjm.body_inertia[:] *= 1.3
  m = tio.set_const(tio.put_model(mjm, device='cpu'))
  mj = jio.put_model(mjm)
  mj = fast_compile(jio.set_const, mj)(mj)
  for k in _FIELDS:
    got = getattr(m, k).numpy().astype(np.float64)
    if not got.size:
      continue
    want = np.asarray(getattr(mj, k), np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=k)


@pytest.mark.parametrize('scene', ['pendula', 'constraints', 'sensors2',
                                   'tendon_mix', 'humanoid_dmc'])
def test_float64_against_mj_setconst(scene):
  """float64: every output within 1e-9 of the field's largest entry of
  mj_setConst's, masses scaled.  Not the body_invweight0 of the
  constraints scene's body 3 (one slide dof), where mj_setConst gives 3x
  trace(J M^-1 J^T) / 3 and the port keeps the JAX package's value
  (ROADMAP queue 3)."""
  mjm = _load(scene)
  mjm.body_mass[:] *= 1.3
  mjm.body_inertia[:] *= 1.3
  m = tio.set_const(tio.put_model(mjm, device='cpu', dtype=torch.float64))
  mujoco.mj_setConst(mjm, mujoco.MjData(mjm))
  for k in _FIELDS:
    got = getattr(m, k).numpy()
    if not got.size:
      continue
    want = np.asarray(getattr(mjm, k)).reshape(got.shape)
    if scene == 'constraints' and k == 'body_invweight0':
      got, want = np.delete(got, 3, 0), np.delete(want, 3, 0)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale,
                               err_msg=k)


def test_batched_worlds_equal_unbatched_set_const():
  """W worlds of per-world masses and qpos0: world w's outputs are those
  of set_const on the unbatched Model with world w's values, to the bit;
  the batched outputs join batch_fields, the others stay unbatched."""
  mjm = _load('constraints')
  m = tio.put_model(mjm, device='cpu')
  W = 3
  rng = np.random.default_rng(0)
  mass = m.body_mass.numpy() * rng.uniform(0.8, 1.2, (W, m.nbody))
  qpos0 = m.qpos0.numpy() + 0.02 * rng.standard_normal((W, m.nq))
  mb = tio.set_const(tio.batch_model(m, W, {'body_mass': mass,
                                            'qpos0': qpos0}))
  for k in ('body_subtreemass', 'dof_invweight0', 'body_invweight0',
            'eq_data', 'actuator_acc0', 'actuator_biasprm'):
    assert k in mb.batch_fields, k
  for k in ('tendon_lengthspring',):
    assert k not in mb.batch_fields
  for w in range(W):
    mw = tio.set_const(m.replace(
        body_mass=torch.as_tensor(mass[w], dtype=torch.float32),
        qpos0=torch.as_tensor(qpos0[w], dtype=torch.float32)))
    for k in _FIELDS:
      got = types.world_field(mb, k)
      got = got[w] if k in mb.batch_fields else got[0]
      assert torch.equal(got, getattr(mw, k)), (k, w)


def test_scene_draws_against_jax_on_humanoid_dmc():
  """``humanoid_dmc_dr``'s draws (``benchmarks.randomize``) at 4 worlds
  through the JAX batch_model, set_const and step from the seeded
  contact state of ``parity.dmc_state``: set_const's outputs and the
  step as ``_against_jax`` holds them."""
  pytest.importorskip('dm_control')
  W = 4
  m0, _ = benchmarks.load_scene('humanoid_dmc', device='cpu')
  mb = benchmarks.randomize(m0, W)
  qpos, qvel, ctrl = parity.dmc_state(m0, 'humanoid_dmc', W, 2)
  d = tio.make_data(mb, W, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  got = forward.step(mb, d)
  assert int(got.ncon_active.sum()) > 0
  _against_jax(tio.load_dmc('humanoid_dmc'), mb, W, _drawn(mb), qpos, qvel,
               ctrl, got)
