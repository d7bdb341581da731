"""The general step on dm_control's pendulum, reacher and finger (Euler;
plane-cylinder and the cylinder MPR groups where collision is on; on
finger, poses where its tip meets the spinner, so that elliptic contact
rows go through the solve kernel's elliptic form) against the JAX ``forward.step``
(batched, jitted, its jnp path on the CPU), from the same seeded state at
16 worlds.

One step stage by stage: the constraint rows (efc_J, efc_pos, efc_D,
efc_active), actuator forces and qfrc_passive elementwise within atol
1e-5 + rtol 1e-4 of JAX; efc_aref, qM and qfrc_bias within 1e-5 + 1e-4 of
the world's largest entry (``check_stage`` says why for efc_aref).  Then three steps, each from the state of the step
before: qpos atol 2e-4 rtol 1e-3, qvel atol 5e-3 rtol 5e-3, sensordata
by ``parity.check_sensors``.  The helpers here serve the other scenes of
the slice (``test_torch_rk4.py``, ``test_torch_cmu_step.py``,
``test_torch_implicit.py``)."""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import benchmarks, parity, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import collision_driver, forward
from tests.oracle import assert_close
from tests.test_torch_io import assert_models_equal
from tests.torch_threads import few_threads  # noqa: F401

W = 16
ATOL, RTOL = 1e-5, 1e-4
FIELDS = ('efc_J', 'efc_pos', 'efc_D', 'actuator_force', 'qfrc_actuator',
          'qfrc_passive')
# the integrator scenes: (XML loader, integrator set before put_model)
_IT = mujoco.mjtIntegrator
INTEGRATOR_SCENES = {
    'constraints_implicitfast': (
        lambda: mujoco.MjModel.from_xml_path(tio.CONSTRAINTS_XML),
        _IT.mjINT_IMPLICITFAST),
    'cheetah_implicit': (lambda: tio.load_dmc('cheetah'),
                         _IT.mjINT_IMPLICIT)}


def fast_compile(fn, x):
  """``fn`` jitted for ``x`` with XLA's backend optimisations off: the
  compiles are most of the time, and the runs few."""
  return jax.jit(fn).lower(x).compile({'xla_backend_optimization_level': 0})


def load(scene):
  """The scene's MjModel as its benchmark scene defines it."""
  pytest.importorskip('dm_control')
  if scene in INTEGRATOR_SCENES:
    make, integ = INTEGRATOR_SCENES[scene]
    mjm = make()
    mjm.opt.integrator = integ
    return mjm
  return tio.load_dmc(scene)


@functools.lru_cache(maxsize=None)
def case(scene, nworld=W):
  """(MjModel, JAX Model, port Model, jitted JAX step) of a scene; the
  port Model is the scene of ``benchmarks.load_scene`` (its snapshot with
  its overrides), which must equal ``put_model`` of the MjModel."""
  mjm = load(scene)
  mj = jio.put_model(mjm)
  m, w = benchmarks.load_scene(scene, device='cpu')
  assert w == 8192
  assert_models_equal(m, tio.put_model(mjm, device='cpu'))
  dj = jio.make_data(mj, nworld=nworld)
  return mjm, mj, m, fast_compile(lambda x: jfwd.step(mj, x), dj)


def touching(m, seed, nworld):
  """World-major (qpos, qvel, ctrl) of W worlds in contact: of 2048 poses
  qpos0 + N (finger's tip meets its spinner in ~5% of them), the first W
  with a live contact slot, then qvel 0.2 N and ctrl 0.3 N."""
  rng = np.random.default_rng(seed)
  qpos = (types.host(m.qpos0, np.float32)[None] +
          rng.standard_normal((2048, m.nq))).astype(np.float32)
  d = tio.make_data(m, 2048, device='cpu').replace(qpos=torch.as_tensor(qpos))
  dist, _, _ = collision_driver._narrowphase_candidates(m, forward.pre(m, d))
  live = (dist < m.cand_includemargin).any(1).numpy()
  assert live.sum() >= nworld, live.sum()
  qvel = (0.2 * rng.standard_normal((nworld, m.nv))).astype(np.float32)
  ctrl = (0.3 * rng.standard_normal((nworld, m.nu))).astype(np.float32)
  return qpos[live][:nworld], qvel, ctrl


def start(scene, seed=3, nworld=W):
  """The seeded state on both sides, (JAX Data, port Data):
  ``parity.dmc_state`` where the scene has a drop, ``touching`` on
  finger, else ``parity.general_state``."""
  _, mj, m, _ = case(scene, nworld)
  if scene in parity.DMC_DROP:
    qpos, qvel, ctrl = parity.dmc_state(m, scene, nworld, seed)
  elif scene == 'finger':
    qpos, qvel, ctrl = touching(m, seed, nworld)
  else:
    qpos, qvel, ctrl = parity.general_state(m, nworld, seed)
  dj = jio.make_data(mj, nworld=nworld).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
  t = torch.as_tensor
  d = tio.make_data(m, nworld, device='cpu').replace(
      qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))
  return dj, d


def world_scale(got, want, name, atol=ATOL, rtol=RTOL):
  """Within atol + rtol of each world's largest |JAX| entry."""
  want = np.asarray(want, np.float64)
  scale = np.abs(want).reshape(want.shape[0], -1).max(1)
  err = np.abs(got - want).reshape(want.shape[0], -1).max(1)
  assert np.all(err <= atol + rtol * scale), (name, err.max())


def check_stage(m, d, dj):
  """The fields of one step's forward against JAX's."""
  for k in FIELDS:
    if getattr(d, k) is None or getattr(d, k).numel() == 0:
      continue
    assert_close(getattr(d, k).numpy(), np.asarray(getattr(dj, k)), k,
                 ATOL, RTOL)
  if m.nefc:
    np.testing.assert_array_equal(d.efc_active.numpy(),
                                  np.asarray(dj.efc_active))
    # a contact row's stiffness 1 / (dmax timeconst dampratio)^2, ~2.8e3
    # at the default solref, turns a one-ulp difference of its distance
    # (~1e-7) into ~3e-4 of aref: held at the world's scale
    world_scale(d.efc_aref.numpy(), dj.efc_aref, 'efc_aref')
  world_scale(d.qM.numpy(), dj.qM, 'qM')
  world_scale(d.qfrc_bias.numpy(), dj.qfrc_bias, 'qfrc_bias')


def check_state(m, d, dj):
  """qpos, qvel and sensordata after a step."""
  if m.nsensor:
    parity.check_sensors(m, d.sensordata, np.asarray(dj.sensordata),
                         d.solver_niter, np.asarray(dj.solver_niter))
  assert_close(d.qpos.numpy(), np.asarray(dj.qpos), 'qpos', atol=2e-4,
               rtol=1e-3)
  assert_close(d.qvel.numpy(), np.asarray(dj.qvel), 'qvel', atol=5e-3,
               rtol=5e-3)


def one_step(scene, nworld=W):
  dj, d = start(scene, nworld=nworld)
  _, _, m, step = case(scene, nworld)
  d1, dj1 = forward.step(m, d), step(dj)
  check_stage(m, d1, dj1)
  check_state(m, d1, dj1)
  return m, d1


def three_steps(scene, nworld=W):
  dj, d = start(scene, seed=5, nworld=nworld)
  _, _, m, step = case(scene, nworld)
  for _ in range(3):
    dj, d = step(dj), forward.step(m, d)
    check_state(m, d, dj)
  assert int(d.overflow.max()) == 0
  return m, d


SCENES = ('pendulum', 'reacher', 'finger')


@pytest.mark.parametrize('scene', SCENES)
def test_one_step_stage_by_stage(scene):
  m, d = one_step(scene)
  assert m.opt.integrator == types.IntegratorType.EULER
  if scene == 'finger':
    # elliptic contact rows live in every world, through the solve
    # kernel's elliptic form
    assert m.opt.cone == types.ConeType.ELLIPTIC
    assert forward.solve_kernel_runs(m)
    assert bool((d.ncon_active > 0).all())


@pytest.mark.parametrize('scene', SCENES)
def test_three_steps_match_jax(scene):
  three_steps(scene)
