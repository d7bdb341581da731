"""Actuation on the general step against the JAX package and MuJoCo C.

``ops/actuation.py``'s muscle curves and activation dynamics against the
JAX functions on seeded float32 inputs that reach every branch (within
1e-6 of each value, relative).  Then ``fwd_actuation``, ``_next_act``
and the transmissions on three scenes: ``actuator_mix`` (site
transmissions, INTEGRATOR with actrange, FILTER, FILTEREXACT with
actearly, a joint muscle and a tendon muscle, a joint's actuatorfrcrange),
``dcmotor.xml`` (three DC motors) and ``transmission.xml`` (slider-crank
and adhesion).  From seeded states with activation, one port step
against one JAX step: act_dot, actuator_force, qfrc_actuator,
actuator_length and actuator_moment of the step's forward, and act, qpos
and qvel after it, within 1e-5 + 1e-5 of each value (float32 against
float32).  The same forward fields against ``mujoco.mj_forward`` at
5e-4 (``tests/oracle.py``), as ``tests/test_transmission.py`` holds the
JAX package, but for the site transmission with a reference site, where
the JAX package (and so the port) takes the distance between the sites
for the length and MuJoCo C the reference frame's coordinates:
``test_refsite_follows_jax`` pins both (ROADMAP queue 3).  Last, the
world sort of the rollout carries act with its world."""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu.ops import actuation as jact
from mujoco_warp_tpu.ops import forward as jfwd
from mujoco_warp_tpu_torch import benchmarks, types
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import actuation, forward
from tests.oracle import assert_close
from tests.test_torch_classic_step import fast_compile
from tests.torch_threads import few_threads  # noqa: F401

W = 4
FORWARD_FIELDS = ('act_dot', 'actuator_force', 'qfrc_actuator',
                  'actuator_length', 'actuator_moment')
SCENES = ('actuator_mix', 'dcmotor', 'transmission')
# actuator_mix's site actuator with a reference site
REFSITE = 1


def _muscle_inputs(n=4096, seed=0):
  """Seeded float32 inputs of the muscle functions: lengths and
  velocities across every branch of the curves, prm rows of realistic
  muscles (range, force or scale, lmin, lmax, vmax, fpmax, fvmax), half of
  them with force -1 (scale / acc0), half with tausmooth 0."""
  rng = np.random.default_rng(seed)
  u = lambda lo, hi, *s: rng.uniform(lo, hi, (n,) + s).astype(np.float32)
  prm = np.zeros((n, 10), np.float32)
  prm[:, 0], prm[:, 1] = u(0.6, 0.8), u(1.0, 1.2)
  prm[:, 2] = np.where(u(0, 1) < 0.5, -1.0, u(10, 100))
  prm[:, 3] = u(50, 300)
  prm[:, 4], prm[:, 5] = u(0.3, 0.7), u(1.3, 1.9)
  prm[:, 6], prm[:, 7], prm[:, 8] = u(1.0, 2.0), u(1.1, 1.5), u(1.1, 1.4)
  dyn = np.zeros((n, 10), np.float32)
  dyn[:, 0], dyn[:, 1] = u(0.005, 0.02), u(0.02, 0.06)
  dyn[:, 2] = np.where(u(0, 1) < 0.5, 0.0, u(0.05, 0.5))
  lr = np.stack([u(0.1, 0.3), u(0.4, 0.7)], -1)
  return dict(
      length=u(0.0, 0.9), vel=u(-4.0, 4.0), lengthrange=lr,
      acc0=u(0.5, 50.0), prm=prm, dyn=dyn, L=u(0.2, 2.0),
      x=u(-0.5, 1.5), ctrl=u(-0.5, 1.5), act=u(-0.2, 1.2))


def _muscle_cases():
  """name -> (port function, JAX function, argument names)."""
  return {
      'muscle_gain_length': (
          lambda L, prm: actuation.muscle_gain_length(L, prm[:, 4],
                                                      prm[:, 5]),
          lambda L, prm: jact.muscle_gain_length(L, prm[:, 4], prm[:, 5]),
          ('L', 'prm')),
      '_norm_len': (actuation._norm_len, jact._norm_len,
                    ('length', 'lengthrange', 'prm')),
      '_force_scale': (actuation._force_scale, jact._force_scale,
                       ('prm', 'acc0')),
      'muscle_gain': (actuation.muscle_gain, jact.muscle_gain,
                      ('length', 'vel', 'lengthrange', 'acc0', 'prm')),
      'muscle_bias': (actuation.muscle_bias, jact.muscle_bias,
                      ('length', 'lengthrange', 'acc0', 'prm')),
      '_sigmoid': (actuation._sigmoid, jact._sigmoid, ('x',)),
      'muscle_dynamics': (actuation.muscle_dynamics, jact.muscle_dynamics,
                          ('ctrl', 'act', 'dyn')),
  }


@pytest.mark.parametrize('name', sorted(_muscle_cases()))
def test_muscle_function_matches_jax(name):
  port_fn, jax_fn, names = _muscle_cases()[name]
  x = _muscle_inputs()
  got = port_fn(*[torch.as_tensor(x[k]) for k in names])
  want = jax_fn(*[jnp.asarray(x[k]) for k in names])
  got = got if isinstance(got, tuple) else (got,)
  want = want if isinstance(want, tuple) else (want,)
  for g, w in zip(got, want):
    w = np.asarray(w)
    assert g.dtype == torch.float32 and np.all(np.isfinite(w))
    assert_close(g.numpy(), w, name, 1e-6 * max(1.0, np.abs(w).max()), 1e-6)
  if name == 'muscle_gain':
    # every branch of the length and velocity curves is reached
    L, L0 = _norm_len_np(x)
    V = x['vel'] / (L0 * x['prm'][:, 6])
    y = x['prm'][:, 8] - 1.0
    for sel in (V <= -1, (V > -1) & (V <= 0), (V > 0) & (V <= y), V > y,
                L < x['prm'][:, 4], L > x['prm'][:, 5]):
      assert sel.sum() > 20
  if name == 'muscle_dynamics':
    assert np.any(x['dyn'][:, 2] == 0) and np.any(x['dyn'][:, 2] > 0)


def _norm_len_np(x):
  prm, lr = x['prm'], x['lengthrange']
  L0 = (lr[:, 1] - lr[:, 0]) / (prm[:, 1] - prm[:, 0])
  return prm[:, 0] + (x['length'] - lr[:, 0]) / L0, L0


def _dense_moment(mjm, mjd):
  mom = np.zeros((mjm.nu, mjm.nv))
  mujoco.mju_sparse2dense(mom, mjd.actuator_moment, mjd.moment_rownnz,
                          mjd.moment_rowadr, mjd.moment_colind)
  return mom


def _mujoco_states(mjm, seed, nworld=W, idle=()):
  """``nworld`` MjData after ``mj_forward`` at seeded states: qpos0 +
  0.1 N (quaternions normalized), qvel 0.3 N, act 0.1 N, ctrl across 1.2
  times each range (so that the ctrl clamp acts), 0 for the actuators of
  ``idle``."""
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(nworld):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = mjm.qpos0 + 0.1 * rng.standard_normal(mjm.nq)
    mujoco.mj_normalizeQuat(mjm, mjd.qpos)
    mjd.qvel[:] = 0.3 * rng.standard_normal(mjm.nv)
    mjd.act[:] = 0.1 * rng.standard_normal(mjm.na)
    lo, hi = mjm.actuator_ctrlrange[:, 0], mjm.actuator_ctrlrange[:, 1]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    ctrl = rng.uniform(-1.2, 1.2, mjm.nu)
    mjd.ctrl[:] = np.where(mjm.actuator_ctrllimited, mid + half * ctrl, ctrl)
    mjd.ctrl[list(idle)] = 0.0
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return out


def _load(scene, integrator=None):
  mjm = mujoco.MjModel.from_xml_path(tio.ACT_XML[scene])
  if integrator is not None:
    mjm.opt.integrator = integrator
  return mjm


def _stack(states):
  return {k: np.stack([getattr(s, k) for s in states]).astype(np.float32)
          for k in ('qpos', 'qvel', 'act', 'ctrl')}


def _port_step(mjm, states):
  m = tio.put_model(mjm, device='cpu')
  d = tio.make_data(m, len(states), device='cpu').replace(
      **{k: torch.as_tensor(v) for k, v in _stack(states).items()})
  return forward.step(m, d)


@functools.lru_cache(maxsize=None)
def stepped(scene, integrator=None):
  """(MjModel, MjData states, port step, JAX step) of a scene from its
  seeded states, one step each; ``integrator`` set before put_model."""
  mjm = _load(scene, integrator)
  mj = jio.put_model(mjm)
  states = _mujoco_states(mjm, 1)
  dj = jio.make_data(mj, nworld=W).replace(
      **{k: jnp.asarray(v) for k, v in _stack(states).items()})
  step = fast_compile(lambda x: jfwd.step(mj, x), dj)
  return mjm, states, _port_step(mjm, states), step(dj)


@pytest.mark.parametrize('scene', SCENES)
def test_actuation_matches_jax(scene):
  mjm, _, d, dj = stepped(scene)
  for k in FORWARD_FIELDS + ('act', 'qpos', 'qvel'):
    a, b = getattr(d, k).numpy(), np.asarray(getattr(dj, k))
    assert a.shape == b.shape, k
    assert_close(a, b, k, 1e-5, 1e-5)
  if scene == 'transmission':
    # the adhesion actuator has contacts in every world
    assert bool((d.actuator_moment[:, 2].abs().sum(1) > 0).all())
  if mjm.na:
    assert float(d.act_dot.abs().min(0).values.max()) > 0.0


@pytest.mark.parametrize('scene', SCENES)
def test_actuation_matches_mujoco(scene):
  """The forward's actuator fields against ``mj_forward``; on
  actuator_mix the site actuator with a reference site idles (ctrl 0, so
  that its moment does not reach qfrc_actuator) and its length and
  moment are left out (``test_refsite_follows_jax``)."""
  mjm = _load(scene)
  keep = np.ones(mjm.nu, bool)
  if scene == 'actuator_mix':
    keep[REFSITE] = False
  states = _mujoco_states(mjm, 2, idle=np.nonzero(~keep)[0])
  d = _port_step(mjm, states)
  for k in FORWARD_FIELDS:
    want = np.stack([_dense_moment(mjm, s) if k == 'actuator_moment' else
                     getattr(s, k) for s in states])
    got = getattr(d, k).numpy()
    if k in ('actuator_length', 'actuator_moment'):
      got, want = got[:, keep], want[:, keep]
    if not want.size:  # act_dot without activations
      continue
    scale = max(1.0, np.abs(want).max())
    assert_close(got, want, k, 5e-4 * scale, 5e-4)


def test_refsite_follows_jax():
  """The site transmission with a reference site: the port's length is
  the JAX package's, the sites' distance times gear[0]; MuJoCo C's is
  the site's position in the reference frame, and the two differ."""
  mjm, states, d, dj = stepped('actuator_mix')
  mjd = states[0]
  sid, ref = mjm.actuator_trnid[REFSITE]
  dist = np.linalg.norm(mjd.site_xpos[sid] - mjd.site_xpos[ref])
  got = float(d.actuator_length[0, REFSITE])
  assert got == pytest.approx(float(dj.actuator_length[0, REFSITE]),
                              abs=1e-6)
  assert got == pytest.approx(dist * mjm.actuator_gear[REFSITE, 0],
                              abs=1e-5)
  assert abs(got - mjd.actuator_length[REFSITE]) > 1e-2


@pytest.mark.parametrize('integrator', ['RK4', 'IMPLICITFAST'])
def test_activation_integrators_match_jax(integrator):
  """RK4 (the stage activations and the averaged act_dot) and
  IMPLICITFAST (the actuators' input is act where they have one) on
  actuator_mix, one step against JAX."""
  it = getattr(mujoco.mjtIntegrator, f'mjINT_{integrator}')
  _, _, d, dj = stepped('actuator_mix', it)
  for k in ('act', 'act_dot', 'qpos', 'qvel', 'actuator_force'):
    assert_close(getattr(d, k).numpy(), np.asarray(getattr(dj, k)), k,
                 1e-5, 1e-5)


def test_rollout_sort_carries_act():
  """The rollout's world sort (``types.map_worlds``) moves act with its
  world: sorted and unsorted runs, order undone, agree to the bit."""
  m = tio.load_model_npz(tio.ACT_SNAPSHOTS['actuator_mix'], device='cpu')
  rng = np.random.default_rng(4)
  d = tio.make_data(m, 8, device='cpu').replace(
      act=torch.as_tensor(0.1 * rng.standard_normal((8, m.na)),
                          dtype=torch.float32),
      ctrl=torch.as_tensor(rng.uniform(-1, 1, (8, m.nu)),
                           dtype=torch.float32))
  perm = torch.as_tensor(rng.permutation(8))
  a = forward.step(m, forward.step(m, d))
  b = types.map_worlds(d, lambda x: x[perm], 8)
  assert torch.equal(b.act, d.act[perm])
  b = forward.step(m, forward.step(m, b))
  back = torch.argsort(perm)
  for k in ('act', 'act_dot', 'qpos', 'qvel'):
    assert torch.equal(getattr(b, k)[back], getattr(a, k)), k
  # the rollout itself: benchmarks.run on the general step, act finite
  res = benchmarks.run(m, nworld=8, nstep=3, warmup_steps=1, device='cpu')
  st = res['state']
  assert st.act.shape == (8, m.na) and bool(torch.isfinite(st.act).all())
  assert float(st.act.abs().max()) > 0.0
