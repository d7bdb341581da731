"""The port's rollout harness on CPU at a few worlds: the metric keys of
the JAX harness, launch-free plain path, both OU noise forms."""

import json
import os

import numpy as np
import pytest

from mujoco_warp_tpu_torch import benchmarks, io
from tests.torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_keys():
  with open(os.path.join(_REPO, 'BENCH_r05.json')) as f:
    return set(json.load(f)['parsed'])


@pytest.mark.parametrize('replay', [False, True])
def test_run_reports_the_jax_harness_keys(replay):
  m = io.load_model_npz(device='cpu')
  rp = None
  if replay:
    rng = np.random.default_rng(0)
    rp = dict(ctrl=0.1 * rng.standard_normal((5, m.nu)),
              qpos=m.qpos0.numpy(), qvel=np.zeros(m.nv))
  res = benchmarks.run(m, nworld=8, nstep=3, warmup_steps=2, device='cpu',
                       replay=rp)
  st = res.pop('state')
  assert set(res) == bench_keys() | {'model', 'world_ids'}
  assert res['converged_worlds'] == 8 and res['overflow_worlds'] == 0
  assert res['nworld'] == 8 and res['nstep'] == 3
  assert st.ctrl.abs().max() > 0  # OU noise drove ctrl
  lo = m.actuator_ctrlrange.numpy()[:, 0:1]
  hi = m.actuator_ctrlrange.numpy()[:, 1:2]
  if replay:  # the replay form clamps to the ctrl range
    c = st.ctrl.numpy()
    assert np.all((c >= lo) & (c <= hi))


def test_devprofile_summary_of_a_trace():
  """The device-profile summary on a hand-made trace: a 100 us window
  with two overlapping kernels, one copy and work outside the window."""
  from mujoco_warp_tpu_torch import devprofile
  ev = [
      {'ph': 'X', 'cat': 'user_annotation', 'name': 'rollout', 'ts': 1000,
       'dur': 100},
      {'ph': 'X', 'cat': 'kernel', 'name': 'k4_kernel(K4Params)', 'ts': 1010,
       'dur': 40},
      {'ph': 'X', 'cat': 'kernel', 'name': 'k1_kernel(K1Params)', 'ts': 1040,
       'dur': 20},
      {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD (Pageable)',
       'ts': 1080, 'dur': 10},
      {'ph': 'X', 'cat': 'kernel', 'name': 'elementwise', 'ts': 1095,
       'dur': 10},
      {'ph': 'X', 'cat': 'kernel', 'name': 'elementwise', 'ts': 2000,
       'dur': 10},
      {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::add', 'ts': 1000,
       'dur': 90},
      {'ph': 'X', 'cat': 'user_annotation', 'name': 'stage:solve',
       'ts': 1010, 'dur': 30},
      {'ph': 'X', 'cat': 'user_annotation', 'name': 'stage:solve',
       'ts': 1050, 'dur': 10},
      {'ph': 'X', 'cat': 'user_annotation', 'name': 'stage:pre',
       'ts': 3000, 'dur': 10},
  ]
  s = devprofile.summarize(ev, nsteps=2)
  assert s['window_ms'] == pytest.approx(0.1)
  # busy: [1010, 1060] + [1080, 1090] + [1095, 1100] = 65 us
  assert s['busy_share'] == pytest.approx(0.65)
  assert s['idle_share'] == pytest.approx(0.35)
  assert s['kernels_per_step'] == 1.5
  assert s['h2d_copies_per_step'] == 0.5
  dm = s['device_ms_per_step']
  assert dm['k4'] == pytest.approx(0.02) and dm['k1'] == pytest.approx(0.01)
  assert dm['other'] == pytest.approx(0.0075)
  # the other kernels by name: only 'elementwise' (the copy is no kernel)
  (top,) = s['other_top']
  assert top['name'] == 'elementwise'
  assert top['ms_per_step'] == pytest.approx(0.0025)
  assert top['launches_per_step'] == 0.5
  # host time of the step's stages inside the window
  assert s['stage_host_ms_per_step'] == {'solve': pytest.approx(0.02)}
  with pytest.raises(ValueError):
    devprofile.summarize(ev[:1], nsteps=2)


def test_devprofile_attributes_each_kernel_by_its_name():
  """solve_kernel is a suffix of chol_solve_kernel and damped_solve_kernel:
  each trace event counts for its own kernel only (chol_batched_kernel
  too)."""
  from mujoco_warp_tpu_torch import devprofile
  ev = [{'ph': 'X', 'cat': 'user_annotation', 'name': 'rollout', 'ts': 0,
         'dur': 100}]
  for i, name in enumerate(('solve_kernel(SolveParams)',
                            'chol_solve_kernel(CholSolveParams)',
                            'damped_solve_kernel(DampedSolveParams)',
                            'mass_chain_kernel(MassChainParams)',
                            'chol_batched_kernel(CholBatchedParams)')):
    ev.append({'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': 10 * i,
               'dur': i + 1})
  dm = devprofile.summarize(ev, nsteps=1)['device_ms_per_step']
  assert dm['solve'] == pytest.approx(0.001)
  assert dm['chol_solve'] == pytest.approx(0.002)
  assert dm['damped_solve'] == pytest.approx(0.003)
  assert dm['mass_chain'] == pytest.approx(0.004)
  assert dm['chol_batched'] == pytest.approx(0.005)
  assert dm['other'] == 0.0


def test_run_takes_the_general_step_outside_the_fused_gate():
  """The constraints scene fails the fused gate: run steps it with the
  general step (world-major state) and reports the same keys."""
  from mujoco_warp_tpu_torch import fused, types
  m = io.load_model_npz(io.CONSTRAINTS_SNAPSHOT, device='cpu')
  assert not fused.supported(m)
  res = benchmarks.run(m, nworld=8, nstep=3, warmup_steps=2, device='cpu')
  st = res.pop('state')
  assert isinstance(st, types.Data) and st.qpos.shape == (8, m.nq)
  assert set(res) == bench_keys() | {'model', 'world_ids'}
  assert res['converged_worlds'] == 8 and res['overflow_worlds'] == 0
  assert st.ctrl.abs().max() > 0


def test_run_takes_the_clutter_snapshot():
  """clutter_arm_nosleep (large tree, 183 contact slots, nefc 732) runs the
  general step with collision and the torch Newton through the same
  harness: the free OU form drives the arm's motors, worlds are sorted
  every 4 steps, and the metric keys are the JAX harness's."""
  from mujoco_warp_tpu_torch import fused, types
  from mujoco_warp_tpu_torch.ops import solver as osolver
  m = io.load_model_npz(io.CLUTTER_SNAPSHOT, device='cpu')
  assert not fused.supported(m)
  trips = osolver.trips
  res = benchmarks.run(m, nworld=4, nstep=2, warmup_steps=1, device='cpu')
  st = res.pop('state')
  assert isinstance(st, types.Data) and st.qpos.shape == (4, m.nq)
  assert st.contact.dist.shape == (4, m.ncon)
  assert st.ncon_active.shape == (4,)
  assert osolver.trips - trips >= 3  # one solve per step at least
  assert set(res) == bench_keys() | {'model', 'world_ids'}
  assert res['converged_worlds'] == 4 and res['overflow_worlds'] == 0
  assert st.ctrl.abs().max() > 0
