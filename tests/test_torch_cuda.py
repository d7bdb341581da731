"""The port's CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one.  They import no
JAX, so they also run where only PyTorch is installed::

  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are those of ``mujoco_warp_tpu_torch.parity``, which
chip_smoke.py applies too.
"""

import numpy as np
import pytest
import torch

from mujoco_warp_tpu_torch import fused, io, parity
from mujoco_warp_tpu_torch.fused import glue, k1_ref, k4_ref
from mujoco_warp_tpu_torch.kernels import k1 as kk1
from mujoco_warp_tpu_torch.kernels import k4 as kk4
from mujoco_warp_tpu_torch.kernels import lanes


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')


def state(m, W, seed, drop, device):
  return [torch.as_tensor(x, device=device)
          for x in parity.lane_state(m, W, seed, drop)]


@pytest.mark.cuda
@pytest.mark.parametrize('drop', [0.0, 0.28])
def test_k1_cuda_matches_plain(cuda, drop):
  m = io.load_model_npz(device=cuda)
  qpos, qvel, _, _ = state(m, 1000, 2, drop, cuda)  # W not a multiple of 128
  n = kk1.launches
  got = kk1.k1(m, qpos, qvel, need_qLD=True)
  assert kk1.launches == n + 1
  want = k1_ref.k1(m, qpos, qvel, need_qLD=True)
  assert all(a.device.type == 'cuda' for a in got)
  parity.check_k1(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('need_qLD', [True, False])
@pytest.mark.parametrize('scene,state', [
    ('humanoid', 'rest'), ('humanoid', 'contact'), ('eq_joint', 'rest'),
    ('eq_joint', 'contact'), ('implicitfast', 'rest'),
    ('implicitfast', 'contact'), ('implicitfast_no_rows', 'rest'),
    ('hopper', 'contact'), ('humanoid_dmc', 'contact')])
def test_k1_cuda_forms_match_plain(cuda, scene, state, need_qLD):
  """K1 against the plain version at 1000 worlds on the humanoid, the
  small gated scenes and dm_control's hopper and humanoid (48 compacted
  slots), at rest and with a body lowered into the floor,
  with and without the factor, and with collision off (no geom frames or
  narrowphase); where the factor is asked for, it equals the plain
  factor of the kernel's own qM to the last bit (the same pivots and
  differences in the same order)."""
  from mujoco_warp_tpu_torch.fused.solver_ref import chol_tile
  m, qpos, qvel, _, _ = parity.k1_case(scene, state, 1000, 5, cuda)
  n = kk1.launches
  got = kk1.k1(m, qpos, qvel, need_qLD=need_qLD)
  assert kk1.launches == n + 1
  want = k1_ref.k1(m, qpos, qvel, need_qLD=need_qLD)
  parity.check_k1(got, want)
  assert (got[4] is None) == (scene == 'implicitfast_no_rows')
  if need_qLD:
    nv = m.nv
    L = chol_tile(got[0].reshape(nv, nv, -1), nv).reshape(nv * nv, -1)
    assert torch.equal(got[1], L), float((got[1] - L).abs().max())


@pytest.mark.cuda
def test_k1_world_floats_match_c(cuda):
  """kernels/k1.py's layout mirror against csrc/k1.cu's own count, on
  the gated scenes with and without collision and the factor, and at the
  gate's caps; K1's launch shape on the humanoid."""
  from mujoco_warp_tpu_torch.kernels import build
  lib = build.load()
  sizes = [(70, 64, 32, 64, 500, 512), (1, 1, 2, 1, 0, 0),
           (7, 6, 2, 1, 4902, 1)]
  for path in (io.SNAPSHOT, io.EQ_JOINT_SNAPSHOT, io.IMPLICITFAST_SNAPSHOT):
    m = io.load_model_npz(path, device='cpu')
    sizes += [(m.nq, m.nv, m.nbody, m.njnt, m.ngeom, m.ncand),
              (m.nq, m.nv, m.nbody, m.njnt, 0, 0)]
  for size in sizes:
    for factor in (0, 1):
      assert lib.mwt_k1_world_floats(*size, factor) == \
          kk1.world_floats(*size, bool(factor)), (size, factor)
  m = io.load_model_npz(device='cpu')
  info = kk1.kernel_info(m)
  assert info['worlds_per_block'] >= 1 and info['registers'] > 0
  assert info['shared_bytes_per_block'] == \
      info['worlds_per_block'] * kk1.world_bytes(m, need_qLD=False)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['constraints', 'spheres',
                                   'clutter_arm_nosleep'])
def test_mass_chain_cuda_forms_match_plain(cuda, scene):
  """The mass chain at nv 13 and 36 (small tree, its factor in the
  kernel) and 75 (large tree: no factor, qM world-major) against the
  plain version at 1000 worlds of each scene's seeded state, in the same
  layouts; the small tree's factor equals the plain factor of the
  kernel's own qM to the last bit, and qM is symmetric to the last bit.
  (qM and bias are held at ``check_rel``: the plain version sums each
  6-term dot with ``torch.sum``, in another order than the kernel.)"""
  from mujoco_warp_tpu_torch.fused.solver_ref import chol_tile
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.ops import forward
  path, statefn = {
      'constraints': (io.CONSTRAINTS_SNAPSHOT, parity.general_state),
      'spheres': (io.SPHERES_SNAPSHOT, parity.spheres_state),
      'clutter_arm_nosleep': (io.CLUTTER_SNAPSHOT, parity.clutter_state),
  }[scene]
  m = io.load_model_npz(path, device=cuda)
  W, nv, nb = 1000, m.nv, m.nbody
  qpos, qvel, ctrl = [torch.as_tensor(x, device=cuda)
                      for x in statefn(m, W, 3)]
  d = forward.pre(m, io.make_data(m, W, device=cuda).replace(
      qpos=qpos, qvel=qvel, ctrl=ctrl))
  args = (m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  n = kmass.launches
  got = kmass.mass_chain_lanes(*args)
  assert kmass.launches == n + 1
  want = kmass.mass_chain_plain(*args)
  small = not kmass.big_tree(m)
  assert small == (scene != 'clutter_arm_nosleep')
  for a, b in zip(got, want):
    assert (a is None) == (b is None) and (a is None or a.shape == b.shape)
  keep = [i for i in range(5) if want[i] is not None]
  parity.check_rel([got[i] for i in keep], [want[i] for i in keep],
                   [parity.MASS_NAMES[i] for i in keep])
  qM = got[0].reshape(nv, nv, W) if small else got[0].permute(1, 2, 0)
  assert torch.equal(qM, qM.transpose(0, 1))
  if small:
    L = chol_tile(qM, nv).reshape(nv * nv, W)
    assert torch.equal(got[1], L), float((got[1] - L).abs().max())


@pytest.mark.cuda
def test_mass_chain_world_floats_match_c(cuda):
  """kernels/mass_chain.py's layout mirror against csrc/mass_chain.cu's
  own count, on every committed general scene and a few sizes; the
  kernel's launch shape on each general scene."""
  from mujoco_warp_tpu_torch.kernels import build
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  lib = build.load()
  sizes = [(2, 1), (7, 13), (7, 36), (16, 75), (32, 48), (762, 1)]
  for nb, nv in sizes:
    for small in (0, 1):
      assert lib.mwt_mass_chain_world_floats(nb, nv, small) == \
          kmass.world_floats(nb, nv, bool(small)), (nb, nv, small)
  for path in (io.CONSTRAINTS_SNAPSHOT, io.SPHERES_SNAPSHOT,
               io.CLUTTER_SNAPSHOT):
    m = io.load_model_npz(path, device='cpu')
    info = kmass.kernel_info(m)
    assert info['worlds_per_block'] >= 1 and info['registers'] > 0
    assert info['shared_bytes_per_block'] == \
        info['worlds_per_block'] * kmass.world_bytes(m)


@pytest.mark.cuda
@pytest.mark.parametrize('drop', [0.0, 0.28])
def test_k4_cuda_matches_plain(cuda, drop):
  m = io.load_model_npz(device=cuda)
  qpos, qvel, ctrl, ws = state(m, 1000, 5, drop, cuda)
  qM, _, bias, cdof, dist, cpos, cframe, stcom = k1_ref.k1(
      m, qpos, qvel, need_qLD=False)
  con, _ = glue.compact(m, dist, cpos, cframe, stcom)
  qfs = glue.middle(m, bias, qpos, qvel, ctrl)
  args = (m, qM, None, qfs, ws, qvel, qpos, cdof, con)
  n = kk4.launches
  got = kk4.k4(*args)
  assert kk4.launches == n + 1
  want = k4_ref.k4(*args)
  kind = 'rest' if drop == 0.0 else 'contact'
  parity.check_k4(got, want, qvel, float(k4_ref.scalars(m)[3]), kind)


@pytest.mark.cuda
@pytest.mark.parametrize('scene,state', [
    ('eq_joint', 'rest'), ('eq_joint', 'contact'), ('implicitfast', 'rest'),
    ('implicitfast', 'contact'), ('implicitfast_no_rows', 'rest'),
    ('hopper', 'contact'), ('humanoid_dmc', 'contact')])
def test_k4_cuda_forms_match_plain(cuda, scene, state):
  """K4's other forms against the plain version at 1000 worlds: JOINT
  equality rows (eq_joint), the implicitfast integrator (implicitfast),
  each at rest and with a body lowered into the floor, the branch
  without rows (implicitfast with collision off: qacc from K1's qLD), and
  dm_control's hopper (nrow 88, nv 7) and humanoid (nrow 165, its largest
  world) in contact."""
  m, args = parity.k4_case(scene, state, 1000, 5, cuda)
  assert k4_ref.has_rows(m) == (scene != 'implicitfast_no_rows')
  n = kk4.launches
  got = kk4.k4(*args)
  assert kk4.launches == n + 1
  want = k4_ref.k4(*args)
  parity.check_k4(got, want, args[5], float(k4_ref.scalars(m)[3]), state)
  if state == 'contact':
    con = args[8]
    assert int((con['dist'] < con['im']).sum()) > 0


@pytest.mark.cuda
def test_k4_world_floats_match_c(cuda):
  """kernels/k4.py's layout mirror against csrc/k4.cu's own count, on the
  humanoid, the small scenes and at the gate's nv cap."""
  from mujoco_warp_tpu_torch.kernels import build
  lib = build.load()
  sizes = [(0, 8, 9), (64 * 12, 64, 70), (3, 1, 1)]
  for path in (io.SNAPSHOT, io.EQ_JOINT_SNAPSHOT, io.IMPLICITFAST_SNAPSHOT,
               io.DMC_SNAPSHOTS['hopper'], io.DMC_SNAPSHOTS['humanoid_dmc']):
    m = io.load_model_npz(path, device='cpu')
    sizes.append((kk4.nrow(m), m.nv, m.nq))
  for nrow, nv, nq in sizes:
    assert lib.mwt_k4_world_floats(nrow, nv, nq) == \
        kk4.world_floats(nrow, nv, nq), (nrow, nv, nq)
  info = kk4.kernel_info(io.load_model_npz(device='cpu'))
  assert info['worlds_per_block'] >= 1 and info['registers'] > 0
  assert info['shared_bytes_per_block'] == \
      4 * info['worlds_per_block'] * kk4.world_floats(129, 27, 28)


@pytest.mark.cuda
def test_step_lane_cuda_matches_cpu(cuda):
  """Three fused steps through the kernels against the plain path."""
  m = io.load_model_npz(device=cuda)
  d = io.make_data(m, 256, device='cpu')
  rng = np.random.default_rng(9)
  d = d.replace(qpos=d.qpos + torch.as_tensor(
      0.01 * rng.standard_normal(d.qpos.shape), dtype=torch.float32))
  st_h = fused.to_lane(m, d)
  st_c = st_h.map(lambda x: x.to(cuda))
  for _ in range(3):
    st_h = fused.step_lane(m, st_h)
    st_c = fused.step_lane(m, st_c)
  np.testing.assert_allclose(st_c.qpos.cpu().numpy(), st_h.qpos.numpy(),
                             atol=2e-4, rtol=1e-3)
  np.testing.assert_allclose(st_c.qvel.cpu().numpy(), st_h.qvel.numpy(),
                             atol=5e-3, rtol=5e-3)


def general_inputs(cuda, W=1000, seed=3):
  """The constraints scene's position stages on the card for the parity
  state, with a seeded warmstart."""
  from mujoco_warp_tpu_torch.ops import forward
  m = io.load_model_npz(io.CONSTRAINTS_SNAPSHOT, device=cuda)
  qpos, qvel, ctrl = [torch.as_tensor(x, device=cuda)
                      for x in parity.general_state(m, W, seed)]
  ws = torch.as_tensor(0.1 * np.random.default_rng(seed).standard_normal(
      (W, m.nv)), dtype=torch.float32, device=cuda)
  d = io.make_data(m, W, device=cuda).replace(qpos=qpos, qvel=qvel,
                                              ctrl=ctrl, qacc_warmstart=ws)
  return m, forward.pre(m, d)


@pytest.mark.cuda
def test_general_kernels_cuda_match_plain(cuda):
  """The mass chain, the two Cholesky solves and the Newton solve of the
  general step against their plain versions, each fed the plain
  version's upstream outputs."""
  from mujoco_warp_tpu_torch.fused import solver_ref
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.kernels import solver as ksolver
  from mujoco_warp_tpu_torch.ops import forward
  m, d = general_inputs(cuda)
  nv, nb = m.nv, m.nbody
  args = (m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  n = kmass.launches
  got = kmass.mass_chain_lanes(*args)
  assert kmass.launches == n + 1
  want = kmass.mass_chain_plain(*args)
  parity.check_rel(got, want, parity.MASS_NAMES)
  d = forward.mid(m, kmass.mass_chain(m, d))
  L, b = lanes(d.qLD, nv * nv), lanes(d.qfrc_smooth)
  parity.check_world_scale(
      klinalg.chol_solve_batched(m, d.qLD, d.qfrc_smooth).T,
      klinalg.chol_solve_plain(L, b), 'chol_solve', parity.SOLVE_ATOL,
      parity.SOLVE_RTOL)
  d = d.replace(qacc_smooth=klinalg.chol_solve_plain(L, b).T)
  sa = (m, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
        lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
        lanes(d.qacc_warmstart))
  n = ksolver.launches
  got = ksolver.solve_tiles(*sa)
  assert ksolver.launches == n + 1
  want = solver_ref.solve_tiles(*sa)
  parity.check_solve(got, want)
  M = lanes(d.qM, nv * nv)
  dmp = torch.as_tensor(klinalg.damping_terms(m), device=cuda)
  parity.check_world_scale(
      klinalg.damped_solve_batched(m, d.qM, want[0].T).T,
      klinalg.damped_solve_plain(M, want[0], dmp), 'damped_solve',
      parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.cuda
def test_general_step_cuda_matches_cpu(cuda):
  """Three general steps through the kernels against the plain path."""
  from mujoco_warp_tpu_torch.ops import forward
  mh = io.load_model_npz(io.CONSTRAINTS_SNAPSHOT, device='cpu')
  mc = io.load_model_npz(io.CONSTRAINTS_SNAPSHOT, device=cuda)
  qpos, qvel, ctrl = parity.general_state(mh, 256, 5)
  dh = io.make_data(mh, 256, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  dc = io.make_data(mc, 256, device=cuda).replace(
      qpos=dh.qpos.to(cuda), qvel=dh.qvel.to(cuda), ctrl=dh.ctrl.to(cuda))
  for _ in range(3):
    dh, dc = forward.step(mh, dh), forward.step(mc, dc)
  np.testing.assert_allclose(dc.qpos.cpu().numpy(), dh.qpos.numpy(),
                             atol=2e-4, rtol=1e-3)
  np.testing.assert_allclose(dc.qvel.cpu().numpy(), dh.qvel.numpy(),
                             atol=5e-3, rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['humanoid_dmc', 'hopper'])
def test_sensor_step_cuda_matches_cpu(cuda, scene):
  """One general step of dm_control's humanoid (34 sensors, contacts
  compacted) and hopper (lossless slots) in contact through the kernels
  against the plain path: sensordata by ``parity.check_sensors``."""
  from mujoco_warp_tpu_torch.ops import forward
  path = io.DMC_SNAPSHOTS[scene]
  mh = io.load_model_npz(path, device='cpu')
  mc = io.load_model_npz(path, device=cuda)
  qpos, qvel, ctrl = parity.dmc_state(mh, scene, 256, 5)
  dh = io.make_data(mh, 256, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  dc = io.make_data(mc, 256, device=cuda).replace(
      qpos=dh.qpos.to(cuda), qvel=dh.qvel.to(cuda), ctrl=dh.ctrl.to(cuda))
  dh, dc = forward.step(mh, dh), forward.step(mc, dc)
  parity.check_sensors(mh, dc.sensordata.cpu(), dh.sensordata,
                       dc.solver_niter.cpu(), dh.solver_niter)
  assert int(dc.ncon_active.sum()) > 0


def clutter_inputs(cuda, W=1000, seed=3):
  """clutter_arm_nosleep's position stages on the card for the contact-rich
  parity state."""
  from mujoco_warp_tpu_torch.ops import forward
  m = io.load_model_npz(io.CLUTTER_SNAPSHOT, device=cuda)
  qpos, qvel, ctrl = [torch.as_tensor(x, device=cuda)
                      for x in parity.clutter_state(m, W, seed)]
  d = io.make_data(m, W, device=cuda).replace(qpos=qpos, qvel=qvel,
                                              ctrl=ctrl)
  return m, forward.pre(m, d)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [13, 27, 36, 75])
@pytest.mark.parametrize('jitter', [0.0, 1e-12])
def test_chol_batched_cuda_matches_plain(cuda, n, jitter):
  """The chol_batched kernel reads and writes world-major (W, n, n) at
  1000 worlds (not a multiple of the worlds per block) and equals its
  plain version to the last bit on seeded SPD matrices: the same pivots,
  scalings and rank-1 updates in the same order, with --fmad=false."""
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  g = np.random.default_rng(n).standard_normal((1000, n, n))
  A = torch.as_tensor(g @ g.transpose(0, 2, 1) / n + 0.1 * np.eye(n),
                      dtype=torch.float32, device=cuda)
  k = klinalg.launches['chol_batched']
  got = klinalg.chol_batched(None, A, jitter=jitter)
  assert klinalg.launches['chol_batched'] == k + 1
  want = klinalg.chol_batched_plain(A, jitter)
  assert torch.all(torch.triu(got, 1) == 0.0)
  assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('n', [13, 36, 75])
@pytest.mark.parametrize('kind', ['world', 'lanes'])
def test_cholesky_solves_cuda_read_in_place(cuda, n, kind, monkeypatch):
  """chol_solve and damped_solve at 1000 worlds (not a multiple of the
  worlds per block) against their plain versions, each operand world-
  major or a ``world()`` view of lanes-last: the wrapper hands the kernel
  the operand's own storage, so no copy surrounds the launch."""
  import types as pytypes
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import world
  W = 1000
  rng = np.random.default_rng(n)
  g = rng.standard_normal((W, n, n))
  f32 = dict(dtype=torch.float32, device=cuda)
  A = torch.as_tensor(g @ g.transpose(0, 2, 1) / n + 0.1 * np.eye(n), **f32)
  b = torch.as_tensor(rng.standard_normal((W, n)), **f32)
  m = pytypes.SimpleNamespace(
      nv=n, opt=pytypes.SimpleNamespace(timestep=0.002),
      dof_damping=rng.uniform(0.0, 3.0, n).astype(np.float32))
  L = klinalg.chol_batched_plain(A, 1e-12)
  dmp = torch.as_tensor(klinalg.damping_terms(m), device=cuda)
  want_cs = klinalg.chol_solve_plain(lanes(L, n * n), lanes(b))
  want_ds = klinalg.damped_solve_plain(lanes(A, n * n), lanes(b), dmp)

  def put(x):
    if kind == 'world':
      return x.contiguous()
    return world(lanes(x, int(np.prod(x.shape[1:]))), *x.shape[1:])

  Lx, Ax, bx = put(L), put(A), put(b)
  seen = []
  launch = klinalg._launch

  def spy(name, params_cls, **kw):
    seen.append((name, {k: v.value for k, v in kw.items()
                        if k in ('L', 'M', 'a', 'b')}))
    return launch(name, params_cls, **kw)

  monkeypatch.setattr(klinalg, '_launch', spy)
  k = dict(klinalg.launches)
  got_cs = klinalg.chol_solve_batched(m, Lx, bx)
  got_ds = klinalg.damped_solve_batched(m, Ax, bx)
  assert klinalg.launches['chol_solve'] == k['chol_solve'] + 1
  assert klinalg.launches['damped_solve'] == k['damped_solve'] + 1
  assert seen == [('chol_solve', {'L': Lx.data_ptr(), 'b': bx.data_ptr()}),
                  ('damped_solve', {'M': Ax.data_ptr(),
                                    'a': bx.data_ptr()})]
  parity.check_world_scale(got_cs.T, want_cs, f'chol_solve n {n} {kind}',
                           parity.SOLVE_ATOL, parity.SOLVE_RTOL)
  parity.check_world_scale(got_ds.T, want_ds, f'damped_solve n {n} {kind}',
                           parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.cuda
def test_large_tree_kernels_cuda_match_plain(cuda):
  """The large-tree mass chain (no factor, qM world-major), chol_batched
  for qLD, and chol_solve and damped_solve at n 75 against their plain
  versions."""
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  m, d = clutter_inputs(cuda)
  nv, nb = m.nv, m.nbody
  args = (m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  got, want = kmass.mass_chain_lanes(*args), kmass.mass_chain_plain(*args)
  assert got[1] is None and want[1] is None
  keep = (0, 2, 3, 4)
  parity.check_rel([got[i] for i in keep], [want[i] for i in keep],
                   ('qM', 'cvel', 'cdof_dot', 'bias'))
  qM = want[0]
  assert got[0].shape == qM.shape == (1000, nv, nv)
  L = klinalg.chol_batched_plain(qM, kmass.BIG_JITTER)
  parity.check_world_scale(
      lanes(klinalg.chol_batched(m, qM, kmass.BIG_JITTER), nv * nv),
      lanes(L, nv * nv), 'qLD', parity.SOLVE_ATOL, parity.SOLVE_RTOL)
  Ll = lanes(L, nv * nv)
  b = torch.as_tensor(np.random.default_rng(4).standard_normal((nv, 1000)),
                      dtype=torch.float32, device=cuda)
  parity.check_world_scale(klinalg.chol_solve_batched(m, L, b.T).T,
                           klinalg.chol_solve_plain(Ll, b), 'chol_solve',
                           parity.SOLVE_ATOL, parity.SOLVE_RTOL)
  dmp = torch.as_tensor(klinalg.damping_terms(m), device=cuda)
  parity.check_world_scale(
      klinalg.damped_solve_batched(m, qM, b.T).T,
      klinalg.damped_solve_plain(lanes(qM, nv * nv), b, dmp), 'damped_solve',
      parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.cuda
def test_clutter_step_cuda_matches_cpu(cuda):
  """Three clutter_arm_nosleep steps through the four kernels against the
  plain path, each from the plain path's state of the step before."""
  from mujoco_warp_tpu_torch.ops import forward
  mh = io.load_model_npz(io.CLUTTER_SNAPSHOT, device='cpu')
  mc = io.load_model_npz(io.CLUTTER_SNAPSHOT, device=cuda)
  qpos, qvel, ctrl = parity.clutter_state(mh, 64, 5)
  dh = io.make_data(mh, 64, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  for _ in range(3):
    dc = io.make_data(mc, 64, device=cuda).replace(**{
        k: getattr(dh, k).to(cuda) for k in
        ('time', 'qpos', 'qvel', 'ctrl', 'qacc_warmstart')})
    dh, dc = forward.step(mh, dh), forward.step(mc, dc)
    np.testing.assert_allclose(dc.qpos.cpu().numpy(), dh.qpos.numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(dc.qvel.cpu().numpy(), dh.qvel.numpy(),
                               atol=5e-3, rtol=5e-3)
    assert int(dc.overflow.max()) == 0


def spheres_args(cuda, path, W=1000, seed=3, state=parity.spheres_state):
  """The solve's arguments on the card for the seeded spheres state (or
  another seeded ``state`` of ``parity``)."""
  m = io.load_model_npz(path, device=cuda)
  qpos, qvel, ctrl = [torch.as_tensor(x, device=cuda)
                      for x in state(m, W, seed)]
  ws = torch.as_tensor(0.1 * np.random.default_rng(seed).standard_normal(
      (W, m.nv)), dtype=torch.float32, device=cuda)
  d = io.make_data(m, W, device=cuda).replace(qpos=qpos, qvel=qvel,
                                              ctrl=ctrl, qacc_warmstart=ws)
  return parity.solve_args(m, d)[0]


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['spheres', 'spheres_elliptic'])
def test_spheres_solve_cuda_matches_plain(cuda, scene):
  """Kernel 3 in its contact-pyramidal and elliptic forms against the
  plain version on the seeded spheres state (live contacts in all three
  elliptic zones), at the 'elliptic' Newton-count bar."""
  from mujoco_warp_tpu_torch.fused import solver_ref
  from mujoco_warp_tpu_torch.kernels import solver as ksolver
  path = io.SPHERES_SNAPSHOT if scene == 'spheres' else \
      io.SPHERES_ELLIPTIC_SNAPSHOT
  args = spheres_args(cuda, path)
  n = ksolver.launches
  got = ksolver.solve_tiles(*args)
  assert ksolver.launches == n + 1
  want = solver_ref.solve_tiles(*args)
  parity.check_solve(got, want, 'elliptic')
  if scene == 'spheres_elliptic':
    zones = solver_ref.ell_zone_counts(*args[:4], want[0], args[8])
    assert min(zones.values()) > 0, zones


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['constraints', 'spheres',
                                   'spheres_elliptic'])
def test_solve_cuda_stops_on_the_cap(cuda, scene):
  """Kernel 3 in both forms with opt.iterations cut to about the scene's
  mean Newton count, so that many worlds stop on the cap, against its
  plain version at 1000 worlds: Newton counts at the bar, and the worlds that stopped on a tolerance
  on both sides under ``parity.check_solve``.  A capped world's last
  iterate is not a solution: two solvers that sum in different orders
  may take different linesearch steps on the way (the parent commit's
  kernel and the plain version differ there too), so its qacc is not
  held to the solution's bar, only its finite value."""
  from mujoco_warp_tpu_torch.fused import solver_ref
  from mujoco_warp_tpu_torch.kernels import solver as ksolver
  if scene == 'constraints':
    args = spheres_args(cuda, io.CONSTRAINTS_SNAPSHOT,
                        state=parity.general_state)
  else:
    args = spheres_args(cuda, io.SPHERES_SNAPSHOT if scene == 'spheres'
                        else io.SPHERES_ELLIPTIC_SNAPSHOT)
  cap = {'constraints': 3, 'spheres': 4, 'spheres_elliptic': 5}[scene]
  m = args[0].replace(opt=args[0].opt.replace(iterations=cap))
  args = (m,) + tuple(args[1:])
  got = ksolver.solve_tiles(*args)
  want = solver_ref.solve_tiles(*args)
  bar = 'constraints' if scene == 'constraints' else 'elliptic'
  parity.check_niter(got[3], want[3], bar)
  assert int(got[3].max()) == cap
  assert torch.isfinite(got[0]).all()
  free = ((got[3] < cap) & (want[3] < cap)).reshape(-1)
  assert 0 < int(free.sum()) < free.numel(), int(free.sum())
  parity.check_solve([x[:, free] for x in got], [x[:, free] for x in want],
                     bar)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['spheres', 'spheres_elliptic'])
def test_spheres_step_cuda_matches_cpu(cuda, scene):
  """Three spheres steps through the kernels against the plain path, each
  from the plain path's state of the step before."""
  from mujoco_warp_tpu_torch.ops import forward
  path = io.SPHERES_SNAPSHOT if scene == 'spheres' else \
      io.SPHERES_ELLIPTIC_SNAPSHOT
  mh = io.load_model_npz(path, device='cpu')
  mc = io.load_model_npz(path, device=cuda)
  qpos, qvel, ctrl = parity.spheres_state(mh, 64, 5)
  dh = io.make_data(mh, 64, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  for _ in range(3):
    dc = io.make_data(mc, 64, device=cuda).replace(**{
        k: getattr(dh, k).to(cuda) for k in
        ('time', 'qpos', 'qvel', 'ctrl', 'qacc_warmstart')})
    dh, dc = forward.step(mh, dh), forward.step(mc, dc)
    np.testing.assert_allclose(dc.qpos.cpu().numpy(), dh.qpos.numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(dc.qvel.cpu().numpy(), dh.qvel.numpy(),
                               atol=5e-3, rtol=5e-3)
    assert int(dc.overflow.max()) == 0


def tiled_state(m, path, W, device):
  """A committed settled state (``io.load_state``) tiled to W worlds."""
  from mujoco_warp_tpu_torch import benchmarks
  return benchmarks.build(m, W, device=device, init_state=io.load_state(path))


@pytest.mark.cuda
def test_sleep_step_cuda_matches_cpu(cuda):
  """clutter_arm with sleep on, from its settled state with half the
  clutter trees woken (counters near ready, velocities around the
  tolerance): three steps through the kernels against the plain path,
  each from the plain path's state of the step before.  tree_asleep
  equal but in trees at the quiescence threshold (within 1e-4 tol), which
  stay few."""
  from mujoco_warp_tpu_torch import types
  from mujoco_warp_tpu_torch.ops import forward
  mh = io.load_model_npz(io.CLUTTER_ARM_SNAPSHOT, device='cpu')
  mc = io.load_model_npz(io.CLUTTER_ARM_SNAPSHOT, device=cuda)
  dh = tiled_state(mh, io.CLUTTER_ARM_SETTLED, 128, 'cpu')
  st = parity.woken_state(mh, {k: getattr(dh, k).numpy() for k in (
      'tree_asleep', 'qvel')}, np.random.default_rng(4))
  dh = dh.replace(**{k: torch.as_tensor(v) for k, v in st.items()})
  tol = float(types.host(mh.opt.sleep_tolerance))
  length = types.host(mh.dof_length, np.float32)
  keys = ('time', 'qpos', 'qvel', 'ctrl', 'qacc_warmstart', 'tree_asleep',
          'nisland', 'tree_island', 'dof_island', 'efc_island')
  for _ in range(3):
    dc = io.make_data(mc, 128, device=cuda).replace(**{
        k: getattr(dh, k).to(cuda) for k in keys})
    dh, dc = forward.step(mh, dh), forward.step(mc, dc)
    off = (dc.tree_asleep.cpu() != dh.tree_asleep).numpy()
    v = np.abs(length * np.maximum(np.abs(dh.qvel.numpy()),
                                   np.abs(dc.qvel.cpu().numpy())))
    speed = np.stack([v[:, mh.dof_treeid == t].max(axis=1)
                      for t in range(mh.ntree)], axis=1)
    near = np.abs(speed - tol) <= 1e-4 * tol
    assert not (off & ~near).any() and int(near.sum()) <= 16
    np.testing.assert_allclose(dc.qpos.cpu().numpy(), dh.qpos.numpy(),
                               atol=2e-4, rtol=1e-3)
    keep = ~off[:, mh.dof_treeid]
    np.testing.assert_allclose(dc.qvel.cpu().numpy()[keep],
                               dh.qvel.numpy()[keep], atol=5e-3, rtol=5e-3)
    assert int(dc.overflow.max()) == 0


@pytest.mark.cuda
def test_sleep_skip_cuda_matches_full_step(cuda):
  """The settled clutter.xml state at 256 worlds with 20 woken: the step
  that packs the awake worlds (``forward.step``) against the full step
  on the card, 20 steps: tree_asleep equal, qpos within 1e-6."""
  from mujoco_warp_tpu_torch.ops import forward, util
  m, d0 = parity.pushed_clutter(256, 20, cuda)
  da = db = d0
  for _ in range(20):
    da, db = forward.step(m, da), forward._step_batched(m, db)
  idle = ~torch.any(d0.qfrc_applied != 0, dim=1)
  assert bool((da.qacc_smooth[idle] == 0).all())  # the packed branch ran
  assert torch.equal(da.tree_asleep, db.tree_asleep)
  assert float((da.qpos - db.qpos).abs().max()) < 1e-6
  assert float((da.time - db.time).abs().max()) < 1e-5


@pytest.mark.cuda
def test_cg_solve_cuda_matches_cpu(cuda):
  """The CG solve through the chol_solve kernel against the plain path
  on the seeded spheres_cg state (1000 worlds), at the 'cg' bar."""
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.ops import forward
  from mujoco_warp_tpu_torch.ops import solver as osolver
  out = {}
  for dev in ('cpu', cuda):
    m = io.load_model_npz(io.SPHERES_CG_SNAPSHOT, device=dev)
    qpos, qvel, ctrl = [torch.as_tensor(x, device=dev) for x in
                        parity.spheres_state(m, 1000, 5)]
    d = forward.pre(m, io.make_data(m, 1000, device=dev).replace(
        qpos=qpos, qvel=qvel, ctrl=ctrl))
    from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
    d = forward.mid(m, kmass.mass_chain(m, d))
    d = d.replace(qacc_smooth=klinalg.chol_solve_batched(m, d.qLD,
                                                         d.qfrc_smooth))
    if dev == 'cpu':
      dh = d
    n = klinalg.launches['chol_solve']
    trips = osolver.trips
    out[str(dev)] = osolver.solve(m, d if dev == 'cpu' else d.replace(**{
        k: getattr(dh, k).to(cuda) for k in (
            'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qM', 'qLD',
            'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')}))
    if dev != 'cpu':
      assert klinalg.launches['chol_solve'] - n == 1 + osolver.trips - trips
  got, want = out['cuda'], out['cpu']
  t = lambda x: x.T.cpu()
  parity.check_solve([t(got.qacc), t(got.efc_force), t(got.qfrc_constraint),
                      got.solver_niter.cpu()],
                     [t(want.qacc), t(want.efc_force),
                      t(want.qfrc_constraint), want.solver_niter], 'cg',
                     (lanes(dh.efc_J), lanes(dh.efc_D)))


def tendon_inputs(scene, device, W=1000, seed=3):
  """A tendon scene's position stages (its tendons among them) for the
  parity state, with a seeded warmstart."""
  from mujoco_warp_tpu_torch.ops import forward
  m = io.load_model_npz(io.TENDON_SNAPSHOTS[scene], device=device)
  qpos, qvel, ctrl = [torch.as_tensor(x, device=device)
                      for x in parity.general_state(m, W, seed)]
  ws = torch.as_tensor(0.1 * np.random.default_rng(seed).standard_normal(
      (W, m.nv)), dtype=torch.float32, device=device)
  d = io.make_data(m, W, device=device).replace(
      qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=ws)
  return m, forward.pre(m, d)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['ball_in_cup', 'point_mass', 'sensors2',
                                   'tendon_wrap'])
def test_tendon_scene_kernels_cuda_match_plain(cuda, scene):
  """The small-tree kernels at the tendon scenes' sizes (nv 4: ball_in_cup,
  nefc 65; nv 2: point_mass, nefc 26, sensors2 and tendon_wrap, no rows),
  at 1000 worlds: the mass chain with its factor, chol_solve, the Newton
  solve where there are rows and damped_solve where there is damping,
  each against its plain version on the plain version's upstream
  outputs."""
  from mujoco_warp_tpu_torch.fused import k4_ref, solver_ref
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.kernels import solver as ksolver
  from mujoco_warp_tpu_torch.kernels import world
  from mujoco_warp_tpu_torch.ops import forward
  m, d = tendon_inputs(scene, cuda)
  nv, nb = m.nv, m.nbody
  assert kmass.factor_in_kernel(m)
  args = (m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  n = kmass.launches
  got = kmass.mass_chain_lanes(*args)
  assert kmass.launches == n + 1
  want = kmass.mass_chain_plain(*args)
  parity.check_rel(got, want, parity.MASS_NAMES)
  qM, qLD, cvel, cdd, bias = want
  d = forward.mid(m, d.replace(
      qM=world(qM, nv, nv), qLD=world(qLD, nv, nv), cvel=world(cvel, nb, 6),
      cdof_dot=world(cdd, nv, 6), qfrc_bias=bias.T))
  b = lanes(d.qfrc_smooth)
  want_cs = klinalg.chol_solve_plain(qLD, b)
  parity.check_world_scale(
      klinalg.chol_solve_batched(m, d.qLD, d.qfrc_smooth).T, want_cs,
      'chol_solve', parity.SOLVE_ATOL, parity.SOLVE_RTOL)
  qacc = want_cs
  if m.nefc:
    d = d.replace(qacc_smooth=want_cs.T)
    sa = (m, lanes(d.efc_J), lanes(d.efc_D), lanes(d.efc_aref),
          lanes(d.efc_frictionloss), lanes(d.qM), lanes(d.qfrc_smooth),
          lanes(d.qacc_warmstart))
    n = ksolver.launches
    got_s = ksolver.solve_tiles(*sa)
    assert ksolver.launches == n + 1
    want_s = solver_ref.solve_tiles(*sa)
    parity.check_solve(got_s, want_s, 'dmc', sa[1:3])
    qacc = want_s[0]
  if k4_ref.damped(m):
    dmp = torch.as_tensor(klinalg.damping_terms(m), device=cuda)
    parity.check_world_scale(
        klinalg.damped_solve_batched(m, d.qM, qacc.T).T,
        klinalg.damped_solve_plain(qM, qacc, dmp), 'damped_solve',
        parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.cuda
def test_tendon_armature_route_cuda_matches_plain(cuda):
  """tendon_mix (nv 5, tendon armature): the mass chain in its large-tree
  form (no factor, qM world-major) at 1000 worlds, then the armature
  term, then chol_batched, against the plain version of that route; and
  qM and qLD of the card's mass-chain stage against the CPU's."""
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.ops import forward, smooth
  m, d = tendon_inputs('tendon_mix', cuda)
  nv, nb = m.nv, m.nbody
  assert not kmass.big_tree(m) and not kmass.factor_in_kernel(m)
  args = (m, lanes(d.cinert, 36 * nb), lanes(d.cdof, 6 * nv), lanes(d.qvel))
  got, want = kmass.mass_chain_lanes(*args), kmass.mass_chain_plain(*args)
  assert got[1] is None and want[1] is None
  assert got[0].shape == want[0].shape == (1000, nv, nv)
  keep = (0, 2, 3, 4)
  parity.check_rel([got[i] for i in keep], [want[i] for i in keep],
                   ('qM', 'cvel', 'cdof_dot', 'bias'))
  qM = smooth.tendon_armature(m, d.replace(qM=want[0])).qM
  k = klinalg.launches['chol_batched']
  L = klinalg.chol_batched(m, qM.contiguous(), kmass.BIG_JITTER)
  assert klinalg.launches['chol_batched'] == k + 1
  parity.check_world_scale(
      lanes(L, nv * nv),
      lanes(klinalg.chol_batched_plain(qM, kmass.BIG_JITTER), nv * nv),
      'qLD', parity.SOLVE_ATOL, parity.SOLVE_RTOL)
  mh, dh = tendon_inputs('tendon_mix', 'cpu')
  dc, dh = forward.mass_chain(m, d), forward.mass_chain(mh, dh)
  for name in ('qM', 'qLD', 'qfrc_bias'):
    parity.check_world_scale(lanes(getattr(dc, name)).cpu().reshape(-1, 1000),
                             lanes(getattr(dh, name)).reshape(-1, 1000), name,
                             parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 2, 4, 5])
def test_linalg_kernels_cuda_small_n(cuda, n):
  """chol_batched (to the last bit), chol_solve and damped_solve at the
  tendon scenes' sizes, n 1-5, fewer than a warp's lanes, at 1000
  worlds against their plain versions."""
  import types as pytypes
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  rng = np.random.default_rng(n)
  g = rng.standard_normal((1000, n, n))
  f32 = dict(dtype=torch.float32, device=cuda)
  A = torch.as_tensor(g @ g.transpose(0, 2, 1) / n + 0.1 * np.eye(n), **f32)
  b = torch.as_tensor(rng.standard_normal((1000, n)), **f32)
  L = klinalg.chol_batched(None, A, jitter=1e-12)
  assert torch.equal(L, klinalg.chol_batched_plain(A, 1e-12))
  m = pytypes.SimpleNamespace(
      nv=n, opt=pytypes.SimpleNamespace(timestep=0.002),
      dof_damping=rng.uniform(0.0, 3.0, n).astype(np.float32))
  dmp = torch.as_tensor(klinalg.damping_terms(m), device=cuda)
  parity.check_world_scale(
      klinalg.chol_solve_batched(m, L, b).T,
      klinalg.chol_solve_plain(lanes(L, n * n), lanes(b)), 'chol_solve',
      parity.SOLVE_ATOL, parity.SOLVE_RTOL)
  parity.check_world_scale(
      klinalg.damped_solve_batched(m, A, b).T,
      klinalg.damped_solve_plain(lanes(A, n * n), lanes(b), dmp),
      'damped_solve', parity.SOLVE_ATOL, parity.SOLVE_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['ball_in_cup', 'point_mass', 'sensors2',
                                   'tendon_wrap', 'tendon_mix'])
def test_tendon_step_cuda_matches_cpu(cuda, scene):
  """Three general steps of each tendon scene at 256 worlds through the
  kernels against the plain path: sensordata of the first step (the
  only one both sides take from the same state) by
  ``parity.check_sensors``; after the third, ten_length and ten_J within
  1e-4 + 1e-4 and qpos and qvel at the step bars."""
  from mujoco_warp_tpu_torch.ops import forward
  path = io.TENDON_SNAPSHOTS[scene]
  mh = io.load_model_npz(path, device='cpu')
  mc = io.load_model_npz(path, device=cuda)
  qpos, qvel, ctrl = parity.general_state(mh, 256, 5)
  dh = io.make_data(mh, 256, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  dc = io.make_data(mc, 256, device=cuda).replace(
      qpos=dh.qpos.to(cuda), qvel=dh.qvel.to(cuda), ctrl=dh.ctrl.to(cuda))
  dh, dc = forward.step(mh, dh), forward.step(mc, dc)
  # sensordata of the one step that both sides take from the same state
  if mh.nsensor:
    parity.check_sensors(mh, dc.sensordata.cpu(), dh.sensordata,
                         dc.solver_niter.cpu(), dh.solver_niter)
  for _ in range(2):
    dh, dc = forward.step(mh, dh), forward.step(mc, dc)
  for k in ('ten_length', 'ten_J'):
    np.testing.assert_allclose(getattr(dc, k).cpu().numpy(),
                               getattr(dh, k).numpy(), atol=1e-4, rtol=1e-4)
  np.testing.assert_allclose(dc.qpos.cpu().numpy(), dh.qpos.numpy(),
                             atol=2e-4, rtol=1e-3)
  np.testing.assert_allclose(dc.qvel.cpu().numpy(), dh.qvel.numpy(),
                             atol=5e-3, rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['constraints', 'humanoid_CMU'])
def test_factor_and_solve_m_cuda_match_plain(cuda, scene):
  """``ops/smooth.py`` ``factor_m`` and ``solve_m`` on CUDA tensors launch
  ``chol_batched`` and ``chol_solve`` (one launch each) and meet their
  plain versions: the factor to the last bit, the solve within parity's
  bar, at 1000 worlds of the scene's qM after the position stages."""
  from mujoco_warp_tpu_torch import benchmarks
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.ops import forward, smooth
  m, _ = benchmarks.load_scene(scene, device=cuda)
  mh, _ = benchmarks.load_scene(scene, device='cpu')
  qpos, qvel, ctrl = parity.general_state(mh, 1000, 4)
  d = io.make_data(m, 1000, device=cuda).replace(
      qpos=torch.as_tensor(qpos, device=cuda),
      qvel=torch.as_tensor(qvel, device=cuda))
  d = forward.mass_chain(m, forward.pre(m, d))
  qM = d.qM.contiguous()
  n0 = dict(klinalg.launches)
  L = smooth.factor_m(m, d.replace(qM=qM)).qLD
  assert klinalg.launches['chol_batched'] == n0['chol_batched'] + 1
  assert torch.equal(L, klinalg.chol_batched_plain(qM))
  x = torch.as_tensor(ctrl[:, :1] * np.ones((1, m.nv), np.float32),
                      device=cuda)
  y = smooth.solve_m(m, d.replace(qLD=L), x)
  assert klinalg.launches['chol_solve'] == n0['chol_solve'] + 1
  parity.check_world_scale(y.T, klinalg.chol_solve_plain(
      lanes(L, m.nv * m.nv), lanes(x)), 'solve_m', parity.SOLVE_ATOL,
      parity.SOLVE_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['pendulum', 'reacher', 'finger',
                                   'cartpole', 'acrobot', 'humanoid_CMU',
                                   'constraints_implicitfast',
                                   'cheetah_implicit'])
def test_classic_step_cuda_matches_cpu(cuda, scene):
  """One general step of each scene of the cylinder, ellipsoid and
  integrator slice at 256 worlds through the kernels against the plain
  path: qpos and qvel at the step bars, sensordata by
  ``parity.check_sensors`` (with ``parity.step_slack`` where the torch
  Newton runs); the mass chain and chol_solve launch once per forward
  (four under RK4)."""
  from mujoco_warp_tpu_torch import benchmarks
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.ops import forward
  mc, _ = benchmarks.load_scene(scene, device=cuda)
  mh, _ = benchmarks.load_scene(scene, device='cpu')
  if scene in parity.DMC_DROP:
    qpos, qvel, ctrl = parity.dmc_state(mh, scene, 256, 5)
  else:
    qpos, qvel, ctrl = parity.general_state(mh, 256, 5)
  t = torch.as_tensor
  dh = io.make_data(mh, 256, device='cpu').replace(
      qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))
  dc = io.make_data(mc, 256, device=cuda).replace(
      qpos=dh.qpos.to(cuda), qvel=dh.qvel.to(cuda), ctrl=dh.ctrl.to(cuda))
  n_mc, n_cs = kmass.launches, klinalg.launches['chol_solve']
  d0 = dh
  dh, dc = forward.step(mh, dh), forward.step(mc, dc)
  nfwd = 4 if mh.opt.integrator == 1 else 1
  assert kmass.launches - n_mc == nfwd
  assert klinalg.launches['chol_solve'] - n_cs >= nfwd
  if mh.nsensor:
    slack = parity.step_slack(mh, d0) if forward.large_system(mh) else None
    parity.check_sensors(mh, dc.sensordata.cpu(), dh.sensordata,
                         dc.solver_niter.cpu(), dh.solver_niter, slack)
  np.testing.assert_allclose(dc.qpos.cpu().numpy(), dh.qpos.numpy(),
                             atol=2e-4, rtol=1e-3)
  np.testing.assert_allclose(dc.qvel.cpu().numpy(), dh.qvel.numpy(),
                             atol=5e-3, rtol=5e-3)


@pytest.mark.cuda
def test_float64_raises_in_every_kernel_wrapper(cuda):
  """A float64 CUDA tensor raises a TypeError in each wrapper (the kernels
  take float32; the float64 path runs on the CPU): nothing converts it
  or hands it to the plain version, and no kernel launches.  A float64
  Model on the card raises in its first kernel."""
  from mujoco_warp_tpu_torch.kernels import linalg as klinalg
  from mujoco_warp_tpu_torch.kernels import mass_chain as kmass
  from mujoco_warp_tpu_torch.kernels import solver as ksolver
  from mujoco_warp_tpu_torch.ops import forward
  f64 = lambda x: x.double() if isinstance(x, torch.Tensor) and \
      x.is_floating_point() else x
  m, qpos, qvel, _, _ = parity.k1_case('humanoid', 'contact', 64, 1, cuda)
  _, args = parity.k4_case('humanoid', 'contact', 64, 1, cuda)
  args = [({k: f64(v) for k, v in a.items()} if isinstance(a, dict) else
           f64(a)) for a in args]
  mc = io.load_model_npz(io.CONSTRAINTS_SNAPSHOT, device=cuda)
  W, nv = 64, mc.nv
  A = torch.eye(nv, device=cuda, dtype=torch.float64).repeat(W, 1, 1)
  b = torch.ones((W, nv), device=cuda, dtype=torch.float64)
  sm = io.load_model_npz(io.SPHERES_SNAPSHOT, device=cuda)
  sh = io.load_model_npz(io.SPHERES_SNAPSHOT, device='cpu')
  sargs, _ = parity.solve_args(sh, io.make_data(sh, W, device='cpu'))
  sargs = [f64(x.to(cuda)) if isinstance(x, torch.Tensor) else x
           for x in sargs[1:]]
  calls = {
      'k1': lambda: kk1.k1(m, f64(qpos), f64(qvel)),
      'k4': lambda: kk4.k4(*args),
      'mass_chain': lambda: kmass.mass_chain_lanes(
          mc, torch.zeros((36 * mc.nbody, W), device=cuda,
                          dtype=torch.float64),
          torch.zeros((6 * nv, W), device=cuda, dtype=torch.float64),
          torch.zeros((nv, W), device=cuda, dtype=torch.float64)),
      'solve': lambda: ksolver.solve_tiles(sm, *sargs),
      'chol_batched': lambda: klinalg.chol_batched(mc, A),
      'chol_solve': lambda: klinalg.chol_solve_batched(mc, A, b),
      'damped_solve': lambda: klinalg.damped_solve_batched(mc, A, b),
  }
  before = (kk1.launches, kk4.launches, kmass.launches, ksolver.launches,
            dict(klinalg.launches))
  for name, call in calls.items():
    with pytest.raises(TypeError, match='float32'):
      call()
  m64 = io.load_model_npz(io.CONSTRAINTS_SNAPSHOT, device=cuda,
                          dtype=torch.float64)
  with pytest.raises(TypeError, match='float32'):
    forward.step(m64, io.make_data(m64, W, device=cuda))
  assert before == (kk1.launches, kk4.launches, kmass.launches,
                    ksolver.launches, dict(klinalg.launches))
