"""Port io on the general step's slice: the constraints scene's Model
against the JAX put_model, its committed snapshot, the slice's gate, the
CUDA device default and import hygiene."""

import os
import subprocess
import sys

import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu_torch import benchmarks
from mujoco_warp_tpu_torch import io as tio
from mujoco_warp_tpu_torch.ops import forward
from tests.test_torch_io import assert_models_equal, jax_model_numpy
from tests.torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODELS = os.path.join(_REPO, 'mujoco_warp_tpu', 'models')


def constraints_mjm():
  return mujoco.MjModel.from_xml_path(tio.CONSTRAINTS_XML)


def test_put_model_matches_jax_on_constraints():
  """Every field of the port's Model equals the JAX Model's: float32
  arrays bit for bit, index tables, layout tables and sizes."""
  mjm = constraints_mjm()
  mj = jio.put_model(mjm)
  m = tio.put_model(mjm, device='cpu')
  ref = jax_model_numpy(mj)
  for k, v in tio.model_to_numpy(m).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, np.asarray(ref[k], v.dtype),
                                    err_msg=k)
    elif k != 'tree.body_levels':
      assert v == ref[k], k
  assert (m.nq, m.nv, m.nbody, m.nu, m.ne, m.nf, m.nl, m.nefc, m.ncand) == \
      (15, 13, 7, 3, 10, 2, 2, 14, 0)
  assert forward.unsupported(m) is None


def test_constraints_snapshot_matches_fresh_put_model(tmp_path):
  """The committed snapshot is what ``--snapshot`` writes today."""
  path = str(tmp_path / 'constraints.npz')
  fresh = tio.make_constraints_snapshot(path)
  assert_models_equal(tio.load_model_npz(tio.CONSTRAINTS_SNAPSHOT,
                                         device='cpu'), fresh)
  assert_models_equal(tio.load_model_npz(path, device='cpu'), fresh)


def test_gate_raises_outside_the_slice():
  """spheres.xml is outside the fused gate; the general step runs its
  contacts in lossless slots and compacted into a smaller budget, with
  the CG solver, and, since the torch solver has elliptic cones, CG's
  elliptic cones and a system beyond the solve kernel's size
  (clutter_arm's, for the torch Newton); PGS still raises."""
  mjm = mujoco.MjModel.from_xml_path(os.path.join(_MODELS, 'spheres.xml'))
  m = tio.put_model(mjm, nconmax=4, device='cpu')
  assert m.con_compact and forward.unsupported(m) is None
  mjm.opt.solver = 1  # CG: ported, through the torch solver
  assert forward.unsupported(tio.put_model(mjm, device='cpu')) is None
  mjm.opt.cone = 1  # elliptic cones in the torch CG
  assert forward.unsupported(tio.put_model(mjm, device='cpu')) is None
  mjm.opt.solver = 0
  with pytest.raises(NotImplementedError, match='PGS'):
    tio.put_model(mjm, device='cpu')
  mjm = tio.load_clutter()
  mjm.opt.cone = 1  # elliptic cones in the torch Newton
  m = tio.put_model(mjm, device='cpu')
  assert forward.large_system(m) and forward.unsupported(m) is None


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
  """With no CUDA device the entry points raise; they never fall back to
  the CPU unless the caller passes device='cpu'."""
  m = tio.load_model_npz(tio.CONSTRAINTS_SNAPSHOT, device='cpu')
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    tio.make_data(m, 128)
  with pytest.raises(RuntimeError, match='CUDA'):
    tio.load_model_npz(tio.CONSTRAINTS_SNAPSHOT)
  with pytest.raises(RuntimeError, match='CUDA'):
    tio.put_model(constraints_mjm())
  with pytest.raises(RuntimeError, match='CUDA'):
    benchmarks.build(m, 8)
  with pytest.raises(RuntimeError, match='CUDA'):
    benchmarks.run(m, nworld=8, nstep=1)
  d = tio.make_data(m, 128, device='cpu')
  assert d.qpos.device.type == 'cpu' and d.qpos.shape == (128, m.nq)
  assert d.eq_active.dtype == torch.bool and bool(d.eq_active.all())


def test_general_step_imports_no_jax():
  """The general step's modules import torch and never jax (a fresh
  process, since this one has jax loaded)."""
  code = ('import sys, mujoco_warp_tpu_torch.ops.forward, '
          'mujoco_warp_tpu_torch.kernels.solver, '
          'mujoco_warp_tpu_torch.kernels.linalg, '
          'mujoco_warp_tpu_torch.kernels.mass_chain, '
          'mujoco_warp_tpu_torch.devprofile; '
          'bad = [k for k in sys.modules if k == "jax" or '
          'k.startswith(("jax.", "mujoco_warp_tpu.")) or '
          'k == "mujoco_warp_tpu"]; '
          'print(bad); sys.exit(1 if bad else 0)')
  res = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
  assert res.returncode == 0, res.stdout + res.stderr
