"""K4's shared-memory fit on the CPU: ``kernels/k4.py``'s mirror of the
kernel's per-world layout (``world_floats``, held against
``csrc/k4.cu``'s own count by ``tests/test_torch_cuda.py`` on the card),
the fused gate's size reason for a model whose world does not fit in one
block, which ``benchmarks`` then steps on the general path, and the
gated scenes that fit."""

import mujoco
import pytest
import torch

from mujoco_warp_tpu_torch import benchmarks, fused, io, types
from mujoco_warp_tpu_torch.kernels import k4 as kk4
from mujoco_warp_tpu_torch.kernels import solver as ksolver
from mujoco_warp_tpu_torch.ops import forward
from tests.test_fused import _EQJOINT, _IMPLICITFAST
from tests.torch_threads import few_threads  # noqa: F401

# ten free capsules and a four-joint limited arm over a plane, condim 6:
# nv 64 and nbody 12 inside the gate, 77 contact slots of 10 rows each
_OVERSIZED = ''.join(
    ['<mujoco><option timestep="0.004"/><default><geom condim="6"/>'
     '</default><worldbody><geom type="plane" size="3 3 .1"/>'] +
    [f'<body pos="{0.3 * (i % 4)} {0.3 * (i // 4)} 0.3"><freejoint/>'
     '<geom type="capsule" size="0.05" fromto="0 0 0 0.2 0 0"/></body>'
     for i in range(10)] +
    ['<body pos="0 -1 0.3">'] +
    [f'<joint type="{t}" axis="{a}" range="{r}"/>' for t, a, r in (
        ('hinge', '0 1 0', '-1 1'), ('hinge', '1 0 0', '-1 1'),
        ('hinge', '0 0 1', '-1 1'), ('slide', '0 0 1', '-0.1 0.1'))] +
    ['<geom type="capsule" size="0.05" fromto="0 0 0 0.3 0 0"/></body>'
     '</worldbody></mujoco>'])


def test_world_floats_of_the_humanoid_by_hand():
  """The humanoid's 129 rows (21 limits, 108 contact rows) at nv 27 (row
  stride 27) and nq 28, counted float by float."""
  m = io.load_model_npz(device='cpu')
  assert (kk4.nrow(m), m.nv, m.nq) == (129, 27, 28)
  by_hand = (129 * 27 +          # J
             27 * 27 + 27 * 27 +  # M, L
             7 * 129 +           # D, aref, fl, Jaref, J search, mask, force
             6 * 27 + 1 +        # qacc, Ma, grad, search, M search, qfs; niter
             (3 * 129 + 1) // 2 +  # three 16-bit row lists
             28 + 27)            # qpos, qvel (cdof lies in L)
  assert by_hand == 6256
  assert kk4.world_floats(129, 27, 28) == by_hand
  assert kk4.fits(m) and 4 * by_hand <= ksolver.SMEM_BLOCK


def test_world_floats_place_cdof_after_a_small_factor():
  """Below nv 6 the factor's region (nv (nv | 1) floats) cannot hold cdof
  (6 nv), which then follows qvel."""
  for nv in (1, 2, 3, 5):
    assert kk4.world_floats(10, nv, nv + 1) == \
        ksolver.world_floats(10, nv, 0) + (nv + 1) + nv + 6 * nv
  for nv in (6, 27, 64):
    assert kk4.world_floats(10, nv, nv + 1) == \
        ksolver.world_floats(10, nv, 0) + (nv + 1) + nv


def test_gate_refuses_a_world_past_one_block():
  """A model inside every other bound of the gate whose K4 world does not
  fit in one block's shared memory is refused by its size, and
  benchmarks steps it on the general path."""
  m = io.put_model(mujoco.MjModel.from_xml_string(_OVERSIZED), device='cpu')
  assert m.nv <= fused.MAX_NV and m.nbody <= fused.MAX_NBODY
  assert m.ncand <= fused.MAX_NCAND
  nbytes = kk4.world_bytes(m)
  assert nbytes == 4 * kk4.world_floats(kk4.nrow(m), m.nv, m.nq)
  assert nbytes > ksolver.SMEM_BLOCK and not kk4.fits(m)
  why = fused.reason(m)
  assert why.startswith('size (K4 world'), why
  assert str(nbytes) in why and not fused.supported(m)
  assert forward.unsupported(m) is None
  d = next(benchmarks.rollout(m, 2, device='cpu'))
  assert isinstance(d, types.Data) and bool(torch.isfinite(d.qpos).all())


@pytest.mark.parametrize('scene', ['humanoid', 'eq_joint', 'implicitfast'])
def test_gated_scenes_fit(scene):
  """The humanoid and the small gated scenes stay inside the gate, their
  K4 world within one block."""
  if scene == 'humanoid':
    m = io.load_model_npz(device='cpu')
  else:
    xml = _EQJOINT if scene == 'eq_joint' else _IMPLICITFAST
    m = io.put_model(mujoco.MjModel.from_xml_string(xml), device='cpu')
  assert fused.reason(m) is None
  assert kk4.world_bytes(m) <= ksolver.SMEM_BLOCK
